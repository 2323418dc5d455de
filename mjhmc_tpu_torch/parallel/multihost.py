"""Multi-process initialisation (counterpart of
``mjhmc_tpu.parallel.multihost``).

Every process of a run drives one device and runs the same program;
``initialize()`` joins them into one ``torch.distributed`` process group,
after which ``parallel.mesh.make_chain_mesh`` lays the chain mesh over
the group's ranks. ``nccl`` is the backend on the card and ``gloo`` on
the CPU. A rank's device is ``cuda:{LOCAL_RANK % device_count}``, made
current before the group is initialised.

With no arguments the group comes from the environment that ``torchrun``
sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). Nothing
else tells a program of a cluster, so an explicit spec is a
``host:port`` address of rank 0, the number of processes and this
process's rank; unlike JAX, one process may ask for a group of its own
(``num_processes=1``), since the port's mesh is built over a group.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from mjhmc_tpu_torch.samplers.state import checked_device


def rank_device(device="cuda") -> torch.device:
    """This process's device: ``cuda:{LOCAL_RANK % device_count}`` for
    ``"cuda"`` (no card raises), else ``device`` itself."""
    device = checked_device(device, "rank_device")
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def free_port() -> int:
    """A TCP port of localhost that is free now (for a group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bound(backend: str, dev: torch.device) -> dict:
    """An NCCL group is bound to the rank's card (``device_id``)."""
    return {"device_id": dev} if backend == "nccl" else {}


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> dict:
    """Join the process group; returns topology info.

    With no cluster arguments, relies on ``torchrun``'s environment.
    Failures under explicit arguments RAISE (a real init failure must not
    be mistaken for single-process mode); only the argument-free
    environment path degrades gracefully, and then the swallowed error is
    surfaced in ``info["error"]``. ``backend`` defaults to ``nccl`` on the
    card and ``gloo`` on the CPU (gloo also takes CUDA tensors, for
    several processes that share one card).
    """
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    info = {"initialized": False, "device": str(dev), "backend": backend}
    try:
        if dist.is_initialized():
            info["initialized"] = True
        elif num_processes is not None:
            # explicit cluster spec: a failure here is a real failure
            if coordinator_address is None or process_id is None:
                raise ValueError("an explicit cluster spec needs coordinator_address "
                                 "('host:port' of rank 0) and process_id")
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=process_id,
                                    **_bound(backend, dev))
            info["initialized"] = True
        elif coordinator_address is None:
            # environment path; single-process without torchrun, with the evidence kept
            try:
                dist.init_process_group(backend, init_method="env://", **_bound(backend, dev))
                info["initialized"] = True
            except ValueError as e:  # a variable torchrun sets is missing
                info["error"] = f"{type(e).__name__}: {e}"
    finally:
        up = dist.is_initialized()
        info.update(
            process_index=dist.get_rank() if up else 0,
            process_count=dist.get_world_size() if up else 1,
            local_devices=1,  # every process drives one device
            global_devices=dist.get_world_size() if up else 1,
        )
    return info
