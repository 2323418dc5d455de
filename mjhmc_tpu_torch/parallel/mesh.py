"""Chain mesh and chain blocks for the chain-parallel runtime (counterpart
of ``mjhmc_tpu.parallel.mesh``).

The reference's one parallel primitive, a batch of independent chains,
maps to a 1-D ``("chains",)`` mesh over the ranks of a process group, each
rank holding one contiguous block of the chain (last) axis of every state
tensor. Cross-chain reductions (moments, eval counters, the adaptation's
acceptance mean, SMC resampling) are the only collectives, issued
explicitly by ``parallel.collectives`` and the samplers; the sampling loop
itself communicates nothing.

An optional second ``("model",)`` axis splits the sparse-coding basis
(``parallel.model_parallel``). Ranks lie row-major on the
(chains, model) grid, as ``jax.make_mesh`` lays devices out.

Where JAX holds global arrays with shardings, a rank here holds only its
block; ``ChainMesh.block`` says where that block lies in the global
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from mjhmc_tpu_torch.parallel.multihost import rank_device
from mjhmc_tpu_torch.samplers.state import Block
from mjhmc_tpu_torch.utils.pytree import tree_map

Tensor = torch.Tensor


@dataclasses.dataclass
class ChainMesh:
    """A ``("chains",)`` or ``("chains", "model")`` mesh: its shape, this
    rank's coordinate and process group along each axis, and its device."""

    shape: dict  # axis name -> size
    coords: dict  # axis name -> this rank's index along the axis
    groups: dict  # axis name -> this rank's process group along the axis
    device: torch.device

    def size(self, axis: str = "chains") -> int:
        return self.shape[axis]

    def axis_index(self, axis: str = "chains") -> int:
        return self.coords[axis]

    def group(self, axis: str = "chains"):
        return self.groups[axis]

    def block(self, ndims: int, nbatch: int) -> Block:
        """Where this rank's (ndims, nbatch) block lies in the global state."""
        q, m = self.shape.get("model", 1), self.coords.get("model", 0)
        p, c = self.size(), self.axis_index()
        return Block(ndims * q, nbatch * p, slice(m * ndims, (m + 1) * ndims),
                     slice(c * nbatch, (c + 1) * nbatch))


def make_chain_mesh(n_devices: Optional[int] = None, model_axis: int = 1, group=None,
                    device="cuda") -> ChainMesh:
    """1-D ("chains",) mesh over the ranks of ``group`` (the whole job by
    default), or ("chains", "model") when ``model_axis`` > 1 (the whole
    job only: every process enters the sub-groups' creation).
    ``n_devices`` must be the group's size, or None."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.initialize() first")
    if model_axis > 1 and group is not None:
        raise ValueError("a ('chains', 'model') mesh spans the whole job (group=None)")
    group = dist.group.WORLD if group is None else group
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks) if n_devices is None else n_devices
    if n != len(ranks):
        raise ValueError(f"n_devices={n_devices}, but the group has {len(ranks)} ranks "
                         "(one device each)")
    me = dist.get_rank(group)
    if me < 0:
        raise ValueError("this process is not a rank of the mesh's group")
    dev = rank_device(device)
    if model_axis <= 1:
        return ChainMesh({"chains": n}, {"chains": me}, {"chains": group}, dev)
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into a model axis of {model_axis}")
    p, q = n // model_axis, model_axis
    c, m = divmod(me, q)
    # every process creates every sub-group, in one order
    chains = [dist.new_group([ranks[i * q + j] for i in range(p)]) for j in range(q)]
    model = [dist.new_group([ranks[i * q + j] for j in range(q)]) for i in range(p)]
    return ChainMesh({"chains": p, "model": q}, {"chains": c, "model": m},
                     {"chains": chains[m], "model": model[c]}, dev)


def chain_sharding(mesh: ChainMesh, nbatch: int) -> slice:
    """This rank's contiguous block of a chain axis of ``nbatch`` chains."""
    p = mesh.size()
    if nbatch % p or nbatch < p:
        raise ValueError(f"{nbatch} chains do not split over {p} ranks")
    b = nbatch // p
    return slice(mesh.axis_index() * b, (mesh.axis_index() + 1) * b)


def shard_chain_pytree(tree, mesh: ChainMesh):
    """Every tensor of a sampler-state tree on the mesh's device: tensors
    whose last axis is the chain axis (size divisible by the mesh) keep
    this rank's block of it, anything else is kept whole (replicated)."""
    p = mesh.size()

    def place(t):
        if not isinstance(t, Tensor):
            return t
        t = t.to(mesh.device)
        if t.dim() >= 1 and t.shape[-1] % p == 0 and t.shape[-1] >= p:
            return t[..., chain_sharding(mesh, t.shape[-1])].contiguous()
        return t

    return tree_map(place, tree)
