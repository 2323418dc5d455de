"""Weak-scaling benchmark of the chain-sharded runtime: rough-well chains
sharded over 1 → N ranks (counterpart of the root ``bench_scaling.py``).

    python -m mjhmc_tpu_torch.bench_scaling --devices 1
    torchrun --nproc_per_node 2 -m mjhmc_tpu_torch.bench_scaling --device cpu --devices 1 2

Each size of ``--devices`` runs on a sub-group of the launched ranks (the
first ``size`` of them), with ``--chains-per-device`` chains on each rank;
sizes above the world size are skipped with a ``#`` line, as JAX skips
them. Rank 0 prints one JSON line per size (``leapfrog_steps_per_sec``,
credited as ``bench.py`` credits: chains × M per iteration) and, when
size 1 and another ran, ``weak_scaling_efficiency``. A run is timed from
the same start state, best of 3; its time is the slowest rank's.

``--engine cuda`` runs ``sharded_cuda_mjhmc_run``, one launch of the run
kernel per rank; ``--engine torch`` the plain ``mjhmc_run`` on the rank's
block, which is what the JAX script times. Without ``torchrun`` the process
makes a group of its own (world size 1). ``--profile DIR`` traces one more
run of the largest size with ``utils.profiling.trace`` (``DIR/rank<r>``),
and rank 0 then prints the ``collective_time_fraction`` line from its trace
(``utils.profiling.parse_trace_collectives``: the NCCL kernels' share of the
card's kernel time, or on the CPU the collective ops' share of the host
ops'), before ``weak_scaling_efficiency``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
from mjhmc_tpu_torch.ops.cuda_mjhmc import energy_spec_for, sharded_cuda_mjhmc_run
from mjhmc_tpu_torch.parallel.mesh import make_chain_mesh, shard_chain_pytree
from mjhmc_tpu_torch.parallel.multihost import free_port, initialize
from mjhmc_tpu_torch.samplers.mjhmc import mjhmc_run
from mjhmc_tpu_torch.samplers.state import make_mj_state
from mjhmc_tpu_torch.utils.profiling import parse_trace_collectives, trace
from mjhmc_tpu_torch.utils.timing import block_until_ready


def _runner(args, cfg, model, mesh):
    """run(seed) -> its result tensors, from this rank's block of a fresh
    state of chains-per-device × size chains."""
    nbatch = args.chains_per_device * mesh.size()
    state = shard_chain_pytree(make_mj_state(model, torch.Generator().manual_seed(0), nbatch,
                                             mesh.device), mesh)
    eps, beta, m = cfg.epsilon, cfg.beta, cfg.num_leapfrog_steps
    if args.engine == "cuda":
        spec = energy_spec_for(model)
        ch = state.chain
        st = (ch.x, ch.v, ch.grad, ch.u, state.h_back, state.back_valid.float())
        return lambda seed: sharded_cuda_mjhmc_run(mesh, spec, *st, seed, eps, beta, args.steps, m)
    block = mesh.block(*state.chain.x.shape)
    return lambda seed: mjhmc_run(model, state, torch.Generator().manual_seed(seed), args.steps,
                                  eps, beta, m, "stats", block=block)


def _measure(args, cfg, model, mesh, profile) -> dict:
    run = _runner(args, cfg, model, mesh)
    block_until_ready(run(0))
    best = float("inf")
    for i in range(3):
        dist.barrier(group=mesh.group())
        t0 = time.perf_counter()
        block_until_ready(run(i + 1))
        el = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=mesh.device)
        dist.all_reduce(el, op=dist.ReduceOp.MAX, group=mesh.group())
        best = min(best, float(el))
    nbatch = args.chains_per_device * mesh.size()
    rec = {"metric": "leapfrog_steps_per_sec", "devices": mesh.size(), "chains": nbatch,
           "value": args.steps * nbatch * cfg.num_leapfrog_steps / best, "unit": "steps/s",
           "step_time_ms": best / args.steps * 1e3, "engine": args.engine,
           "device": (torch.cuda.get_device_name(mesh.device) if mesh.device.type == "cuda"
                      else "cpu")}
    if profile:
        with trace(os.path.join(profile, f"rank{dist.get_rank()}")):
            block_until_ready(run(99))
        rec["trace"] = os.path.join(profile, "rank0", "trace.json")
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--chains-per-device", type=int, default=2048)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--engine", choices=["cuda", "torch"], default="cuda")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace one more run of the largest size into DIR/rank<r>")
    args = p.parse_args(argv)

    owned = not dist.is_initialized()
    if not initialize(device=args.device)["initialized"]:  # no torchrun: a group of one
        initialize(f"127.0.0.1:{free_port()}", 1, 0, device=args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = BENCHMARK_CONFIGS["rough_well"]
    model = cfg.make_distribution()
    sizes = [nd for nd in args.devices if nd <= world]
    rates = {}
    try:
        for nd in args.devices:
            if nd > world:
                if rank == 0:
                    print(f"# skipping {nd} devices (only {world})", file=sys.stderr)
                continue
            group = dist.new_group(list(range(nd)))  # every rank enters
            if rank < nd:
                mesh = make_chain_mesh(nd, group=group, device=args.device)
                rec = _measure(args, cfg, model, mesh, args.profile if nd == max(sizes) else None)
                rates[nd] = rec["value"]
                if rank == 0:
                    print(json.dumps(rec), flush=True)
                if rank == 0 and "trace" in rec:
                    prof = parse_trace_collectives(os.path.dirname(rec["trace"]))
                    print(json.dumps({"metric": "collective_time_fraction", "devices": nd,
                                      "value": prof["fraction"], "unit": "fraction",
                                      "collective_us": prof["collective_us"],
                                      "total_us": prof["total_us"], "by_op": prof["by_op"]}),
                          flush=True)
            dist.barrier()
        if rank == 0 and 1 in rates and len(rates) > 1:
            nd = max(rates)
            eff = rates[nd] / (rates[1] * nd)
            print(json.dumps({"metric": "weak_scaling_efficiency", "devices": nd, "value": eff,
                              "unit": "fraction", "vs_baseline": eff / 0.9}), flush=True)
    finally:
        if owned:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
