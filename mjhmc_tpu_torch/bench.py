"""Headline benchmark of the CUDA engine: MJHMC on the 2-D rough well.

Prints ONE JSON line, as the root ``bench.py`` does:
``{"metric": "leapfrog_steps_per_sec_per_chip", "value", "unit",
"vs_baseline", "value_at_config2_nbatch", "config2_nbatch", "device_name",
"power_limit"}``.

Counting follows ``bench.py``: only the algorithmic forward trajectory
steps (nbatch × M per iteration) are credited, though every iteration also
integrates the backward half. ``value`` is at 102,400 chains and
``value_at_config2_nbatch`` at the config's own 10,000. Timing uses CUDA
events around one engine call after a warm call; there is no other path,
and no card is an error.

    python -m mjhmc_tpu_torch.bench
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import torch

from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
from mjhmc_tpu_torch.ops.cuda_mjhmc import CudaMJHMC


def gpu_name_and_power_limit() -> tuple:
    """(name, power limit) as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.split(","))
    return name, limit


def bench_cuda(cfg, nbatch: int, steps_per_call: int = 10_000, trials: int = 3,
               precision: str | None = None) -> float:
    """Credited leapfrog steps/s of the engine run kernel (best of ``trials``)
    for any config the engine takes: the elementwise kernel for rough_well
    and the Gaussians, the matmul kernel for product_of_t and sparse_coding
    (at the spec's JAX default dot precision, or ``precision``)."""
    eng = CudaMJHMC(
        cfg.make_distribution(), epsilon=cfg.epsilon, beta=cfg.beta,
        num_leapfrog_steps=cfg.num_leapfrog_steps, nbatch=nbatch, seed=0,
        device="cuda",
    )
    if precision is not None:
        eng.spec = dataclasses.replace(eng.spec, precision=precision)
    eng.run(steps_per_call)  # warm: build, load, first launch
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.run(steps_per_call)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return steps_per_call * nbatch * cfg.num_leapfrog_steps / best


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("the CUDA engine benchmark needs a CUDA device")
    cfg = BENCHMARK_CONFIGS["rough_well"]
    name, limit = gpu_name_and_power_limit()
    rate = bench_cuda(cfg, nbatch=102_400)
    rec = {
        "metric": "leapfrog_steps_per_sec_per_chip",
        "value": rate,
        "unit": "steps/s",
        "vs_baseline": rate / 1_000_000.0,
        "value_at_config2_nbatch": bench_cuda(cfg, nbatch=cfg.nbatch),
        "config2_nbatch": cfg.nbatch,
        "device_name": name,
        "power_limit": limit,
    }
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
