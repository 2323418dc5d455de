"""Throughput and variance sweep of the matmul kernel's dot precision
(counterpart of ``tools/bench_mm_precision.py``).

Runs ``CudaMJHMC`` on sparse coding and product of t at each of the four
precisions (``cuda_mjhmc.PRECISIONS``), set as JAX sets it,
``eng.spec = dataclasses.replace(eng.spec, precision=...)``: one warm run
of ``--steps`` jump iterations, then the best of three timed runs. For each
``"<config>/<precision>"`` it reports ``steps_per_sec``, credited leapfrog
steps per second (nbatch × M × steps over the best wall time, host clock
after a synchronise; in steps/s, where the JAX tool writes billions), and
``var_head``, the dwell-weighted variances of the first four dims from the
last run's accumulators: the column to watch for the precision's shift
against ``"highest"``; and ``launches``, the run kernel's launches at
that precision during the entry (0 on the CPU, where the plain version
runs).

    python -m mjhmc_tpu_torch.bench_mm_precision [--nbatch 4096] [--steps 2000]
        [--device cuda] [--json-out FILE]

Prints ONE JSON line: the eight entries and ``device`` (the card's name and
power limit as ``nvidia-smi`` reports them, or ``cpu``). It writes a file
only with ``--json-out``. ``--device cpu`` runs the kernels' plain version,
at a small ``--nbatch`` and ``--steps``; its rates are the CPU's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
from mjhmc_tpu_torch.ops.cuda_mjhmc import PRECISIONS, CudaMJHMC, cuda_mjhmc_mm_run

CONFIGS = ("sparse_coding", "product_of_t")
TRIALS = 3


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def time_engine(cfg, precision: str, nbatch: int, steps: int, device: str,
                seed: int = 0) -> dict:
    """One config at one precision: credited steps/s (best of ``TRIALS``),
    the first four dwell-weighted variances of the last run and the run
    kernel's launches."""
    counter = f"{precision}_launches"
    before = getattr(cuda_mjhmc_mm_run, counter)
    eng = CudaMJHMC(cfg.make_distribution(), epsilon=cfg.epsilon, beta=cfg.beta,
                    num_leapfrog_steps=cfg.num_leapfrog_steps, nbatch=nbatch, seed=seed,
                    device=device)
    eng.spec = dataclasses.replace(eng.spec, precision=precision)
    eng.run(steps)  # warm: build, load, first launch
    _sync(device)
    best = float("inf")
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        out = eng.run(steps)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    _, var = CudaMJHMC.moments(out)
    return {"steps_per_sec": steps * nbatch * cfg.num_leapfrog_steps / best,
            "var_head": [float(v) for v in var[:4]],
            "launches": getattr(cuda_mjhmc_mm_run, counter) - before}


def sweep(nbatch: int, steps: int, device: str) -> dict:
    return {f"{name}/{prec}": time_engine(BENCHMARK_CONFIGS[name], prec, nbatch, steps, device)
            for name in CONFIGS for prec in PRECISIONS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nbatch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain version)")
    ap.add_argument("--json-out", default=None, help="write the record here too")
    a = ap.parse_args(argv)

    if a.device == "cpu":
        device = {"name": "cpu"}
    else:
        from mjhmc_tpu_torch.bench import gpu_name_and_power_limit

        if not torch.cuda.is_available():
            print("# the precision sweep needs a CUDA device (or --device cpu)", file=sys.stderr)
            return 1
        name, limit = gpu_name_and_power_limit()
        device = {"name": name, "power_limit": limit}
    rec = {**sweep(a.nbatch, a.steps, a.device),
           "device": {**device, "nbatch": a.nbatch, "steps": a.steps}}
    print(json.dumps(rec))
    if a.json_out:
        with open(a.json_out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
