"""Effective samples/s/chip (BASELINE's north-star metric), the port's
counterpart of the root ``bench_ess.py`` in single-run mode.

    python -m mjhmc_tpu_torch.bench_ess --config rough_well --sampler mjhmc

Rows:

  - ``--sampler mjhmc`` (default): the fused CUDA engine's streaming path
    (burn → timed stream of dwell-weighted samples → dwell-weighted Geyer
    ESS, computed on the device outside the timed window);
  - ``--sampler control``: the fused control HMC engine, the engine-class
    baseline (same kernel plumbing, same streaming protocol);
  - ``--sampler malt``: the fused MALT engine (the ``--beta`` slot carries
    the friction γ);
  - ``--sampler nuts-engine``: the fused NUTS engine
    (``--num-leapfrog-steps`` is max_depth, 8 by default);
  - ``--sampler control-xla|nuts``: the plain samplers' ``sample`` path,
    same protocol with unweighted ESS (the CLI names kept from the JAX
    package).

Prints ONE JSON line: ``{"metric": "effective_samples_per_sec_per_chip",
"value", "unit", "vs_baseline", "device_name", "power_limit", "detail"}``.
The timed window is ``trials`` stream calls after a warm one at the same
size, each ended by ``torch.cuda.synchronize()``; ``value`` is the ESS of
the last block over the best call's wall seconds. ``--thin k`` emits every
k-th iteration (engine rows): a window k times longer with the same
emitted block. ``--repeats N`` reports
the median of N independent measurements (fresh seeds, the window
lengthened while their spread exceeds ``--spread-tol``). The JAX
harness's ``--table`` and ``--tune`` need its grid search, which is not
ported yet. The engines run on the card unless ``--device cpu`` is asked
for, where they run their plain versions; without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np
import torch

from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
from mjhmc_tpu_torch.diagnostics.autocorr import effective_sample_size

ENGINE_SAMPLERS = ("mjhmc", "control", "malt", "nuts-engine")
PLAIN_SAMPLERS = ("control-xla", "nuts")


def _window_cap(cfg, dist) -> int:
    """Emit cap keeping one (steps, d, nbatch) f32 block under ~2 GB — the
    timed loop holds two copies live (previous + new)."""
    return int(2_000_000_000 // (4 * dist.ndims * cfg.nbatch))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(call, trials: int, device, warm=None) -> tuple:
    """(best wall seconds of ``trials`` calls, the last call's result); each
    call is ended by a device synchronise. ``warm``, when given, is called
    (and synchronised) once first, untimed, to absorb first-use costs."""
    device = torch.device(device)
    if warm is not None:
        warm()
        sync(device)
    wall, out = float("inf"), None
    for _ in range(trials):
        t0 = time.perf_counter()
        out = call()
        sync(device)
        wall = min(wall, time.perf_counter() - t0)
    return wall, out


def device_record(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"device_name": "cpu", "power_limit": None}
    from mjhmc_tpu_torch.bench import gpu_name_and_power_limit

    name, limit = gpu_name_and_power_limit()
    return {"device_name": name, "power_limit": limit}


def measure(
    config: str,
    sampler: str = "mjhmc",
    steps: int = 2000,
    burn: int = 500,
    epsilon=None,
    beta=None,
    m=None,
    trials: int = 3,
    mass_diag=None,
    integrator: str = "leapfrog",
    seed: int = 0,
    thin: int = 1,
    device="cuda",
) -> dict:
    """ESS/s/chip for one (config, sampler) at the given operating point.

    ``seed`` gives an independent realization (fresh chains and a fresh
    window); ``thin`` lengthens the physical window without lengthening the
    emitted block (engine rows only).
    """
    device = torch.device(device)
    cfg = BENCHMARK_CONFIGS[config]
    dist = cfg.make_distribution()
    epsilon = cfg.epsilon if epsilon is None else epsilon
    beta = cfg.beta if beta is None else beta
    if sampler in ("nuts", "nuts-engine"):
        m = 8 if m is None else m  # max_depth (an explicit override wins)
    else:
        m = cfg.num_leapfrog_steps if m is None else m

    steps = max(100, min(steps, _window_cap(cfg, dist)))

    extra = {}
    if sampler in ENGINE_SAMPLERS:
        from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

        # the MALT engine's beta slot carries the friction gamma; the NUTS
        # engine's num_leapfrog slot is max_depth and its beta is unused
        cls = {"mjhmc": cm.CudaMJHMC, "control": cm.CudaControlHMC,
               "malt": cm.CudaMALT, "nuts-engine": cm.CudaNUTS}[sampler]
        kw = {}
        if sampler in ("mjhmc", "control"):
            kw["integrator"] = integrator
        if sampler == "nuts-engine":
            beta = 0.0
            if mass_diag is not None:
                kw["inv_mass"] = tuple(1.0 / np.asarray(mass_diag, np.float64))
        eng = cls(dist, epsilon=epsilon, beta=beta, num_leapfrog_steps=m,
                  nbatch=cfg.nbatch, seed=seed, device=device, **kw)
        eng.run(burn)
        call = functools.partial(eng.sample, steps, thin=thin)
        # the warm call loads the built library
        wall, (xs, ws) = timed(call, trials, device, warm=call)
        ess = float(effective_sample_size(xs, ws))
        chains, engine = eng.nbatch, "cuda"
    elif sampler in PLAIN_SAMPLERS:
        from mjhmc_tpu_torch.samplers import NUTS, ControlHMC

        if sampler == "control-xla":
            s = ControlHMC(dist, epsilon=epsilon, beta=beta, num_leapfrog_steps=m,
                           nbatch=cfg.nbatch, seed=seed, integrator=integrator,
                           device=device)
        else:
            s = NUTS(dist, epsilon=epsilon, nbatch=cfg.nbatch, seed=seed,
                     mass_diag=mass_diag, max_depth=m, device=device)
        s.burn_in(burn)
        call = functools.partial(s.sample, steps)
        wall, out = timed(call, trials, device, warm=call)
        ess = float(effective_sample_size(out["x"]))
        chains, engine = cfg.nbatch, "torch"
        if sampler == "nuts":  # tree-depth histogram
            d, counts = torch.unique(out["depth"].reshape(-1), return_counts=True)
            extra["depth_hist"] = {int(k): int(v) for k, v in zip(d.tolist(), counts.tolist())}
            if mass_diag is not None:
                extra["mass_matrix"] = "diagonal (warmup-estimated)"
    else:
        raise ValueError(sampler)

    if sampler in ("mjhmc", "control", "control-xla"):
        extra["integrator"] = integrator
    if thin != 1:
        extra["thin"] = int(thin)
    return {
        "metric": "effective_samples_per_sec_per_chip",
        "value": ess / wall,
        "unit": "ess/s",
        "vs_baseline": None,  # the reference publishes no absolute numbers
        **device_record(device),
        "detail": {
            "config": config,
            "sampler": sampler,
            "engine": engine,
            "ess_total": ess,
            "sampling_wall_s": wall,
            "steps": steps,
            "chains": int(chains),
            "raw_samples": steps * int(chains),
            "epsilon": float(epsilon),
            "beta": float(beta),
            "num_leapfrog_steps": int(m),
            **extra,
        },
    }


def measure_repeats(
    config, sampler, steps=2000, burn=500, epsilon=None, beta=None, m=None,
    repeats=5, spread_tol=0.20, mass_diag=None, integrator="leapfrog", trials=2,
    max_doublings=2, thin=1, device="cuda",
):
    """``repeats`` independent full-protocol measurements (fresh seed →
    fresh chains, fresh window), reported as the median with the per-repeat
    values and relative spread ((max−min)/median). While the spread exceeds
    ``spread_tol`` the window is lengthened — emits double until the memory
    cap, then ``thin`` doubles (engine rows) — up to ``max_doublings`` times
    or until a single window costs >20 s wall."""
    cfg = BENCHMARK_CONFIGS[config]
    cap = _window_cap(cfg, cfg.make_distribution())
    lengthened = 0
    for attempt in range(max_doublings + 1):
        recs = [measure(config, sampler, steps, burn, epsilon, beta, m, trials=trials,
                        mass_diag=mass_diag, integrator=integrator, seed=r, thin=thin,
                        device=device)
                for r in range(repeats)]
        vals = [rec["value"] for rec in recs]
        med = float(np.median(vals))
        spread = (max(vals) - min(vals)) / max(med, 1e-30)
        wall = float(np.median([r["detail"]["sampling_wall_s"] for r in recs]))
        if spread <= spread_tol or attempt == max_doublings or wall > 20.0:
            break
        if steps * 2 <= cap:
            steps *= 2
        elif sampler in ENGINE_SAMPLERS:
            thin *= 2  # longer physical window, same emitted block
        else:
            break  # a plain row at its cap: report the spread as it is
        lengthened += 1
    # the repeat whose value is closest to the median is the representative
    # record (its detail fields describe a real run)
    rec = recs[int(np.argmin([abs(v - med) for v in vals]))]
    rec["value"] = med
    rec["detail"]["repeats"] = {
        "n": len(vals),
        "values": [float(f"{v:.6g}") for v in vals],
        "rel_spread": round(spread, 4),
        "window_steps": int(steps),
        "thin": int(thin),
        "lengthened": int(lengthened),
    }
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="rough_well")
    ap.add_argument("--sampler", default="mjhmc", choices=[*ENGINE_SAMPLERS, *PLAIN_SAMPLERS])
    ap.add_argument("--steps", type=int, default=2000, help="streamed samples")
    ap.add_argument("--burn", type=int, default=500)
    ap.add_argument("--epsilon", type=float, default=None)
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--num-leapfrog-steps", type=int, default=None)
    ap.add_argument("--integrator", default="leapfrog", choices=["leapfrog", "two_stage"])
    ap.add_argument("--thin", type=int, default=1,
                    help="emit every thin-th iteration (engine rows): a longer window, "
                         "the same emitted block")
    ap.add_argument("--repeats", type=int, default=1,
                    help="independent repeat measurements (median + spread in the record)")
    ap.add_argument("--spread-tol", type=float, default=0.20,
                    help="relative spread above which the window lengthens")
    ap.add_argument("--table", action="store_true",
                    help="not ported yet: needs the grid search (ROADMAP.md, slice H)")
    ap.add_argument("--tune", action="store_true",
                    help="not ported yet: needs the grid search (ROADMAP.md, slice H)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the engines run their plain versions")
    a = ap.parse_args(argv)

    if a.table or a.tune:
        print("bench_ess: --table and --tune need search/grid.py, which is not ported "
              "yet (ROADMAP.md, slice H)", file=sys.stderr)
        return 2
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        print("bench_ess: --device cuda needs a CUDA device (use --device cpu)",
              file=sys.stderr)
        return 1
    args = (a.config, a.sampler, a.steps, a.burn, a.epsilon, a.beta, a.num_leapfrog_steps)
    if a.repeats > 1:
        rec = measure_repeats(*args, repeats=a.repeats, spread_tol=a.spread_tol,
                              integrator=a.integrator, thin=a.thin, device=a.device)
    else:
        rec = measure(*args, integrator=a.integrator, thin=a.thin, device=a.device)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
