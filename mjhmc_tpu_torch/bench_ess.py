"""Effective samples/s/chip (BASELINE's north-star metric), the port's
counterpart of the root ``bench_ess.py``.

    python -m mjhmc_tpu_torch.bench_ess --config rough_well --sampler mjhmc
    python -m mjhmc_tpu_torch.bench_ess --table [--tune] [--configs a,b] [--json-out F]

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
lengthened while their spread exceeds ``--spread-tol``).

``--table`` sweeps configs × samplers (``--configs``, ``--samplers``), a
row each, printed as it is measured, the median of ``--repeats`` (5 by
default) at the preset's point; within a config every row is then
measured again at the longest window any of them reached. With ``--tune``
each (config, sampler) pair is first tuned: a boundary-audited (ε, β, M)
grid (``search.grid.grid_search``; objective gradient evals to ρ = 1/e;
the barrier configs tune the two-stage integrator jointly, the others try
matched-budget (2ε, M/2) transforms of their top two points), then an
arbitration of regime-diverse candidates by short-window ESS/s; NUTS rows
take the Stan-style warmup (ε and a diagonal mass) and arbitrate max_depth
over {4, 6, 8, 10}, extended to 12 when 10 wins. Unlike the JAX harness
there is no lane-block axis (a TPU layout), and a candidate or depth point
whose run fails raises rather than ranking last.

The engines run on the card unless ``--device cpu`` is asked for, where
they run their plain versions; without a card it exits non-zero.
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

TABLE_CONFIGS = (
    "gauss2d", "rough_well", "rough_well_a3", "product_of_t", "gauss50d",
    "sparse_coding",
)

# configs whose tuned leapfrog ε is acceptance-limited by the energy
# error's ripple, where the two-stage splitting's smaller error constant can
# pay for its 2 evals a step: these tune (integrator, ε, β, M) jointly;
# elsewhere two-stage enters the arbitration as matched-budget transforms
BARRIER_CONFIGS = ("rough_well", "rough_well_a3")

# β (or MALT's γ) floor: at β = 2e-4 the refresh timescale 1/β = 5,000
# iterations exceeds every search window here, so a lower β cannot change
# the measured decay (the effective β → 0 limit)
_BETA_FLOOR = 2e-4
# trajectory-length ladder of the M axis, extended on demand
_M_LADDER = (2, 5, 10, 20, 35, 50, 70, 100, 140, 200, 280, 400, 560)


def _tune(dist, sampler, cfg, steps=600, nbatch=256, nlags=150,
          max_rounds=5, integrator="leapfrog", device="cuda"):
    """Boundary-audited dense log-grid (ε, β, M) tune.

    Runs ``search.grid.grid_search`` and, whenever the best point lands on
    a non-physical grid edge (ε at either end, β at a floor above
    ``_BETA_FLOOR``, M at the ladder top, MALT's γ at its top), widens that
    axis and searches again, up to ``max_rounds`` times. Physical bounds
    are never extended: β = 1 (full refresh) and β ≤ ``_BETA_FLOOR``.
    Returns ``(best_row, boundary, table)`` with boundary "interior",
    "physical" or "pinned:<axes>" (the audit ran out of rounds with an axis
    still on a widenable edge).
    """
    from mjhmc_tpu_torch.search.grid import grid_search

    eps0 = cfg.epsilon
    if integrator == "two_stage":
        # matched budget: 2 evals a step, so the comparable step is ~2× leapfrog's
        eps0 = 2.0 * eps0
    eps_lo, eps_hi = eps0 / 8.0, eps0 * 8.0
    beta_lo, beta_hi = 5e-3, 1.0
    m_hi = 20
    best = None
    for _ in range(max_rounds):
        m_grid = tuple(m for m in _M_LADDER if m <= m_hi)[-6:]
        res = grid_search(
            dist,
            sampler=sampler,
            eps_grid=tuple(np.geomspace(eps_lo, eps_hi, 7)),
            beta_grid=tuple(np.geomspace(beta_lo, beta_hi, 7)),
            m_grid=m_grid,
            num_steps=steps,
            nbatch=min(nbatch, cfg.nbatch),
            nlags=nlags,
            integrator=integrator,
            device=device,
        )
        best = res.best
        pinned = []
        if np.isclose(best["epsilon"], eps_hi, rtol=1e-3):
            pinned.append("eps_hi")
            eps_lo, eps_hi = best["epsilon"] / 2.0, eps_hi * 4.0
        elif np.isclose(best["epsilon"], eps_lo, rtol=1e-3):
            pinned.append("eps_lo")
            eps_hi, eps_lo = best["epsilon"] * 2.0, eps_lo / 4.0
        if np.isclose(best["beta"], beta_lo, rtol=1e-3) and beta_lo > _BETA_FLOOR * (1 + 1e-3):
            pinned.append("beta_lo")
            beta_lo = max(_BETA_FLOOR, beta_lo / 25.0)
        if sampler == "malt" and np.isclose(best["beta"], beta_hi, rtol=1e-3) and beta_hi < 50.0:
            # MALT's β slot is the friction γ, which has no ceiling at 1
            pinned.append("gamma_hi")
            beta_lo, beta_hi = best["beta"] / 2.0, beta_hi * 8.0
        if best["num_leapfrog_steps"] == max(m_grid) and m_hi < _M_LADDER[-1]:
            pinned.append("m_hi")
            m_hi = next(m for m in _M_LADDER if m > m_hi * 1.9)
        if not pinned:
            break
    else:
        if pinned:
            return best, "pinned:" + ",".join(pinned), res.table
    return best, ("physical" if _physical(best["beta"]) else "interior"), res.table


def _physical(beta) -> bool:
    """β on a physical bound: full refresh, or at most the floor."""
    return bool(np.isclose(beta, 1.0, rtol=1e-3) or beta <= _BETA_FLOOR * (1 + 1e-3))


def _candidates(best, table, cfg=None, k=7):
    """Regime-diverse arbitration set, by grid decay: the audited grid's
    best, the best uncensored point of each other β decade, the best point
    at each distinct M, and the config's preset point, at most ``k``.

    The grid's objective (gradient evals to ρ = 1/e) and the reported
    metric (ESS/s on the fused engine) can part in both directions: the
    eval-optimal corner (tiny β, tiny M) spends its wall on per-iteration
    work and correlated emissions, and on near-iid targets ESS saturates at
    the raw samples, rewarding the cheapest emissions (small M). The
    per-decade and per-M bests cover both; the candidates are then ranked
    by measured ESS/s.
    """
    pool = [r for r in table
            if np.isfinite(r["decay_evals"]) and not r.get("censored", False)] or list(table)
    pool = sorted(pool, key=lambda r: r["decay_evals"])

    def bkey(r):
        return int(np.floor(np.log10(max(r["beta"], 1e-12))))

    cands = [best]
    per_decade, per_m = {}, {}
    for r in pool:
        per_decade.setdefault(bkey(r), r)
        per_m.setdefault(int(r["num_leapfrog_steps"]), r)
    extras = list(per_decade.values()) + list(per_m.values())
    if cfg is not None:
        extras.append(dict(
            epsilon=float(cfg.epsilon), beta=float(cfg.beta),
            num_leapfrog_steps=int(cfg.num_leapfrog_steps),
            decay_evals=float("nan"), censored=False,
        ))
    seen = {(best["epsilon"], best["beta"], best["num_leapfrog_steps"])}
    for r in extras:
        key = (r["epsilon"], r["beta"], r["num_leapfrog_steps"])
        if key in seen:
            continue
        seen.add(key)
        cands.append(r)
        if len(cands) >= k:
            break
    return cands


def _tune_nuts(dist, cfg, device="cuda"):
    """Stan-style NUTS warmup (dual-averaged ε and a variance-estimated
    diagonal mass) at ``min(256, cfg.nbatch)`` chains from a generator
    seeded 11 (JAX: ``key(11)``). Returns (ε, mass_diag)."""
    from mjhmc_tpu_torch.samplers.adaptation import nuts_full_warmup

    nbatch = min(256, cfg.nbatch)
    _, eps, inv_mass = nuts_full_warmup(dist, torch.Generator().manual_seed(11), nbatch,
                                        eps0=cfg.epsilon, device=device)
    mass_diag = tuple(1.0 / np.asarray(torch.as_tensor(inv_mass).cpu()).ravel())
    return float(eps), mass_diag


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


def _equalize_config_windows(config, entries, rows, repeats, spread_tol, device="cuda"):
    """Within a config, measure again every row whose window (steps × thin)
    is below the longest any row reached, at that window (emits capped by
    memory, thin making up the rest; the plain rows have no thin), so that
    every value of a config shares one window: ESS/s grows with the window
    for every row (the per-call cost amortizes, and where ESS saturates at
    the raw samples it scales with them). ``entries``: (row index, sampler,
    operating point). The row keeps its ``tuned``, ``boundary``,
    ``arbitration`` and ``depth_lane_rates`` fields (the last JAX's name,
    which here holds depths only)."""
    effs = {}
    for i, sampler, _ in entries:
        rep = rows[i]["detail"]["repeats"]
        effs[i] = rep["window_steps"] * rep["thin"]
    if not effs or len(set(effs.values())) <= 1:
        return
    target = max(effs.values())
    cfg = BENCHMARK_CONFIGS[config]
    cap = _window_cap(cfg, cfg.make_distribution())
    for i, sampler, p in entries:
        if effs[i] >= target:
            continue
        steps = min(target, cap)
        thin = -(-target // steps)  # ceil
        if sampler in PLAIN_SAMPLERS and thin > 1:
            thin = 1  # the plain rows have no thin: the emits' cap
        old = rows[i]
        rec = measure_repeats(
            config, sampler, steps, 500, p["epsilon"], p["beta"], p["m"],
            repeats=repeats, spread_tol=spread_tol, mass_diag=p["mass"],
            integrator=p["integrator"], max_doublings=0, thin=thin, device=device,
        )
        for k in ("tuned", "boundary", "arbitration", "depth_lane_rates"):
            if k in old["detail"]:
                rec["detail"][k] = old["detail"][k]
        rec["detail"]["window_equalized_to"] = int(target)
        rec["detail"]["pre_equalization_value"] = old["value"]
        rows[i] = rec
        print(json.dumps(rec), flush=True)


def _arbitrate_sampler(config, sampler, cfg, a):
    """The ``--tune`` path of an mjhmc, control or MALT row: the audited
    grid tune (rough_well_a3 at a 4× window), candidates, two-stage
    candidates for mjhmc and control, then the candidate of the best
    short-window ESS/s. Returns (ε, β, M, integrator, boundary, candidates,
    tuned)."""
    dist = cfg.make_distribution()
    # barrier mixing is slow: a 4× window there, so slow samplers tune uncensored
    tk = dict(steps=2400, nlags=600) if config == "rough_well_a3" else {}
    best, boundary, gtable = _tune(dist, sampler, cfg, device=a.device, **tk)
    cands = [dict(c, integrator="leapfrog") for c in _candidates(best, gtable, cfg)]
    boundaries = {"leapfrog": boundary}
    if sampler in ("mjhmc", "control"):
        if config in BARRIER_CONFIGS:
            # the joint (integrator, ε, β, M) grid tune
            best2, b2, gt2 = _tune(dist, sampler, cfg, integrator="two_stage",
                                   device=a.device, **tk)
            cands += [dict(c, integrator="two_stage") for c in _candidates(best2, gt2, cfg, k=5)]
            boundaries["two_stage"] = b2
        else:
            # matched-budget transforms of the top two: 2ε with M/2 steps, the
            # same evals and trajectory span
            for c in list(cands[:2]):
                cands.append(dict(c, integrator="two_stage", epsilon=2.0 * c["epsilon"],
                                  num_leapfrog_steps=max(1, c["num_leapfrog_steps"] // 2)))
            boundaries["two_stage"] = "matched-budget"
    seen, uniq = set(), []
    for c in cands:
        key = (c["integrator"], round(c["epsilon"], 9), round(c["beta"], 9),
               c["num_leapfrog_steps"])
        if key not in seen:
            seen.add(key)
            uniq.append(c)
    cands = uniq
    # ranked by the reported metric on a short window; the caller measures
    # the winner at the full repeats protocol
    best_rate, win = -1.0, cands[0]
    for cand in cands:
        trial = measure(config, sampler, max(600, a.steps // 4), max(200, a.burn // 2),
                        cand["epsilon"], cand["beta"], cand["num_leapfrog_steps"],
                        trials=1, integrator=cand["integrator"], device=a.device)
        if trial["value"] > best_rate:
            best_rate, win = trial["value"], cand
    integ = win["integrator"]
    if win is cands[0]:
        out_boundary = boundaries["leapfrog"]
    elif boundaries.get(integ) == "matched-budget":
        out_boundary = "matched-budget:arbitrated"
    else:
        # the audit's verdict is each grid's best point's; relabel the winner
        out_boundary = ("physical" if _physical(win["beta"]) else "interior") + ":arbitrated"
    tuned = not win.get("censored", False)
    return (win["epsilon"], win["beta"], win["num_leapfrog_steps"], integ, out_boundary,
            len(cands), tuned)


def _arbitrate_nuts(config, sampler, cfg, a, eps, mass):
    """Measured max_depth arbitration of a NUTS row: short-window ESS/s over
    depths {4, 6, 8, 10}, extended once to 12 when 10 wins. Returns
    (max_depth, boundary, {"d<depth>": rate})."""
    depth_grid = [4, 6, 8, 10]
    rates = {}

    def rate(d):
        if d not in rates:
            rates[d] = measure(config, sampler, max(600, a.steps // 4), max(200, a.burn // 2),
                               eps, None, d, trials=1, mass_diag=mass,
                               device=a.device)["value"]
        return rates[d]

    best = max(depth_grid, key=rate)
    boundary = "warmup-adapted+arbitrated"
    if best == depth_grid[-1] and rate(12) > rate(best):
        # won at the grid's edge: extended once (12 is 4,095 leaves)
        best = 12
        boundary += ":depth_hi"
    return best, boundary, {f"d{d}": float(f"{v:.6g}") for d, v in rates.items()}


def table(a) -> list:
    """The ``--table`` rows (see the module docstring), each printed as it is
    measured; then each config's windows are equalized."""
    repeats = 5 if a.repeats is None else a.repeats
    rows = []
    configs = TABLE_CONFIGS if not a.configs else tuple(c for c in a.configs.split(",") if c)
    for config in configs:
        cfg = BENCHMARK_CONFIGS[config]
        entries = []  # (row index, sampler, operating point)
        for sampler in (s for s in a.samplers.split(",") if s):
            eps = beta = m = mass = None
            integ, tuned, boundary, extra = "leapfrog", False, None, {}
            if a.tune and sampler in ("nuts", "nuts-engine"):
                # the warmup's ε and mass, then the measured depth arbitration
                eps, mass = _tune_nuts(cfg.make_distribution(), cfg, a.device)
                m, boundary, extra["depth_lane_rates"] = _arbitrate_nuts(
                    config, sampler, cfg, a, eps, mass)
                tuned = True
            elif a.tune:
                eps, beta, m, integ, boundary, ncands, tuned = _arbitrate_sampler(
                    config, sampler, cfg, a)
                extra["arbitration"] = (f"ess/s over {ncands} regime-diverse grid "
                                        "candidates (x integrator)")
            rec = measure_repeats(config, sampler, a.steps, a.burn, eps, beta, m,
                                  repeats=repeats, spread_tol=a.spread_tol, mass_diag=mass,
                                  integrator=integ, device=a.device)
            rec["detail"]["tuned"] = tuned
            if boundary is not None:
                rec["detail"]["boundary"] = boundary
            rec["detail"].update(extra)
            entries.append((len(rows), sampler, dict(epsilon=eps, beta=beta, m=m, mass=mass,
                                                     integrator=integ)))
            rows.append(rec)
            print(json.dumps(rec), flush=True)
        _equalize_config_windows(config, entries, rows, repeats, a.spread_tol, a.device)
    return rows


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
    ap.add_argument("--repeats", type=int, default=None,
                    help="independent repeat measurements (median + spread in the record); "
                         "1 by default, 5 under --table")
    ap.add_argument("--spread-tol", type=float, default=0.20,
                    help="relative spread above which the window lengthens")
    ap.add_argument("--table", action="store_true",
                    help="sweep the table's configs x samplers, a row each")
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of the table's configs")
    ap.add_argument("--samplers", default="mjhmc,control,malt,nuts-engine,nuts",
                    help="comma-separated samplers of the --table rows")
    ap.add_argument("--tune", action="store_true",
                    help="with --table: tune (eps, beta, M [, integrator]) or NUTS's warmup "
                         "and max_depth per row before measuring")
    ap.add_argument("--json-out", default=None, help="with --table: write the rows here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the engines run their plain versions")
    a = ap.parse_args(argv)

    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        print("bench_ess: --device cuda needs a CUDA device (use --device cpu)",
              file=sys.stderr)
        return 1
    if a.table:
        rows = table(a)
        if a.json_out:
            with open(a.json_out, "w") as f:
                json.dump(rows, f, indent=1)
        return 0
    args = (a.config, a.sampler, a.steps, a.burn, a.epsilon, a.beta, a.num_leapfrog_steps)
    if a.repeats is not None and a.repeats > 1:
        rec = measure_repeats(*args, repeats=a.repeats, spread_tol=a.spread_tol,
                              integrator=a.integrator, thin=a.thin, device=a.device)
    else:
        rec = measure(*args, integrator=a.integrator, thin=a.thin, device=a.device)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
