"""What the efficiency battery (``experiments.efficiency_claim``'s
``DEFAULT_TARGETS``, both samplers) costs on the eager path, projected
from runs timed target by target.

For each target, the burned-in init that its confirmations share is timed
once. For each target and sampler, one grid point is timed at the
smallest and at the largest M of the target's ladder, at the battery's own
search steps, chains and lags (a whole ``grid_search`` call: the state,
the run and the autocorrelation), and one confirmation
(``calculate_autocorrelation`` at M 10 with the protocol's lags and steps,
at ``seed + 7``). ε and β are the geometric middles of the target's
ranges. The sweep is projected as ``n_eps · n_beta`` points at each M of
the ladder, a point's seconds linear in M between the two timed ones; the
confirmations as 4 runs (the protocol's largest set) at M 10's seconds. A
confirmation that lands at M < 10 widens its lags and steps by 10 / M, so
such runs cost more than this counts.

Every call is timed on the host clock around work that ends in a device
synchronise; the receipt carries the card's name and power limit.

    python -m mjhmc_tpu_torch.bench_battery [--json-out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import tempfile

import numpy as np

from mjhmc_tpu_torch.bench_ess import device_record, timed
from mjhmc_tpu_torch.experiments import efficiency_claim as ec
from mjhmc_tpu_torch.experiments.autocorr_experiment import calculate_autocorrelation
from mjhmc_tpu_torch.samplers.state import checked_device
from mjhmc_tpu_torch.search.grid import grid_search
from mjhmc_tpu_torch.utils import init_cache

CONFIRM_M = 10
MAX_CONFIRMATIONS = 4  # the best point of each β decade, up to 4
SAMPLERS = ("mjhmc", "control")
SEED = 0  # efficiency --seed's default


def settings(kw: dict) -> dict:
    """A target's battery settings: ``tuned_decay``'s defaults under the
    target's own."""
    defaults = {k: p.default for k, p in inspect.signature(ec.tuned_decay).parameters.items()
                if p.default is not inspect.Parameter.empty}
    return {**defaults, **kw}


def time_target(name: str, make, kw: dict, device) -> dict:
    """Time one target's init, grid points and confirmations; project its
    share of the battery."""
    c = settings(kw)
    dist = make()
    eps = float(np.sqrt(c["eps_range"][0] * c["eps_range"][1]))
    beta = float(np.sqrt(c["beta_range"][0] * c["beta_range"][1]))
    ms = (min(c["m_grid"]), max(c["m_grid"]))
    nlags_c = int(c["nlags"] * max(1.0, 10.0 / CONFIRM_M))
    steps_c = max(c["num_steps"], 2 * nlags_c)
    # the init every confirmation of this target reads (calculate_autocorrelation's
    # defaults: 500 burn steps, the run's seed + 1000)
    init_s, _ = timed(lambda: init_cache.burned_in_init(
        dist, c["nbatch"], burn_steps=500, seed=SEED + 7 + 1000, device=device), 1, device)
    rec = dict(target=name, epsilon=eps, beta=beta, nbatch=c["nbatch"],
               search_steps=c["search_steps"], search_nlags=c["search_nlags"],
               m_grid=list(c["m_grid"]), points_per_m=c["n_eps"] * c["n_beta"],
               confirm_steps=steps_c, confirm_nlags=nlags_c, init_s=init_s, samplers={})
    total = init_s
    for sampler in SAMPLERS:
        point = {}
        for m in ms:
            point[m], _ = timed(lambda: grid_search(
                dist, sampler=sampler, eps_grid=(eps,), beta_grid=(beta,), m_grid=(m,),
                num_steps=c["search_steps"], nbatch=c["nbatch"], nlags=c["search_nlags"],
                seed=SEED, device=device), 1, device)
        slope = (point[ms[1]] - point[ms[0]]) / (ms[1] - ms[0]) if ms[1] > ms[0] else 0.0
        sweep = c["n_eps"] * c["n_beta"] * sum(point[ms[0]] + slope * (m - ms[0])
                                               for m in c["m_grid"])
        confirm_s, _ = timed(lambda: calculate_autocorrelation(
            dist, sampler=sampler, num_steps=steps_c, nbatch=c["nbatch"], nlags=nlags_c,
            seed=SEED + 7, device=device, epsilon=eps, beta=beta,
            num_leapfrog_steps=CONFIRM_M), 1, device)
        rec["samplers"][sampler] = dict(
            point_s={str(m): s for m, s in point.items()},
            ms_an_iteration={str(m): 1e3 * s / c["search_steps"] for m, s in point.items()},
            confirm_s=confirm_s, projected_sweep_s=sweep,
            projected_confirm_s=MAX_CONFIRMATIONS * confirm_s)
        total += sweep + MAX_CONFIRMATIONS * confirm_s
    rec["projected_s"] = total
    return rec


def time_battery(targets=ec.DEFAULT_TARGETS, device="cuda") -> dict:
    """The receipt: a row for each target and the projected hours of the
    whole battery. The burned-in inits go to a temporary cache, so each is
    built (and timed) once here."""
    device = checked_device(device, "time_battery")
    cache = init_cache.DEFAULT_CACHE_DIR
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        init_cache.DEFAULT_CACHE_DIR = tmp
        try:
            for name, make, kw in targets:
                rows.append(time_target(name, make, kw, device))
                print(json.dumps(rows[-1]), flush=True)
        finally:
            init_cache.DEFAULT_CACHE_DIR = cache
    return dict(device_record(device), rows=rows,
                projected_hours=sum(r["projected_s"] for r in rows) / 3600.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json-out", default=None, help="write the whole receipt here too")
    a = ap.parse_args(argv)
    receipt = time_battery(device=a.device)
    print(json.dumps({k: receipt[k] for k in ("device_name", "power_limit", "projected_hours")}))
    if a.json_out:
        with open(a.json_out, "w") as f:
            json.dump(receipt, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
