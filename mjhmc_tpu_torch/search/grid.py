"""Grid sweep over sampler hyperparameters (counterpart of
``mjhmc_tpu.search.grid``).

The offline sweep over (ε, β, M) jointly, with the autocorrelation decay
time in gradient evaluations as the objective (the reference drove
Spearmint over the same objective). Each grid point runs the plain
sampler (``mjhmc_run``, ``hmc_run``, ``malt_run``) on the search's device
from one initial state per M, with a fresh generator per point seeded
from (seed, i), the counterpart of JAX's ``fold_in(key0, i)``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

from mjhmc_tpu_torch.diagnostics import weighted_autocorrelation
from mjhmc_tpu_torch.experiments.autocorr_experiment import _decay_time
from mjhmc_tpu_torch.models.base import Distribution
from mjhmc_tpu_torch.samplers import make_hmc_state, make_mj_state
from mjhmc_tpu_torch.samplers.hmc import hmc_run
from mjhmc_tpu_torch.samplers.malt import malt_run
from mjhmc_tpu_torch.samplers.mjhmc import mjhmc_run
from mjhmc_tpu_torch.samplers.state import checked_device


@dataclasses.dataclass
class SearchResult:
    best: dict
    table: list  # [{epsilon, beta, num_leapfrog_steps, decay_evals, censored}, ...]


def point_generator(seed: int, i: int) -> torch.Generator:
    """The generator of evaluation ``i`` of a search seeded by ``seed``."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence([seed, i]).generate_state(1)[0]))


def lag_window(num_steps: int, nlags: int, m: int) -> int:
    """Per-M lag window: the eval axis is lag × (~M evals/step), so small-M
    windows are widened to a comparable eval budget (capped by the run
    length) and a censored short window can never look best."""
    return int(min(num_steps * 0.6, nlags * max(1.0, 10.0 / m)))


def score(rho: np.ndarray, evals: int, num_steps: int, nbatch: int, nl: int):
    """(decay in grad evals, censored, the window's last eval) of one run:
    non-finite ρ scores ``inf``; a decay at the window's end is censored (a
    lower bound)."""
    axis = np.arange(nl) * (float(evals) / (num_steps * nbatch))
    decay = _decay_time(axis, rho)
    if not np.isfinite(rho).all():
        decay = float("inf")
    censored = bool(np.isfinite(decay) and decay >= axis[-1] * 0.999)
    return decay, censored, float(axis[-1])


def make_point_run(dist: Distribution, sampler: str, num_steps: int, nbatch: int, nl: int,
                   seed: int, m: int, integrator: str, device):
    """``run(eps, beta, generator) -> (ρ as numpy, Σ grad evals)`` for one M,
    from the initial state the seed's generator draws. MALT's second
    coordinate is its friction γ."""
    gen0 = torch.Generator().manual_seed(seed)
    if sampler == "mjhmc":
        state0 = make_mj_state(dist, gen0, nbatch, device)
    elif sampler in ("control", "malt"):
        state0 = make_hmc_state(dist, gen0, nbatch, device)
    else:
        raise ValueError(sampler)

    def run(eps, beta, gen):
        # (ε, β) in float32, as JAX's traced scalars are
        eps, beta = float(np.float32(eps)), float(np.float32(beta))
        if sampler == "mjhmc":
            st, out = mjhmc_run(dist, state0, gen, num_steps, eps, beta, m,
                                integrator=integrator)
            w = out["dwell"]
        elif sampler == "control":
            st, out = hmc_run(dist, state0, gen, num_steps, eps, beta, m, integrator=integrator)
            w = None
        else:
            st, out = malt_run(dist, state0, gen, num_steps, eps, beta, m)
            w = None
        rho = weighted_autocorrelation(out["x"], w, nl).cpu().numpy()
        return rho, int(st.grad_evals.sum(dtype=torch.int64))

    return run


def best_of(table: list, finite_fallback: bool = False) -> dict:
    """The smallest uncensored finite decay (censored values are lower
    bounds); else, with ``finite_fallback``, the smallest finite one; else
    the smallest of the whole table."""
    good = [r for r in table
            if np.isfinite(r["decay_evals"]) and not r.get("censored", False)]
    finite = [r for r in table if np.isfinite(r["decay_evals"])] if finite_fallback else []
    return min(good or finite or table, key=lambda r: r["decay_evals"])


def grid_search(
    dist: Distribution,
    sampler: str = "mjhmc",
    eps_grid: Sequence[float] = (0.1, 0.3, 1.0),
    beta_grid: Sequence[float] = (0.05, 0.2, 0.5),
    m_grid: Sequence[int] = (5,),
    num_steps: int = 800,
    nbatch: int = 256,
    nlags: int = 100,
    seed: int = 0,
    integrator: str = "leapfrog",
    device="cuda",
) -> SearchResult:
    """Sweep the grid on ``device``; objective = grad evals to ρ = 1/e
    (lower is better). ``integrator`` ("leapfrog" or "two_stage") threads
    to the mjhmc/control runs; the two-stage splitting's 2 evals a step are
    charged by the samplers' counters, so the objective stays fair."""
    if integrator != "leapfrog" and sampler not in ("mjhmc", "control"):
        raise ValueError(f"integrator={integrator!r} is only tunable for mjhmc/control")
    device = checked_device(device, "grid_search")
    table = []
    for m in m_grid:
        nl = lag_window(num_steps, nlags, m)
        run = make_point_run(dist, sampler, num_steps, nbatch, nl, seed, m, integrator, device)
        for i, (eps, beta) in enumerate(itertools.product(eps_grid, beta_grid)):
            rho, evals = run(eps, beta, point_generator(seed, i))
            decay, censored, _ = score(rho, evals, num_steps, nbatch, nl)
            table.append(dict(epsilon=float(eps), beta=float(beta), num_leapfrog_steps=int(m),
                              decay_evals=decay, censored=censored))
    return SearchResult(best=best_of(table), table=table)
