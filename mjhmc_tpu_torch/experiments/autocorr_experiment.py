"""Autocorrelation-vs-gradient-evaluations experiment (counterpart of
``mjhmc_tpu.experiments.autocorr_experiment``).

Run a sampler from shared burned-in inits, collect (sample, dwell-weight)
streams, and report the autocorrelation curve against the paper's fairness
axis, cumulative gradient evaluations, from the exact eval counters. The
``"cuda"`` engine streams MJHMC from the fused kernel
(``CudaMJHMC.sample(return_evals=True)``); ``"torch"`` runs the plain
samplers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from mjhmc_tpu_torch.diagnostics import weighted_autocorrelation
from mjhmc_tpu_torch.models.base import Distribution
from mjhmc_tpu_torch.samplers import (
    MALT,
    NUTS,
    ControlHMC,
    MarkovJumpHMC,
    ParallelTempering,
    ReducedFlipHMC,
)
from mjhmc_tpu_torch.utils.init_cache import burned_in_init

SAMPLERS = {
    "mjhmc": MarkovJumpHMC,
    "control": ControlHMC,
    "reduced_flip": ReducedFlipHMC,
    "nuts": NUTS,
    "malt": MALT,
    "pt": ParallelTempering,
}


class ACResult(NamedTuple):
    name: str
    grad_evals: np.ndarray  # (nlags,) cumulative-eval axis
    rho: np.ndarray  # (nlags,) autocorrelation
    decay_evals: float  # evals to reach ρ = 1/e (interpolated)
    total_grad_evals: int
    censored: bool = False  # ρ never reached 1/e inside the lag window —
    # decay_evals is then a lower bound (window end), not an estimate

    def to_frame(self):
        """pandas DataFrame (sampler, lag, grad_evals, autocorrelation), as
        the reference's pandas-based analysis path has it."""
        import pandas as pd

        return pd.DataFrame(
            {
                "sampler": self.name,
                "lag": np.arange(len(self.rho)),
                "grad_evals": self.grad_evals,
                "autocorrelation": self.rho,
            }
        )


def _exact_evals_axis(evals_mean: np.ndarray, nlags: int) -> np.ndarray:
    """Exact lag→grad-evals alignment from the cumulative counter trajectory.

    ``evals_mean[t]`` is the chain-mean cumulative eval counter *after* scan
    step t. The eval distance the ρ(k) estimator actually spans is the
    average over start times t of ``e[t+k] − e[t]`` — computed exactly here
    (O(T) via prefix sums), instead of the stationary-rate approximation
    ``k · total/steps``. The two agree when refresh rates are constant;
    MJHMC at small β is bursty enough for the reference to have aligned to
    true cumulative counters (SURVEY.md §3.3).
    """
    e = np.asarray(evals_mean, np.float64)
    t = len(e)
    c = np.concatenate([[0.0], np.cumsum(e)])  # c[i] = Σ_{s<i} e[s]
    k = np.arange(min(nlags, t))
    # Σ_t e[t+k] = c[T] − c[k];  Σ_t e[t] for t < T−k = c[T−k]
    axis = ((c[t] - c[k]) - c[t - k]) / np.maximum(t - k, 1)
    if nlags > t:  # degenerate window: extend at the mean rate
        rate = (e[-1] - e[0]) / max(t - 1, 1)
        axis = np.concatenate([axis, axis[-1] + rate * np.arange(1, nlags - t + 1)])
    return axis


def _decay_time(evals: np.ndarray, rho: np.ndarray, level: float = np.e**-1):
    below = np.nonzero(rho < level)[0]
    if len(below) == 0:
        return float(evals[-1])
    i = below[0]
    if i == 0:
        return float(evals[0])
    # linear interpolation between lag i-1 and i
    f = (rho[i - 1] - level) / (rho[i - 1] - rho[i])
    return float(evals[i - 1] + f * (evals[i] - evals[i - 1]))


def _result(name, evals, rho, total) -> ACResult:
    decay = _decay_time(evals, rho)
    return ACResult(
        name=name,
        grad_evals=evals,
        rho=rho,
        decay_evals=decay,
        total_grad_evals=total,
        censored=bool(decay >= evals[-1] * 0.999),
    )


def calculate_autocorrelation(
    dist: Distribution,
    sampler: str = "mjhmc",
    num_steps: int = 2000,
    nbatch: int = 256,
    nlags: int = 200,
    burn_steps: int = 500,
    seed: int = 0,
    use_cached_init: bool = True,
    engine: str = "torch",
    device="cuda",
    **sampler_kwargs,
) -> ACResult:
    """Run ``sampler`` on ``dist`` on ``device``; return the ρ-vs-grad-evals
    curve.

    ``engine="cuda"`` (MJHMC only) streams samples from the fused engine
    (``CudaMJHMC``; its plain version on the CPU) with the per-emission
    cumulative eval counters, for the same exact axis as the plain path.
    ``engine="torch"`` runs ``SAMPLERS[sampler]`` from the cached burned-in
    inits (or its own burn-in without ``use_cached_init``).
    """
    if engine not in ("torch", "cuda"):
        raise ValueError(f"unknown engine {engine!r} (torch or cuda)")
    if engine == "cuda":
        if sampler != "mjhmc":
            raise ValueError("the fused engine implements MJHMC only")
        from mjhmc_tpu_torch.ops.cuda_mjhmc import CudaMJHMC

        eng = CudaMJHMC(dist, nbatch=nbatch, seed=seed, device=device, **sampler_kwargs)
        eng.run(burn_steps)
        xs, ws, es = eng.sample(num_steps, return_evals=True)
        rho = weighted_autocorrelation(xs, ws, nlags=nlags).cpu().numpy()
        evals = _exact_evals_axis(es.double().mean(dim=1).cpu().numpy(), nlags)
        return _result("mjhmc[cuda]", evals, rho, eng.grad_evals)
    s = SAMPLERS[sampler](dist, nbatch=nbatch, seed=seed, device=device, **sampler_kwargs)
    if use_cached_init:
        x0 = burned_in_init(dist, nbatch, burn_steps=burn_steps, seed=seed + 1000,
                            device=s.device)
        if sampler == "pt":  # every rung starts at the shared init
            x0 = x0.expand(s.state.x.shape).contiguous()
        u, g = dist.potential_and_grad(x0)
        if sampler in ("nuts", "pt"):
            s.state = s.state._replace(x=x0, u=u, grad=g)
        else:
            s.state = s.state._replace(chain=s.state.chain._replace(x=x0, u=u, grad=g))
    else:
        s.burn_in(burn_steps)

    out = s.sample(num_steps)
    rho = weighted_autocorrelation(out["x"], out.get("dwell"), nlags=nlags).cpu().numpy()
    # exact cumulative-counter alignment (every ported sampler reports it)
    evals = _exact_evals_axis(out["evals_mean"].cpu().numpy(), nlags)
    return _result(sampler, evals, rho, s.grad_evals)
