"""Spectral-gap diagnostics (counterpart of ``mjhmc_tpu.diagnostics.spectral``).

The matrix gaps are small dense eigendecompositions of ladder transition
and rate matrices (2K×2K, K ~ tens): a NumPy copy of the JAX package's,
on the host. ``empirical_spectral_gap`` estimates the gap from sampled
chains with the port's ``weighted_autocorrelation``, on the samples'
device.
"""

from __future__ import annotations

import numpy as np

from mjhmc_tpu_torch.diagnostics.autocorr import weighted_autocorrelation


def stationary_distribution(mat: np.ndarray, continuous: bool) -> np.ndarray:
    """Stationary law of a column-stochastic matrix (discrete) or
    column-generator (continuous): the eigenvector at λ=1 / λ=0."""
    w, v = np.linalg.eig(mat)
    target = 0.0 if continuous else 1.0
    i = int(np.argmin(np.abs(w - target)))
    pi = np.real(v[:, i])
    pi = np.abs(pi)
    return pi / pi.sum()


def spectral_gap_discrete(t: np.ndarray) -> float:
    """1 − |λ₂| of a column-stochastic transition matrix."""
    w = np.linalg.eigvals(t)
    mod = np.sort(np.abs(w))[::-1]
    return float(1.0 - mod[1])


def spectral_gap_continuous(a: np.ndarray) -> float:
    """Second-smallest |Re λ| of a generator (smallest is 0)."""
    w = np.linalg.eigvals(a)
    re = np.sort(np.abs(np.real(w)))
    return float(re[1])


def empirical_spectral_gap(x, w=None, nlags: int | None = None) -> float:
    """Estimate of 1 − λ₂ from sampled chains (BASELINE config 4: spectral
    diagnostics without an explicit transition matrix).

    For a reversible chain, the lag-autocorrelation of any observable decays
    as λ₂^τ; fitting log ρ(τ) over the initial positive lags of the slowest
    dim gives λ₂, hence the gap. ``x``: (T, ndims, nbatch) tensor; ``w``
    optional dwell weights (T, nbatch).
    """
    t = x.shape[0]
    if nlags is None:
        nlags = min(50, t // 4)
    # slowest dim: the per-dim autocorrelation with the largest |ρ(1)|
    rhos = [weighted_autocorrelation(x[:, d : d + 1, :], w, nlags).cpu().numpy()
            for d in range(x.shape[1])]
    rho = rhos[int(np.argmax([abs(r[1]) for r in rhos]))]
    pos = rho > 0.05
    k = int(np.argmin(pos)) if not pos.all() else len(rho)
    k = max(k, 3)
    taus = np.arange(1, k)
    lam2 = np.exp(np.polyfit(taus, np.log(np.maximum(rho[1:k], 1e-8)), 1)[0])
    return float(1.0 - lam2)
