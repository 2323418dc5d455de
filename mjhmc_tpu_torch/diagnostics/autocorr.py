"""Autocorrelation / ESS diagnostics, dwell-weight aware, FFT-based
(counterpart of ``mjhmc_tpu.diagnostics.autocorr``, on ``torch.fft``).

Weighted autocovariance at lag τ (per chain, then averaged):

    γ(τ) = Σ_t w_t w_{t+τ} (x_t − μ)(x_{t+τ} − μ) / Σ_t w_t w_{t+τ}

with μ the dwell-weighted global mean. Numerator and denominator are both
autocorrelations, computed with one batched real FFT each.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _nfft(t: int) -> int:
    nfft = 1
    while nfft < 2 * t:
        nfft *= 2
    return nfft


def _autocorr_fft(a: Tensor, nlags: int) -> Tensor:
    """Σ_t a_t·a_{t+τ} for τ=0..nlags-1 via one FFT. a: (T, ...) time-leading."""
    nfft = _nfft(a.shape[0])
    fa = torch.fft.rfft(a, n=nfft, dim=0)
    corr = torch.fft.irfft(fa.abs() ** 2, n=nfft, dim=0)
    return corr[:nlags]


def weighted_autocorrelation(
    x: Tensor,
    w: Tensor | None = None,
    nlags: int | None = None,
    max_fft_bytes: int = 256 * 2**20,
) -> Tensor:
    """Dwell-weighted autocorrelation curve.

    ``x``: samples (T, ndims, nbatch), time-leading; ``w``: dwell weights
    (T, nbatch) or None for uniform; ``nlags`` defaults to T//2. Batches
    whose FFT workspace would pass ``max_fft_bytes`` are processed in chain
    chunks (the lag sums pool over chains, so chunking is exact).

    Returns (nlags,) autocorrelation averaged over dims and chains, ρ(0)=1.
    """
    t, ndims, nbatch = x.shape
    if nlags is None:
        nlags = t // 2
    if w is None:
        w = torch.ones((t, nbatch), dtype=x.dtype, device=x.device)

    # per-dim weighted mean (the weight sum is dim-independent)
    mu = (w[:, None, :] * x).sum(dim=(0, 2), keepdim=True) / w.sum().clamp(
        min=1e-30
    )

    chunk = max(1, min(nbatch, int(max_fft_bytes // (_nfft(t) * ndims * 8))))
    num = torch.zeros(nlags, dtype=torch.float32, device=x.device)
    den = torch.zeros(nlags, dtype=torch.float32, device=x.device)
    for i0 in range(0, nbatch, chunk):
        xs = x[:, :, i0 : i0 + chunk]
        ws = w[:, i0 : i0 + chunk]
        xc = (xs - mu) * ws[:, None, :]
        num = num + _autocorr_fft(xc, nlags).sum(dim=(1, 2))
        # Σ_t w_t w_{t+τ}: identical for every dim — computed per chain only
        den = den + _autocorr_fft(ws, nlags).sum(dim=1)

    gamma = num / (ndims * den).clamp(min=1e-30)
    return gamma / gamma[0]


def autocorrelation(x: Tensor, nlags: int | None = None) -> Tensor:
    """Unweighted autocorrelation (control HMC / NUTS path)."""
    return weighted_autocorrelation(x, None, nlags)


def effective_sample_size(x: Tensor, w: Tensor | None = None) -> Tensor:
    """ESS via Geyer's initial-positive-sequence estimator on ρ(τ).

    Returns a scalar: total effective samples across all chains.
    """
    t, _, nbatch = x.shape
    rho = weighted_autocorrelation(x, w, nlags=t // 2)
    # Geyer: sum consecutive pairs ρ(2k)+ρ(2k+1) while positive
    npairs = rho.shape[0] // 2
    pair = rho[: 2 * npairs].reshape(npairs, 2).sum(dim=1)
    positive = torch.cumprod((pair > 0.0).to(rho.dtype), dim=0)
    tau = (-1.0 + 2.0 * (pair * positive).sum()).clamp(min=1.0)
    return (t * nbatch) / tau


def autocorrelation_vs_grad_evals(
    x: Tensor,
    grad_evals_per_step: float,
    w: Tensor | None = None,
    nlags: int | None = None,
):
    """The paper's fairness curve: ρ against cumulative grad evals.

    Returns (evals, rho) with evals[i] = i · grad_evals_per_step.
    """
    rho = weighted_autocorrelation(x, w, nlags)
    lags = torch.arange(rho.shape[0], dtype=torch.float32, device=rho.device)
    return lags * grad_evals_per_step, rho
