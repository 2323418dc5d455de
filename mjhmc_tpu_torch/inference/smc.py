"""Systematic resampling (the piece of ``mjhmc_tpu.inference.smc`` that
``parallel.collectives`` needs; the SMC sampler itself is still to come).

The uniform offset ``u0`` ~ U(0, 1/n) is an input, so a test can hand
both packages the same draw.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def resample_positions(log_w: Tensor, u0, slots: Tensor) -> tuple:
    """(cdf, pos): the normalised weights' CDF over all n particles and the
    positions u0 + slot/n of the output ``slots``, in float32 as JAX forms
    them."""
    n = log_w.shape[0]
    lw = log_w - torch.logsumexp(log_w, 0)
    cdf = torch.cumsum(torch.exp(lw), 0)
    u0 = torch.as_tensor(u0, dtype=torch.float32, device=log_w.device)
    return cdf, u0 + slots.to(torch.float32) / n


def systematic_resample(x: Tensor, log_w: Tensor, u0) -> Tensor:
    """Systematic resampling: (d, n) particles by global weight inversion."""
    n = log_w.shape[0]
    cdf, pos = resample_positions(log_w, u0, torch.arange(n, device=log_w.device))
    ancestors = torch.searchsorted(cdf, pos).clamp(0, n - 1)
    return x[:, ancestors]
