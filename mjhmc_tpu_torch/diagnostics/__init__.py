"""Diagnostics ported so far: weighted autocorrelation and ESS."""

from mjhmc_tpu_torch.diagnostics.autocorr import (
    autocorrelation,
    autocorrelation_vs_grad_evals,
    effective_sample_size,
    weighted_autocorrelation,
)

__all__ = [
    "weighted_autocorrelation",
    "autocorrelation",
    "effective_sample_size",
    "autocorrelation_vs_grad_evals",
]
