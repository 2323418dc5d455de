"""Diagnostics: weighted autocorrelation, ESS, split-R̂, spectral gaps."""

from mjhmc_tpu_torch.diagnostics.autocorr import (
    autocorrelation,
    autocorrelation_vs_grad_evals,
    effective_sample_size,
    weighted_autocorrelation,
)
from mjhmc_tpu_torch.diagnostics.rhat import potential_scale_reduction
from mjhmc_tpu_torch.diagnostics.spectral import (
    empirical_spectral_gap,
    spectral_gap_continuous,
    spectral_gap_discrete,
    stationary_distribution,
)

__all__ = [
    "empirical_spectral_gap",
    "weighted_autocorrelation",
    "autocorrelation",
    "effective_sample_size",
    "autocorrelation_vs_grad_evals",
    "potential_scale_reduction",
    "spectral_gap_discrete",
    "spectral_gap_continuous",
    "stationary_distribution",
]
