"""Experiments ported so far: the autocorrelation-vs-gradient-evaluations
experiment."""

from mjhmc_tpu_torch.experiments.autocorr_experiment import calculate_autocorrelation

__all__ = ["calculate_autocorrelation"]
