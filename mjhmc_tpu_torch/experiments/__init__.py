"""Experiments and paper-figure reproduction (counterpart of
``mjhmc_tpu.experiments``): the autocorrelation-vs-gradient-evaluations
experiment (``autocorr_experiment``), the paper's figures (``figures``)
and its efficiency claim (``efficiency_claim``)."""

from mjhmc_tpu_torch.experiments.autocorr_experiment import calculate_autocorrelation

__all__ = ["calculate_autocorrelation"]
