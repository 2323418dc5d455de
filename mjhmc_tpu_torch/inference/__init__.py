"""Inference heads: so far the systematic resampling of ``smc``."""

from mjhmc_tpu_torch.inference.smc import systematic_resample

__all__ = ["systematic_resample"]
