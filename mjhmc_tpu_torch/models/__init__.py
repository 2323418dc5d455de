"""Benchmark distributions ported so far: the rough well and the Gaussian."""

from mjhmc_tpu_torch.models.base import (
    Distribution,
    get_distribution,
    register,
    registry,
)
from mjhmc_tpu_torch.models.gaussian import Gaussian
from mjhmc_tpu_torch.models.rough_well import RoughWell

__all__ = [
    "Distribution",
    "get_distribution",
    "register",
    "registry",
    "Gaussian",
    "RoughWell",
]
