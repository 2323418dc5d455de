"""Benchmark distributions: the rough well, the Gaussian, the product of
Student-t experts, the sparse-coding posterior, Bayesian logistic
regression, and the zoo models (Neal's funnel, the Haario banana, the
Gaussian mixture and the eight-schools posterior)."""

from mjhmc_tpu_torch.models.base import (
    Distribution,
    get_distribution,
    register,
    registry,
)
from mjhmc_tpu_torch.models.banana import Banana
from mjhmc_tpu_torch.models.eight_schools import EightSchools
from mjhmc_tpu_torch.models.funnel import Funnel
from mjhmc_tpu_torch.models.gaussian import Gaussian
from mjhmc_tpu_torch.models.logreg import LogisticRegression
from mjhmc_tpu_torch.models.mog import GaussianMixture
from mjhmc_tpu_torch.models.product_of_t import ProductOfT
from mjhmc_tpu_torch.models.rough_well import RoughWell
from mjhmc_tpu_torch.models.sparse_coding import SparseCoding

__all__ = [
    "Distribution",
    "get_distribution",
    "register",
    "registry",
    "Banana",
    "EightSchools",
    "Funnel",
    "Gaussian",
    "GaussianMixture",
    "LogisticRegression",
    "ProductOfT",
    "RoughWell",
    "SparseCoding",
]
