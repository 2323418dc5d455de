"""Benchmark distributions ported so far: the rough well, the Gaussian, the
product of Student-t experts, the sparse-coding posterior and Bayesian
logistic regression."""

from mjhmc_tpu_torch.models.base import (
    Distribution,
    get_distribution,
    register,
    registry,
)
from mjhmc_tpu_torch.models.gaussian import Gaussian
from mjhmc_tpu_torch.models.logreg import LogisticRegression
from mjhmc_tpu_torch.models.product_of_t import ProductOfT
from mjhmc_tpu_torch.models.rough_well import RoughWell
from mjhmc_tpu_torch.models.sparse_coding import SparseCoding

__all__ = [
    "Distribution",
    "get_distribution",
    "register",
    "registry",
    "Gaussian",
    "LogisticRegression",
    "ProductOfT",
    "RoughWell",
    "SparseCoding",
]
