"""The sampler dataclasses and the named benchmark presets (a copy of
``mjhmc_tpu.config``).

The dataclasses and presets are the same values as the JAX package's;
only ``make_distribution`` resolves to this package's model registry,
which holds every model the presets name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    epsilon: float = 1.0
    beta: float = 0.1
    num_leapfrog_steps: int = 5
    nbatch: int = 128
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MJHMCConfig(SamplerConfig):
    pass


@dataclasses.dataclass(frozen=True)
class ControlHMCConfig(SamplerConfig):
    beta: float = 0.2
    flip_on_reject: bool = True


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    epsilon: float = 1.0
    max_depth: int = 8
    nbatch: int = 128
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class BenchmarkConfig:
    """One named benchmark scenario (BASELINE.json configs 1-5)."""

    name: str
    distribution: str
    dist_kwargs: tuple  # ((key, value), ...) — hashable
    sampler: str
    nbatch: int
    epsilon: float
    beta: float
    num_leapfrog_steps: int
    description: str
    mesh_axes: Optional[tuple] = None

    def make_distribution(self):
        from mjhmc_tpu_torch.models import get_distribution

        return get_distribution(self.distribution, **dict(self.dist_kwargs))


BENCHMARK_CONFIGS = {
    "gauss2d": BenchmarkConfig(
        name="gauss2d",
        distribution="gaussian",
        dist_kwargs=(("ndims", 2), ("log_conditioning", 2.0)),
        sampler="mjhmc",
        nbatch=100,
        epsilon=1.0,
        beta=0.1,
        num_leapfrog_steps=5,
        description="2D anisotropic Gaussian, MJHMC vs control HMC, 100 chains",
    ),
    "rough_well": BenchmarkConfig(
        name="rough_well",
        distribution="rough_well",
        dist_kwargs=(("ndims", 2), ("scale1", 100.0), ("scale2", 4.0)),
        sampler="mjhmc",
        nbatch=10_000,
        epsilon=1.0,
        beta=0.1,
        num_leapfrog_steps=10,
        description="2D rough-well, 10k vmapped chains (≥1M leapfrog steps/s/chip)",
    ),
    "product_of_t": BenchmarkConfig(
        name="product_of_t",
        distribution="product_of_t",
        dist_kwargs=(("ndims", 36), ("nbasis", 36), ("nu", 2.5)),
        sampler="mjhmc",
        nbatch=4096,
        epsilon=0.2,
        beta=0.1,
        num_leapfrog_steps=5,
        description="Product-of-t heavy-tailed, MJHMC + NUTS, step-size adaptation",
    ),
    "gauss50d": BenchmarkConfig(
        name="gauss50d",
        distribution="gaussian",
        dist_kwargs=(("ndims", 50), ("log_conditioning", 4.0)),
        sampler="mjhmc",
        nbatch=4096,
        epsilon=0.1,
        beta=0.1,
        num_leapfrog_steps=10,
        description="50D ill-conditioned Gaussian, spectral-gap/autocorr diagnostics",
    ),
    "rough_well_a3": BenchmarkConfig(
        name="rough_well_a3",
        distribution="rough_well",
        dist_kwargs=(
            ("ndims", 2), ("scale1", 100.0), ("scale2", 4.0),
            ("amplitude", 3.0),
        ),
        sampler="mjhmc",
        nbatch=10_000,
        epsilon=4.0,
        beta=0.02,
        num_leapfrog_steps=10,
        description="2D rough-well at 3 kT ripple (barrier regime), ESS/s receipts row",
    ),
    "mog": BenchmarkConfig(
        name="mog",
        distribution="mog",
        dist_kwargs=(
            ("ndims", 1),
            ("means", ((-4.0,), (4.0,))),
            ("scales", (0.8, 0.8)),
            ("weights", (0.5, 0.5)),
        ),
        sampler="pt",
        nbatch=1024,
        epsilon=0.4,
        beta=1.0,
        num_leapfrog_steps=5,
        description="Two-mode Gaussian mixture (≈12.5 kT barrier), parallel tempering",
    ),
    "funnel": BenchmarkConfig(
        name="funnel",
        distribution="funnel",
        dist_kwargs=(("ndims", 10), ("sigma_v", 3.0)),
        sampler="mjhmc",
        nbatch=1024,
        epsilon=0.1,
        beta=0.15,
        num_leapfrog_steps=8,
        description="Neal's funnel 10-D, mass-matrix/warmup stress test",
    ),
    "banana": BenchmarkConfig(
        name="banana",
        distribution="banana",
        dist_kwargs=(("ndims", 2), ("a", 2.0), ("b", 0.4)),
        sampler="mjhmc",
        nbatch=2048,
        epsilon=0.25,
        beta=0.1,
        num_leapfrog_steps=8,
        description="Haario banana (twisted Gaussian), curved-ridge exploration",
    ),
    "eight_schools": BenchmarkConfig(
        name="eight_schools",
        distribution="eight_schools",
        dist_kwargs=(),
        sampler="mjhmc",
        nbatch=1024,
        epsilon=0.5,
        beta=0.1,
        num_leapfrog_steps=8,
        description="Rubin's eight schools (centered): funnel-on-real-data "
        "shrinkage target with exact quadrature moments",
    ),
    "logreg": BenchmarkConfig(
        name="logreg",
        distribution="logreg",
        dist_kwargs=(("ndims", 16), ("nobs", 256)),
        sampler="mjhmc",
        nbatch=2048,
        epsilon=0.15,
        beta=0.1,
        num_leapfrog_steps=6,
        description="Bayesian logistic regression posterior, Laplace-oracle checks",
    ),
    "sparse_coding": BenchmarkConfig(
        name="sparse_coding",
        distribution="sparse_coding",
        dist_kwargs=(("npixels", 64), ("nbasis", 128)),
        sampler="mjhmc",
        nbatch=8192,
        epsilon=0.02,
        beta=0.1,
        num_leapfrog_steps=10,
        description="Sparse-coding posterior, chains sharded over pod, SMC resampling",
        mesh_axes=("chains",),
    ),
}
