"""ADVI head, plain PyTorch (counterpart of ``mjhmc_tpu.inference.vi``):
Gaussian variational inference with reparameterised gradients, optimised
with ``torch.optim.Adam`` (optax's Adam in the JAX package), over any
``Distribution``. Two families:

- mean-field: q = N(μ, diag(e^{2ω}))  (``rank=0``, the default);
- low-rank-plus-diagonal: q = N(μ, D² + BBᵀ), D = diag(e^ω), B
  (ndims × rank); ``rank=ndims`` is full rank. The entropy uses the
  matrix determinant lemma, O(ndims·rank² + rank³).

Monte-Carlo draws ride the chain axis, (ndims, n_mc), so one ELBO
evaluation is one batched energy call. The ELBO's gradient reaches the
model through its analytic ``potential_and_grad`` (``logdensity`` below),
the gradient the samplers use, never autograd through the model's
forward.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution, randn
from mjhmc_tpu_torch.samplers.state import checked_device

Tensor = torch.Tensor

#: log(2πe) in float32, as the JAX package forms it
_LOG_2PIE = float(np.log(np.float32(2.0 * np.pi * np.e)))


class _AnalyticPotential(torch.autograd.Function):
    """U(x) whose backward is the model's analytic dU/dx."""

    @staticmethod
    def forward(ctx, x, dist):
        u, g = dist.potential_and_grad(x.detach())
        ctx.save_for_backward(g)
        return u

    @staticmethod
    def backward(ctx, du):
        (g,) = ctx.saved_tensors
        return du.unsqueeze(-2) * g, None


def logdensity(dist: Distribution, x: Tensor) -> Tensor:
    """log p(x) up to a constant, −U(x), differentiable through the
    model's ``potential_and_grad``."""
    return -_AnalyticPotential.apply(x, dist)


class ADVIParams(NamedTuple):
    mu: Tensor  # (ndims,)
    omega: Tensor  # (ndims,) log standard deviations


class LowRankADVIParams(NamedTuple):
    mu: Tensor  # (ndims,)
    omega: Tensor  # (ndims,) log diagonal standard deviations
    b: Tensor  # (ndims, rank) low-rank covariance factor


def advi_init(dist: Distribution, init_scale: float = 0.1, device="cpu") -> ADVIParams:
    d = dist.ndims
    return ADVIParams(
        mu=torch.zeros(d, dtype=torch.float32, device=device),
        omega=torch.full((d,), float(np.log(np.float32(init_scale))), dtype=torch.float32,
                         device=device),
    )


def lowrank_advi_init(dist: Distribution, rank: int, init_scale: float = 0.1,
                      device="cpu") -> LowRankADVIParams:
    mf = advi_init(dist, init_scale, device)
    # B starts at 0: exactly mean-field
    return LowRankADVIParams(mu=mf.mu, omega=mf.omega,
                             b=torch.zeros((dist.ndims, rank), dtype=torch.float32,
                                           device=device))


def sample_q(params: ADVIParams, generator: torch.Generator | None, n: int,
             xi: Tensor | None = None) -> Tensor:
    """n draws of q = N(μ, diag(e^{2ω})), shape (ndims, n); ``xi``
    (ndims, n) injects the N(0, I) draw."""
    if xi is None:
        xi = randn(generator, (params.mu.shape[0], n), params.mu.device)
    return params.mu[:, None] + torch.exp(params.omega)[:, None] * xi


def sample_q_lowrank(params: LowRankADVIParams, generator: torch.Generator | None, n: int,
                     xi: Tensor | None = None, xi2: Tensor | None = None) -> Tensor:
    """z = μ + D ξ₁ + B ξ₂ ~ N(μ, D² + BBᵀ), shape (ndims, n); ``xi``
    (ndims, n) and ``xi2`` (rank, n) inject ξ₁ and ξ₂."""
    d, r = params.b.shape
    dev = params.mu.device
    if xi is None:
        xi = randn(generator, (d, n), dev)
    if xi2 is None:
        xi2 = randn(generator, (r, n), dev)
    return params.mu[:, None] + torch.exp(params.omega)[:, None] * xi + params.b @ xi2


def elbo(dist: Distribution, params: ADVIParams, generator: torch.Generator | None,
         n_mc: int, xi: Tensor | None = None) -> Tensor:
    """Reparameterised ELBO estimate: E_q[log p] + H(q)."""
    z = sample_q(params, generator, n_mc, xi)
    entropy = params.omega.sum() + 0.5 * params.mu.shape[0] * _LOG_2PIE
    return logdensity(dist, z).mean() + entropy


def lowrank_entropy(params: LowRankADVIParams) -> Tensor:
    """H(q) = ½ logdet(2πe (D² + BBᵀ)) by the determinant lemma:
    logdet = 2Σω + logdet(I_r + Bᵀ D⁻² B)."""
    d, r = params.b.shape
    dinv_b = params.b * torch.exp(-params.omega)[:, None]  # D⁻¹B
    small = torch.eye(r, dtype=torch.float32, device=params.b.device) + dinv_b.T @ dinv_b
    _, logdet_small = torch.linalg.slogdet(small)
    logdet = 2.0 * params.omega.sum() + logdet_small
    return 0.5 * logdet + 0.5 * d * _LOG_2PIE


def elbo_lowrank(dist: Distribution, params: LowRankADVIParams,
                 generator: torch.Generator | None, n_mc: int, xi: Tensor | None = None,
                 xi2: Tensor | None = None) -> Tensor:
    z = sample_q_lowrank(params, generator, n_mc, xi, xi2)
    return logdensity(dist, z).mean() + lowrank_entropy(params)


def q_covariance(params) -> Tensor:
    """Dense covariance of the fitted q (diagnostics, tests)."""
    dvar = torch.exp(2.0 * params.omega)
    if isinstance(params, LowRankADVIParams):
        return torch.diag(dvar) + params.b @ params.b.T
    return torch.diag(dvar)


def advi_fit(
    dist: Distribution,
    generator: torch.Generator | None,
    num_steps: int = 2000,
    n_mc: int = 64,
    learning_rate: float = 0.05,
    init_scale: float = 0.1,
    rank: int = 0,
    device="cuda",
    xi: Tensor | None = None,
    xi2: Tensor | None = None,
) -> Tuple[ADVIParams, Tensor]:
    """Run ADVI; returns (params, elbo_trace (num_steps,)), on ``device``
    (the card unless ``device="cpu"`` is asked for).

    ``rank=0``: mean-field; ``rank>0``: low-rank-plus-diagonal covariance
    (``rank=dist.ndims`` is full rank). ``xi`` (num_steps, ndims, n_mc)
    and, low-rank, ``xi2`` (num_steps, rank, n_mc) inject each step's
    draws. The trace stays on the device: the loop reads nothing back.
    """
    device = checked_device(device, "advi_fit")
    if rank > 0:
        params = lowrank_advi_init(dist, rank, init_scale, device)
    else:
        params = advi_init(dist, init_scale, device)
    for p in params:
        p.requires_grad_(True)
    opt = torch.optim.Adam(list(params), lr=learning_rate, eps=1e-8)
    elbos = []
    for t in range(num_steps):
        x1 = None if xi is None else xi[t]
        if rank > 0:
            e = elbo_lowrank(dist, params, generator, n_mc, x1, None if xi2 is None else xi2[t])
        else:
            e = elbo(dist, params, generator, n_mc, x1)
        opt.zero_grad(set_to_none=True)
        (-e).backward()
        opt.step()
        elbos.append(e.detach())
    return type(params)(*(p.detach() for p in params)), torch.stack(elbos)


@dataclasses.dataclass
class ADVI:
    """Convenience wrapper mirroring the sampler class API; runs on the
    card unless ``device="cpu"`` is asked for, its draws from a generator
    on that device."""

    distribution: Distribution
    num_steps: int = 2000
    n_mc: int = 64
    learning_rate: float = 0.05
    seed: int = 0
    rank: int = 0  # 0 = mean-field; ndims = full-rank
    device: str = "cuda"

    def __post_init__(self):
        self.device = checked_device(self.device, type(self).__name__)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def fit(self) -> Tuple[ADVIParams, Tensor]:
        self.params, self.elbo_trace = advi_fit(
            self.distribution, self._generator(self.seed), self.num_steps, self.n_mc,
            self.learning_rate, rank=self.rank, device=self.device)
        return self.params, self.elbo_trace

    def sample(self, n: int, seed: int = 1) -> Tensor:
        if isinstance(self.params, LowRankADVIParams):
            return sample_q_lowrank(self.params, self._generator(seed), n)
        return sample_q(self.params, self._generator(seed), n)

    def covariance(self) -> Tensor:
        return q_covariance(self.params)
