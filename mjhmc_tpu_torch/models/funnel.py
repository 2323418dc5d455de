"""Neal's funnel — the varying-curvature benchmark (counterpart of
``mjhmc_tpu.models.funnel``).

The stress test for step-size adaptation and mass-matrix preconditioning
(Neal 2003, "Slice sampling", §8): one global scale ``v`` sets the variance
of every other coordinate, so the curvature varies by orders of magnitude
across the support. Exact marginals make it a closed-form oracle:

    v ~ N(0, σ_v²),   x_i | v ~ N(0, eᵛ)   for i = 1..d-1

    U(x) = v²/(2σ_v²) + (d−1)/2 · v + e⁻ᵛ/2 · Σᵢ xᵢ²
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mjhmc_tpu_torch.models.base import Distribution, randn, register

Tensor = torch.Tensor


@register("funnel")
@dataclasses.dataclass(frozen=True)
class Funnel(Distribution):
    """Coordinate 0 is the log-scale ``v``, the remaining ``ndims − 1``
    coordinates are N(0, eᵛ)."""

    ndims: int = 10
    sigma_v: float = 3.0

    def potential(self, x: Tensor) -> Tensor:
        v = x[..., 0, :]
        z2 = (x[..., 1:, :] ** 2).sum(dim=-2)
        d1 = self.ndims - 1
        return 0.5 * v * v / (self.sigma_v**2) + 0.5 * d1 * v + 0.5 * torch.exp(-v) * z2

    def potential_and_grad(self, x: Tensor):
        v = x[..., 0, :]
        z = x[..., 1:, :]
        z2 = (z * z).sum(dim=-2)
        e = torch.exp(-v)
        d1 = self.ndims - 1
        u = 0.5 * v * v / (self.sigma_v**2) + 0.5 * d1 * v + 0.5 * e * z2
        gv = v / (self.sigma_v**2) + 0.5 * d1 - 0.5 * e * z2
        gz = e[..., None, :] * z
        return u, torch.cat([gv[..., None, :], gz], dim=-2)

    def init_x(self, generator: torch.Generator, nbatch: int, device="cpu") -> Tensor:
        """Exact draws: v first, then x_i = e^{v/2}·N(0,1)."""
        v = self.sigma_v * randn(generator, (1, nbatch), device)
        z = torch.exp(0.5 * v) * randn(generator, (self.ndims - 1, nbatch), device)
        return torch.cat([v, z], dim=0)

    def analytic_mean(self) -> Tensor:
        return torch.zeros(self.ndims, dtype=torch.float32)

    def analytic_var(self) -> Tensor:
        """Var[v] = σ_v²; Var[x_i] = E[eᵛ] = exp(σ_v²/2)."""
        vz = math.exp(0.5 * self.sigma_v**2)
        return torch.tensor([self.sigma_v**2] + [vz] * (self.ndims - 1), dtype=torch.float32)
