"""Twisted-Gaussian "banana" — the curved-ridge benchmark (counterpart of
``mjhmc_tpu.models.banana``).

The Haario et al. (1999) banana, an exact pushforward of a Gaussian, so
every moment is closed-form and exact initial draws are one transform:

    x₁ ~ N(0, a²),   x₂ | x₁ ~ N(b·(x₁² − a²), 1),   xᵢ ~ N(0,1) for i ≥ 3

    U(x) = x₁²/(2a²) + ½·(x₂ − b(x₁² − a²))² + ½·Σ_{i≥3} xᵢ²
"""

from __future__ import annotations

import dataclasses

import torch

from mjhmc_tpu_torch.models.base import Distribution, randn, register

Tensor = torch.Tensor


@register("banana")
@dataclasses.dataclass(frozen=True)
class Banana(Distribution):
    """Haario banana: ``a`` sets the ridge length, ``b`` its curvature."""

    ndims: int = 2
    a: float = 2.0
    b: float = 0.4

    def _parts(self, x: Tensor):
        x1 = x[..., 0, :]
        x2 = x[..., 1, :]
        return x1, x2 - self.b * (x1 * x1 - self.a**2)

    def potential(self, x: Tensor) -> Tensor:
        x1, r = self._parts(x)
        u = 0.5 * x1 * x1 / (self.a**2) + 0.5 * r * r
        if self.ndims > 2:
            u = u + 0.5 * (x[..., 2:, :] ** 2).sum(dim=-2)
        return u

    def potential_and_grad(self, x: Tensor):
        x1, r = self._parts(x)
        u = 0.5 * x1 * x1 / (self.a**2) + 0.5 * r * r
        g1 = x1 / (self.a**2) - 2.0 * self.b * x1 * r
        parts = [g1[..., None, :], r[..., None, :]]
        if self.ndims > 2:
            tail = x[..., 2:, :]
            u = u + 0.5 * (tail * tail).sum(dim=-2)
            parts.append(tail)
        return u, torch.cat(parts, dim=-2)

    def init_x(self, generator: torch.Generator, nbatch: int, device="cpu") -> Tensor:
        """Exact draws via the defining pushforward."""
        z = randn(generator, (self.ndims, nbatch), device)
        x1 = self.a * z[0]
        x2 = z[1] + self.b * (x1 * x1 - self.a**2)
        return torch.cat([x1[None], x2[None], z[2:]], dim=0)

    def analytic_mean(self) -> Tensor:
        return torch.zeros(self.ndims, dtype=torch.float32)

    def analytic_var(self) -> Tensor:
        """Var[x₁] = a²; Var[x₂] = 1 + b²·Var[x₁²] = 1 + 2b²a⁴."""
        v2 = 1.0 + 2.0 * self.b**2 * self.a**4
        return torch.tensor([self.a**2, v2] + [1.0] * (self.ndims - 2), dtype=torch.float32)
