"""Rough well — the paper's headline benchmark distribution
(counterpart of ``mjhmc_tpu.models.rough_well``).

    U(x) = Σᵢ [ xᵢ²/(2·scale1²) + amplitude·cos(xᵢ/scale2) ]

The marginal is 1-D and numerically integrable, so quadrature moments serve
as a test oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution, randn, register

Tensor = torch.Tensor


@register("rough_well")
@dataclasses.dataclass(frozen=True)
class RoughWell(Distribution):
    """``amplitude`` scales the ripple height (reference spec: 1.0)."""

    ndims: int = 2
    scale1: float = 100.0
    scale2: float = 4.0
    amplitude: float = 1.0

    def potential(self, x: Tensor) -> Tensor:
        s1, s2 = self.scale1, self.scale2
        return (x * x).sum(dim=-2) / (2.0 * s1 * s1) + self.amplitude * torch.cos(
            x / s2
        ).sum(dim=-2)

    def potential_and_grad(self, x: Tensor):
        s1, s2 = self.scale1, self.scale2
        inv_s1sq = 1.0 / (s1 * s1)
        c = torch.cos(x / s2)
        u = 0.5 * inv_s1sq * (x * x).sum(dim=-2) + self.amplitude * c.sum(dim=-2)
        g = x * inv_s1sq - self.amplitude * torch.sin(x / s2) / s2
        return u, g

    def init_x(self, generator: torch.Generator, nbatch: int,
               device="cpu") -> Tensor:
        return self.scale1 * randn(generator, (self.ndims, nbatch), device)

    def analytic_mean(self):
        return torch.zeros(self.ndims, dtype=torch.float32)

    def analytic_var(self):
        """Marginal variance by 1-D quadrature (host-side, NumPy)."""
        s1, s2 = self.scale1, self.scale2
        xs = np.linspace(-8 * s1, 8 * s1, 200_001)
        u = xs**2 / (2 * s1**2) + self.amplitude * np.cos(xs / s2)
        w = np.exp(-(u - u.min()))
        var = np.sum(w * xs**2) / np.sum(w)
        return torch.full((self.ndims,), float(np.float32(var)), dtype=torch.float32)
