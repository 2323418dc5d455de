"""Anisotropic / ill-conditioned diagonal Gaussian (counterpart of
``mjhmc_tpu.models.gaussian``): the 2-D anisotropic benchmark (config 1)
and the 50-D ill-conditioned one (config 4). Analytic moments make it the
primary stationarity oracle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution, randn, register

Tensor = torch.Tensor


@register("gaussian")
@dataclasses.dataclass(frozen=True)
class Gaussian(Distribution):
    """U(x) = ½ Σᵢ xᵢ²/σᵢ² with ``σᵢ² = 10^(log_conditioning · i/(ndims-1))``."""

    ndims: int = 2
    log_conditioning: float = 2.0

    @property
    def variances(self) -> np.ndarray:
        if self.ndims == 1:
            return np.ones(1, np.float32)
        expo = np.linspace(0.0, self.log_conditioning, self.ndims)
        return (10.0 ** expo).astype(np.float32)

    def _prec(self, like: Tensor) -> Tensor:
        # (ndims, 1) inverse variances, broadcast over the chain axis
        return torch.as_tensor(1.0 / self.variances, device=like.device)[:, None]

    def potential(self, x: Tensor) -> Tensor:
        return 0.5 * (x * x * self._prec(x)).sum(dim=-2)

    def potential_and_grad(self, x: Tensor):
        g = x * self._prec(x)
        return 0.5 * (x * g).sum(dim=-2), g

    def init_x(self, generator: torch.Generator, nbatch: int,
               device="cpu") -> Tensor:
        std = torch.sqrt(torch.as_tensor(self.variances, device=device))[:, None]
        return std * randn(generator, (self.ndims, nbatch), device)

    def analytic_mean(self):
        return torch.zeros(self.ndims, dtype=torch.float32)

    def analytic_var(self):
        return torch.as_tensor(self.variances)
