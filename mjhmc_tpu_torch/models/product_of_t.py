"""Product of Student-t experts — the heavy-tailed benchmark (config 3;
counterpart of ``mjhmc_tpu.models.product_of_t``).

    U(x) = Σᵢ (ν+1)/2 · log(1 + yᵢ²/ν),   y = Wᵀx

over a fixed random basis W. The basis comes from the same seeded NumPy
draw and SVD as the JAX package's, so W is identical in both.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution, randn, register

Tensor = torch.Tensor


@register("product_of_t")
@dataclasses.dataclass(frozen=True)
class ProductOfT(Distribution):
    """Heavy-tailed product of Student-t experts over a fixed random basis:
    a random rotation with log-spaced singular values."""

    ndims: int = 36
    nbasis: int = 36
    nu: float = 2.5
    basis_seed: int = 0
    basis_conditioning: float = 1.0  # log10 spread of singular values

    @functools.cached_property
    def _basis(self) -> np.ndarray:
        """W: (ndims, nbasis), float64 as NumPy makes it."""
        rng = np.random.default_rng(self.basis_seed)
        a = rng.standard_normal((self.ndims, self.nbasis))
        u, _, vt = np.linalg.svd(a, full_matrices=False)
        k = min(self.ndims, self.nbasis)
        s = 10.0 ** np.linspace(0.0, self.basis_conditioning, k)
        return (u * s) @ vt

    def basis(self, device="cpu") -> Tensor:
        """W as a float32 tensor on ``device``."""
        return self.constant("basis", lambda: self._basis.astype(np.float32), device)

    def _y(self, x: Tensor):
        w = self.basis(x.device)
        return w, torch.matmul(w.T, x)  # (..., nbasis, nbatch)

    def potential(self, x: Tensor) -> Tensor:
        _, y = self._y(x)
        return 0.5 * (self.nu + 1.0) * torch.log1p(y * y / self.nu).sum(dim=-2)

    def potential_and_grad(self, x: Tensor):
        w, y = self._y(x)
        nu = self.nu
        u = 0.5 * (nu + 1.0) * torch.log1p(y * y / nu).sum(dim=-2)
        # dU/dy_i = (nu+1) y_i / (nu + y_i²);  dU/dx = W dU/dy
        dudy = (nu + 1.0) * y / (nu + y * y)
        return u, torch.matmul(w, dudy)

    def init_x(self, generator: torch.Generator, nbatch: int,
               device="cpu") -> Tensor:
        # a normal scaled up to cover the heavy tails a bit
        return 2.0 * randn(generator, (self.ndims, nbatch), device)

    def analytic_mean(self):
        return torch.zeros(self.ndims, dtype=torch.float32)

    def analytic_var(self):
        """Exact covariance diagonal when W is square and ν > 2: y = Wᵀx are
        independent unit-scale Student-t(ν) with variance ν/(ν−2), so
        cov(x) = W⁻ᵀ diag(ν/(ν−2)) W⁻¹."""
        if self.ndims != self.nbasis or self.nu <= 2.0:
            return None
        winv = np.linalg.inv(self._basis.astype(np.float64))
        vy = self.nu / (self.nu - 2.0)
        cov = winv.T @ (vy * np.eye(self.ndims)) @ winv
        return torch.as_tensor(np.diag(cov).astype(np.float32))
