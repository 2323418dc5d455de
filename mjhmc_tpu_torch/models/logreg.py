"""Bayesian logistic regression — the real-inference benchmark
(counterpart of ``mjhmc_tpu.models.logreg``).

    U(θ) = Σ_o softplus(−s_o·(Xθ)_o) + ‖θ‖²/(2σ₀²),   s_o ∈ {−1, +1}

The design matrix and labels come from the same seeded NumPy code as the
JAX package's, so X and s are identical in both. The posterior is
log-concave: ``map_estimate()`` / ``laplace_var()`` (NumPy float64) give
the Laplace-approximation oracle the tests hold variances to.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution, randn, register

Tensor = torch.Tensor


def softplus(z: Tensor) -> Tensor:
    """Stable softplus: max(z, 0) + log1p(exp(−|z|))."""
    return z.clamp(min=0.0) + torch.log1p(torch.exp(-z.abs()))


@register("logreg")
@dataclasses.dataclass(frozen=True)
class LogisticRegression(Distribution):
    """Synthetic-data Bayesian logistic regression posterior."""

    ndims: int = 16  # number of features / weights
    nobs: int = 256
    prior_scale: float = 5.0
    data_seed: int = 0

    @functools.cached_property
    def _data(self) -> tuple[np.ndarray, np.ndarray]:
        """(X: (nobs, ndims), s: (nobs,) in {−1,+1}) from a seeded RNG."""
        rng = np.random.default_rng(self.data_seed)
        xmat = rng.standard_normal((self.nobs, self.ndims)).astype(np.float32)
        xmat /= np.sqrt(self.ndims)
        theta_true = 2.0 * rng.standard_normal(self.ndims)
        p = 1.0 / (1.0 + np.exp(-(xmat @ theta_true)))
        s = np.where(rng.uniform(size=self.nobs) < p, 1.0, -1.0)
        return xmat, s.astype(np.float32)

    def _z(self, x: Tensor):
        """(s, z = −s·Xθ): the signs and the softplus arguments, (..., nobs, nbatch)."""
        xmat = self.constant("xmat", lambda: self._data[0], x.device)
        s = self.constant("s", lambda: self._data[1], x.device)[:, None]
        return xmat, s, -s * torch.matmul(xmat, x)

    def _prior(self, x: Tensor) -> Tensor:
        return 0.5 * (x * x).sum(dim=-2) / (self.prior_scale**2)

    def potential(self, x: Tensor) -> Tensor:
        _, _, z = self._z(x)
        return softplus(z).sum(dim=-2) + self._prior(x)

    def potential_and_grad(self, x: Tensor):
        xmat, s, z = self._z(x)
        u = softplus(z).sum(dim=-2) + self._prior(x)
        # d softplus(z)/d logits = −s·sigmoid(z)
        dl = -s * torch.sigmoid(z)
        return u, torch.matmul(xmat.T, dl) + x / (self.prior_scale**2)

    def init_x(self, generator: torch.Generator, nbatch: int,
               device="cpu") -> Tensor:
        return randn(generator, (self.ndims, nbatch), device)

    # ------------------------------------------------------ Laplace oracle
    def map_estimate(self, iters: int = 30) -> np.ndarray:
        """MAP via damped Newton on the host, float64."""
        xmat = self._data[0].astype(np.float64)
        s = self._data[1].astype(np.float64)
        lam = 1.0 / self.prior_scale**2
        theta = np.zeros(self.ndims)
        for _ in range(iters):
            logits = xmat @ theta
            p = 1.0 / (1.0 + np.exp(s * logits))  # sigmoid(−s·logits)
            grad = -(xmat.T @ (s * p)) + lam * theta
            w = p * (1.0 - p)
            hess = (xmat.T * w) @ xmat + lam * np.eye(self.ndims)
            step = np.linalg.solve(hess, grad)
            theta = theta - step
            if np.max(np.abs(step)) < 1e-12:
                break
        return theta

    def laplace_var(self) -> np.ndarray:
        """Diagonal of the inverse Hessian at the MAP: an approximate
        posterior-variance oracle (log-concave target)."""
        xmat = self._data[0].astype(np.float64)
        s = self._data[1].astype(np.float64)
        lam = 1.0 / self.prior_scale**2
        theta = self.map_estimate()
        logits = xmat @ theta
        p = 1.0 / (1.0 + np.exp(s * logits))
        w = p * (1.0 - p)
        hess = (xmat.T * w) @ xmat + lam * np.eye(self.ndims)
        return np.diag(np.linalg.inv(hess))
