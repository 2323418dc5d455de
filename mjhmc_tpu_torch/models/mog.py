"""Mixture-of-Gaussians energy — the multimodal benchmark (counterpart of
``mjhmc_tpu.models.mog``).

A K-component isotropic Gaussian mixture whose well-separated modes defeat
single-temperature HMC and MJHMC; exact mixture moments make it a
closed-form oracle:

    U(x) = −log Σₖ wₖ (2πσₖ²)^(−d/2) exp(−‖x−μₖ‖²/(2σₖ²))

The component reduction runs on an axis inserted before the state axis,
so the chain axis stays last.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution, randn, register

Tensor = torch.Tensor


@register("mog")
@dataclasses.dataclass(frozen=True)
class GaussianMixture(Distribution):
    """Isotropic K-component Gaussian mixture.

    ``means``: tuple of K length-``ndims`` tuples; ``scales``/``weights``:
    length-K tuples (weights are normalised in float32). The default is the
    hard two-mode 1-D target: modes at ±4 with σ = 0.8.
    """

    ndims: int = 1
    means: tuple = ((-4.0,), (4.0,))
    scales: tuple = (0.8, 0.8)
    weights: tuple = (0.5, 0.5)

    # ------------------------------------------------------------ parameters
    @property
    def _mu(self) -> np.ndarray:  # (K, ndims)
        return np.asarray(self.means, np.float32).reshape(len(self.scales), self.ndims)

    @property
    def _sigma(self) -> np.ndarray:  # (K,)
        return np.asarray(self.scales, np.float32)

    @property
    def _w(self) -> np.ndarray:  # (K,) normalised
        w = np.asarray(self.weights, np.float32)
        return w / w.sum()

    # ---------------------------------------------------------------- energy
    def _component_logits(self, x: Tensor) -> Tensor:
        """log[wₖ·Nₖ(x)] up to the global constant: (..., d, n) → (..., K, n)."""
        dev = x.device
        mu = self.constant("mu", lambda: self._mu, dev)[:, :, None]  # (K, d, 1)
        sig = self.constant("sigma", lambda: self._sigma, dev)  # (K,)
        # the per-component terms, formed once on the device
        logw = self.constant("logw", lambda: torch.log(self.constant("w", lambda: self._w, dev)),
                             dev)[:, None]  # (K, 1)
        sig2 = self.constant("sigma2", lambda: sig * sig, dev)[:, None]
        dlogsig = self.constant("dlogsig", lambda: self.ndims * torch.log(sig), dev)[:, None]
        diff = x[..., None, :, :] - mu  # (..., K, d, n)
        sq = (diff * diff).sum(dim=-2)  # (..., K, n)
        return logw - 0.5 * sq / sig2 - dlogsig

    def potential(self, x: Tensor) -> Tensor:
        return -torch.logsumexp(self._component_logits(x), dim=-2)

    def potential_and_grad(self, x: Tensor):
        """dU/dx = Σₖ rₖ (x−μₖ)/σₖ² with the responsibilities r."""
        logits = self._component_logits(x)  # (..., K, n)
        u = -torch.logsumexp(logits, dim=-2)
        r = torch.softmax(logits, dim=-2)
        mu = self.constant("mu", lambda: self._mu, x.device)[:, :, None]  # (K, d, 1)
        inv_var = self.constant("inv_var", lambda: 1.0 / (self._sigma**2), x.device)
        inv_var = inv_var[:, None, None]
        diff = x[..., None, :, :] - mu  # (..., K, d, n)
        g = (r[..., :, None, :] * diff * inv_var).sum(dim=-3)  # (..., d, n)
        return u, g

    # ------------------------------------------------------------------ init
    def init_x(self, generator: torch.Generator, nbatch: int, device="cpu") -> Tensor:
        """Exact mixture draws (component by categorical, then normal)."""
        w = torch.as_tensor(self._w, device=generator.device)
        comp = torch.multinomial(w, nbatch, replacement=True, generator=generator).to(device)
        mu = torch.as_tensor(self._mu, device=device)[comp].T  # (d, n)
        sig = torch.as_tensor(self._sigma, device=device)[comp][None, :]  # (1, n)
        return mu + sig * randn(generator, (self.ndims, nbatch), device)

    # ------------------------------------------------------------- metadata
    def analytic_mean(self) -> Tensor:
        return torch.as_tensor(self._w @ self._mu)

    def analytic_var(self) -> Tensor:
        w, mu, sig = self._w, self._mu, self._sigma
        ex2 = w @ (mu * mu) + w @ (sig[:, None] ** 2 * np.ones_like(mu))
        m = w @ mu
        return torch.as_tensor(ex2 - m * m)
