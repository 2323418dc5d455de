"""Sparse-coding posterior — the large-state benchmark (config 5;
counterpart of ``mjhmc_tpu.models.sparse_coding``).

    U(a) = λ · Σᵢ √(aᵢ² + ε)  +  ½σ⁻² ‖x − Φa‖²

over the coefficients ``a`` of one image patch ``x`` under a dictionary
Φ (npixels × nbasis). Φ is the port's own pretrained artifact
``mjhmc_tpu_torch/data/phi_<p>x<b>.npz`` (the 64×128 file is a byte-for-byte
copy of the JAX package's; ``python -m
mjhmc_tpu_torch.models.dictionary_learning`` makes one at another shape);
shapes with no artifact fall back to the same seeded Gabor bank. The patch
comes from the same NumPy code, so Φ and the patch are identical in both
packages.
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution, randn, register

Tensor = torch.Tensor

#: the port's data directory, where ``dictionary_learning`` writes its Φ
DATA_DIR = Path(__file__).resolve().parents[1] / "data"


def _phi_path(npixels: int, nbasis: int, data_dir=None) -> Path:
    return Path(data_dir or DATA_DIR) / f"phi_{npixels}x{nbasis}.npz"


def load_pretrained(npixels: int, nbasis: int, data_dir=None) -> np.ndarray | None:
    """The pretrained Φ for this shape in ``data_dir`` (default the shipped
    ``DATA_DIR``), or None if there is none."""
    path = _phi_path(npixels, nbasis, data_dir)
    if not path.exists():
        return None
    return np.load(path)["phi"].astype(np.float32)


def _gabor_dictionary(npixels: int, nbasis: int, seed: int) -> np.ndarray:
    """Deterministic Gabor-like dictionary of (side × side) patches,
    columns unit-norm, parameters from a seeded host RNG."""
    side = int(round(np.sqrt(npixels)))
    assert side * side == npixels, "npixels must be a perfect square"
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64)
    phis = np.empty((npixels, nbasis))
    for j in range(nbasis):
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(0.5, 2.0) / side * 2 * np.pi
        phase = rng.uniform(0, 2 * np.pi)
        cx, cy = rng.uniform(0, side, 2)
        sigma = rng.uniform(0.15, 0.35) * side
        xr = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
        env = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma**2))
        g = env * np.cos(freq * xr + phase)
        g -= g.mean()
        n = np.linalg.norm(g)
        phis[:, j] = (g / (n if n > 1e-9 else 1.0)).ravel()
    return phis.astype(np.float32)


@register("sparse_coding")
@dataclasses.dataclass(frozen=True)
class SparseCoding(Distribution):
    """Posterior over the sparse code of one patch; chain state
    dimensionality is ``nbasis``. ``phi_source``: "auto" (the shipped
    artifact if one matches the shape, else Gabor), "pretrained" (require
    the artifact) or "gabor"."""

    npixels: int = 64
    nbasis: int = 128
    lam: float = 1.0  # sparsity weight λ
    sigma: float = 0.1  # observation noise σ
    smooth_eps: float = 1e-3  # smooth-L1 knee
    dict_seed: int = 0
    patch_seed: int = 1
    phi_source: str = "auto"
    #: optional user patch (length npixels) overriding the synthetic one
    custom_patch: tuple | None = None

    @property
    def ndims(self) -> int:  # type: ignore[override]
        return self.nbasis

    @functools.cached_property
    def _phi(self) -> np.ndarray:
        """Φ: (npixels, nbasis) float32."""
        if self.phi_source in ("auto", "pretrained"):
            phi = load_pretrained(self.npixels, self.nbasis)
            if phi is not None:
                return phi
            if self.phi_source == "pretrained":
                raise FileNotFoundError(
                    f"no pretrained dictionary for ({self.npixels}, {self.nbasis}) "
                    f"at {_phi_path(self.npixels, self.nbasis)}; make one with "
                    f"`python -m mjhmc_tpu_torch.models.dictionary_learning "
                    f"--npixels {self.npixels} --nbasis {self.nbasis}`"
                )
        return _gabor_dictionary(self.npixels, self.nbasis, self.dict_seed)

    @property
    def uses_pretrained_phi(self) -> bool:
        return (self.phi_source in ("auto", "pretrained")
                and _phi_path(self.npixels, self.nbasis).exists())

    @functools.cached_property
    def _patch(self) -> np.ndarray:
        """Synthetic conditioning patch (npixels,). With a pretrained Φ: a
        held-out 1/f natural-statistics patch; with the Gabor bank: one
        drawn from the model itself (x = Φa₀ + noise)."""
        rng = np.random.default_rng(self.patch_seed)
        if self.uses_pretrained_phi:
            side = int(round(np.sqrt(self.npixels)))
            fx = np.fft.fftfreq(side)
            rad = np.sqrt(fx[:, None] ** 2 + fx[None, :] ** 2)
            amp = np.where(rad > 0, 1.0 / np.maximum(rad, 1e-6), 0.0)
            noise = rng.standard_normal((side, side)) + 1j * rng.standard_normal(
                (side, side)
            )
            img = np.real(np.fft.ifft2(noise * amp))
            img = (img - img.mean()) / (img.std() + 1e-8)
            return img.ravel().astype(np.float32)
        a0 = rng.laplace(scale=0.5, size=self.nbasis)
        a0 *= rng.random(self.nbasis) < 0.1  # sparse support
        x = self._phi @ a0 + self.sigma * rng.standard_normal(self.npixels)
        return x.astype(np.float32)

    def patch_array(self) -> np.ndarray:
        """The conditioning patch as a float32 (npixels,) array."""
        if self.custom_patch is not None:
            p = np.asarray(self.custom_patch, np.float32)
            assert p.shape == (self.npixels,)
            return p
        return self._patch

    @classmethod
    def with_patch(cls, patch, **kwargs) -> "SparseCoding":
        """Condition on a user image patch (flattened, length npixels)."""
        patch = np.asarray(patch, np.float32).ravel()
        return cls(npixels=len(patch), custom_patch=tuple(patch.tolist()), **kwargs)

    # ---------------------------------------------------------------- energy
    def _resid(self, a: Tensor):
        phi = self.constant("phi", lambda: self._phi, a.device)
        patch = self.constant("patch", self.patch_array, a.device)[:, None]
        return phi, patch - torch.matmul(phi, a)  # (..., npixels, nbatch)

    def potential(self, a: Tensor) -> Tensor:
        _, r = self._resid(a)
        sparse = self.lam * torch.sqrt(a * a + self.smooth_eps).sum(dim=-2)
        return sparse + 0.5 / self.sigma**2 * (r * r).sum(dim=-2)

    def potential_and_grad(self, a: Tensor):
        phi, r = self._resid(a)
        s = torch.sqrt(a * a + self.smooth_eps)
        u = self.lam * s.sum(dim=-2) + 0.5 / self.sigma**2 * (r * r).sum(dim=-2)
        g = self.lam * (a / s) - (1.0 / self.sigma**2) * torch.matmul(phi.T, r)
        return u, g

    def init_x(self, generator: torch.Generator, nbatch: int,
               device="cpu") -> Tensor:
        return 0.1 * randn(generator, (self.nbasis, nbatch), device)
