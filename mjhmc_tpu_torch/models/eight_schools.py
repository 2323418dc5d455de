"""Eight-schools hierarchical posterior — the canonical shrinkage target
(counterpart of ``mjhmc_tpu.models.eight_schools``).

Rubin's eight-schools meta-analysis (BDA §5.5). Rows of the (ndims,
nbatch) state: row 0 is the population mean ``μ``, row 1 the log
population scale ``ℓ = log τ`` (the Jacobian of τ = eˡ folded into the
energy), rows 2..K+1 the school effects ``θⱼ``:

    μ ~ N(0, m₀²),   ℓ ~ N(0, s₀²),   θⱼ | μ, ℓ ~ N(μ, e²ˡ),
    yⱼ | θⱼ ~ N(θⱼ, σⱼ²)                       (yⱼ, σⱼ known data)

    U(x) = μ²/(2m₀²) + ℓ²/(2s₀²) + K·ℓ + e⁻²ˡ/2 Σⱼ(θⱼ−μ)²
         + Σⱼ (θⱼ−yⱼ)²/(2σⱼ²)

**Exact oracle:** the θⱼ integrate out (yⱼ | μ, ℓ ~ N(μ, σⱼ² + e²ˡ)),
leaving a 2-D marginal p(μ, ℓ) that a dense quadrature grid evaluates in
float64; every first and second moment follows from that grid. The grid
code is NumPy only, copied from the JAX package so that this package
imports none of it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution, randn, register

Tensor = torch.Tensor

# Rubin (1981) / BDA table 5.2
_Y8 = (28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0)
_SIGMA8 = (15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0)


@register("eight_schools")
@dataclasses.dataclass(frozen=True)
class EightSchools(Distribution):
    """Eight-schools posterior over (μ, log τ, group rows).

    ``parameterization``: ``"centered"`` (group rows are θⱼ: the funnel on
    real data) or ``"noncentered"`` (group rows are zⱼ with θⱼ = μ + eˡ·zⱼ).
    Both share the same exact oracle.
    """

    y: tuple = _Y8
    sigma: tuple = _SIGMA8
    mu_scale: float = 25.0
    log_tau_scale: float = 1.5
    parameterization: str = "centered"

    @property
    def ndims(self) -> int:  # type: ignore[override]
        return 2 + len(self.y)

    @property
    def nschools(self) -> int:
        return len(self.y)

    def _consts(self, x: Tensor):
        y = self.constant("y", lambda: np.asarray(self.y, np.float32), x.device)[:, None]
        inv_sig2 = self.constant(
            "inv_sig2", lambda: (1.0 / np.asarray(self.sigma, np.float64) ** 2).astype(np.float32),
            x.device)[:, None]
        return y, inv_sig2

    def _prior(self, mu: Tensor, l: Tensor) -> Tensor:
        return 0.5 * mu * mu / self.mu_scale**2 + 0.5 * l * l / self.log_tau_scale**2

    def potential(self, x: Tensor) -> Tensor:
        mu, l, g = x[..., 0, :], x[..., 1, :], x[..., 2:, :]
        y, inv_sig2 = self._consts(x)
        prior = self._prior(mu, l)
        if self.parameterization == "centered":
            dth = g - mu[..., None, :]
            return (prior + self.nschools * l
                    + 0.5 * torch.exp(-2.0 * l) * (dth * dth).sum(dim=-2)
                    + 0.5 * ((g - y) ** 2 * inv_sig2).sum(dim=-2))
        r = mu[..., None, :] + torch.exp(l)[..., None, :] * g - y
        return prior + 0.5 * (g * g).sum(dim=-2) + 0.5 * (r * r * inv_sig2).sum(dim=-2)

    def potential_and_grad(self, x: Tensor):
        mu, l, g = x[..., 0, :], x[..., 1, :], x[..., 2:, :]
        y, inv_sig2 = self._consts(x)
        k = self.nschools
        prior = self._prior(mu, l)
        if self.parameterization == "centered":
            e2 = torch.exp(-2.0 * l)
            dth = g - mu[..., None, :]
            s1 = dth.sum(dim=-2)
            s2 = (dth * dth).sum(dim=-2)
            r = g - y
            u = prior + k * l + 0.5 * e2 * s2 + 0.5 * (r * r * inv_sig2).sum(dim=-2)
            gmu = mu / self.mu_scale**2 - e2 * s1
            gl = l / self.log_tau_scale**2 + k - e2 * s2
            gth = e2[..., None, :] * dth + r * inv_sig2
            return u, torch.cat([gmu[..., None, :], gl[..., None, :], gth], dim=-2)
        e = torch.exp(l)[..., None, :]
        r = mu[..., None, :] + e * g - y
        ri = r * inv_sig2
        u = prior + 0.5 * (g * g).sum(dim=-2) + 0.5 * (r * ri).sum(dim=-2)
        gmu = mu / self.mu_scale**2 + ri.sum(dim=-2)
        gl = l / self.log_tau_scale**2 + (e * g * ri).sum(dim=-2)
        gz = g + e * ri
        return u, torch.cat([gmu[..., None, :], gl[..., None, :], gz], dim=-2)

    def init_x(self, generator: torch.Generator, nbatch: int, device="cpu") -> Tensor:
        """Hierarchy-shaped overdispersed init: (μ, ℓ) near the data scale,
        group rows from their conditional prior."""
        ybar = float(np.mean(self.y))
        mu = ybar + 8.0 * randn(generator, (1, nbatch), device)
        l = randn(generator, (1, nbatch), device)
        z = randn(generator, (self.nschools, nbatch), device)
        g = mu + torch.exp(l) * z if self.parameterization == "centered" else z
        return torch.cat([mu, l, g], dim=0)

    # ---------------------------------------------------------------- oracle
    def analytic_mean(self) -> Tensor:
        return torch.as_tensor(_quad_moments(self)[0].astype(np.float32))

    def analytic_var(self) -> Tensor:
        return torch.as_tensor(_quad_moments(self)[1].astype(np.float32))

    def exact_sample(self, seed: int, n: int) -> np.ndarray:
        """Exact posterior draws (NumPy, float64): a (μ, ℓ) grid cell drawn
        under the marginalised posterior plus in-cell jitter, then the group
        rows from their conditional Gaussian."""
        grid = _quad_grid(self)
        rng = np.random.default_rng(seed)
        idx = rng.choice(grid.w.size, size=n, p=grid.w.ravel())
        mi, li = np.unravel_index(idx, grid.w.shape)
        mus = grid.mu[mi] + rng.uniform(-0.5, 0.5, n) * grid.dmu
        ls = grid.ell[li] + rng.uniform(-0.5, 0.5, n) * grid.dell
        tau2 = np.exp(2.0 * ls)
        sig2 = np.asarray(self.sigma, np.float64) ** 2
        yv = np.asarray(self.y, np.float64)
        rows = [mus, ls]
        for j in range(self.nschools):
            prec = 1.0 / sig2[j] + 1.0 / tau2
            mj = (yv[j] / sig2[j] + mus / tau2) / prec
            th = mj + rng.standard_normal(n) / np.sqrt(prec)
            rows.append(th if self.parameterization == "centered"
                        else (th - mus) / np.sqrt(tau2))
        return np.asarray(rows, np.float64)


@dataclasses.dataclass(frozen=True)
class _QuadGrid:
    mu: np.ndarray  # (n_mu,)
    ell: np.ndarray  # (n_ell,)
    w: np.ndarray  # (n_mu, n_ell) normalised posterior mass
    dmu: float
    dell: float


@functools.lru_cache(maxsize=8)
def _quad_grid(dist: EightSchools) -> _QuadGrid:
    """Dense grid over the marginalised posterior p(μ, ℓ) (θⱼ integrated
    out: yⱼ | μ, ℓ ~ N(μ, σⱼ²+e²ˡ)), spanning ≥ 9 posterior SDs on both axes."""
    y = np.asarray(dist.y, np.float64)
    sig2 = np.asarray(dist.sigma, np.float64) ** 2
    mu = np.linspace(-40.0, 60.0, 601)
    ell = np.linspace(-8.0, 6.0, 561)
    m, le = np.meshgrid(mu, ell, indexing="ij")
    tau2 = np.exp(2.0 * le)
    logp = -0.5 * m**2 / dist.mu_scale**2 - 0.5 * le**2 / dist.log_tau_scale**2
    for j in range(y.size):
        v = sig2[j] + tau2
        logp += -0.5 * np.log(v) - 0.5 * (y[j] - m) ** 2 / v
    w = np.exp(logp - logp.max())
    w /= w.sum()
    return _QuadGrid(mu, ell, w, float(mu[1] - mu[0]), float(ell[1] - ell[0]))


@functools.lru_cache(maxsize=8)
def _quad_moments(dist: EightSchools):
    """Float64 posterior moments of the state rows via the 2-D grid: group
    rows from the conditional Gaussian θⱼ | μ, ℓ, y ~ N(mⱼ, vⱼ) averaged
    over the grid, as zⱼ = (θⱼ−μ)/τ moments when non-centered."""
    grid = _quad_grid(dist)
    y = np.asarray(dist.y, np.float64)
    sig2 = np.asarray(dist.sigma, np.float64) ** 2
    m, le = np.meshgrid(grid.mu, grid.ell, indexing="ij")
    tau2 = np.exp(2.0 * le)
    w = grid.w
    means = [(w * m).sum(), (w * le).sum()]
    ex2 = [(w * m**2).sum(), (w * le**2).sum()]
    centered = dist.parameterization == "centered"
    for j in range(y.size):
        prec = 1.0 / sig2[j] + 1.0 / tau2
        mj = (y[j] / sig2[j] + m / tau2) / prec
        vj = 1.0 / prec
        if not centered:  # zⱼ | μ, ℓ ~ N((mⱼ−μ)/τ, vⱼ/τ²)
            mj, vj = (mj - m) / np.sqrt(tau2), vj / tau2
        means.append((w * mj).sum())
        ex2.append((w * (mj**2 + vj)).sum())
    mean = np.asarray(means)
    var = np.asarray(ex2) - mean**2
    return mean, var
