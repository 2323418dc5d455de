"""Bayesian-optimization hyperparameter search (counterpart of
``mjhmc_tpu.search.bayes``).

The reference drove Spearmint, an external GP/expected-improvement
service, over (ε, β, M) with the autocorrelation decay time as the
objective. This module is the in-process equivalent, in float32 on the
search's device:

- a Gaussian-process surrogate (Matérn-5/2 ARD kernel, standardized
  log-objective) over observation buffers padded to the full search
  budget and masked, so the masked rows never perturb the posterior;
- GP hyperparameters (lengthscales, amplitude, noise) refit each
  iteration by Adam on the masked marginal likelihood, written out here
  (the gradient from ``torch.autograd`` through the Cholesky factor and
  the solves), so a search never pays the ``torch._dynamo`` import that
  a ``torch.optim`` optimizer makes at first use;
- expected improvement maximized over a quasi-random (Halton) candidate
  set, dense enough in the ≤3-D hyperparameter space;
- the objective runs the plain sampler per point (``search.grid``'s
  ``make_point_run``, one initial state per M).

Discrete M is handled Spearmint-style: relaxed to a continuous third
coordinate for the GP, snapped to the nearest allowed value (Python's
``round``) for evaluation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch
from torch import Tensor

from mjhmc_tpu_torch.samplers.state import checked_device
from mjhmc_tpu_torch.search.grid import (
    SearchResult,
    best_of,
    lag_window,
    make_point_run,
    point_generator,
    score,
)

_JITTER = 1e-8


# ---------------------------------------------------------------------------
# GP surrogate (masked, fixed-shape)
# ---------------------------------------------------------------------------


def _matern52(x1: Tensor, x2: Tensor, log_ls: Tensor, log_amp: Tensor) -> Tensor:
    """Matérn-5/2 ARD kernel. x1:(n,d), x2:(m,d) -> (n,m)."""
    scaled1 = x1 / torch.exp(log_ls)
    scaled2 = x2 / torch.exp(log_ls)
    d2 = ((scaled1[:, None, :] - scaled2[None, :, :]) ** 2).sum(dim=-1)
    r = torch.sqrt(torch.clamp(d2, min=1e-20))
    s5r = math.sqrt(5.0) * r
    return torch.exp(2.0 * log_amp) * (1.0 + s5r + 5.0 / 3.0 * d2) * torch.exp(-s5r)


def _masked_chol(x: Tensor, mask: Tensor, theta: Tensor) -> Tensor:
    """Cholesky factor of the masked kernel matrix; NaN where the matrix is
    not positive definite, as JAX's is.

    Masked-out rows/columns are replaced by identity rows: they have zero
    cross-covariance with everything and unit self-variance, so they do
    not perturb the posterior over the active points.
    """
    log_ls, log_amp, log_noise = theta[:-2], theta[-2], theta[-1]
    both = mask[:, None] * mask[None, :]
    k_off = _matern52(x, x, log_ls, log_amp) * both
    kmat = k_off - torch.diag(torch.diagonal(k_off)) + torch.diag(
        mask * (torch.exp(2.0 * log_amp) + torch.exp(2.0 * log_noise) + _JITTER)
        + (1.0 - mask)
    )
    chol, info = torch.linalg.cholesky_ex(kmat)
    return torch.where(info == 0, chol, torch.full_like(chol, float("nan")).tril())


def _cho_solve(chol: Tensor, b: Tensor) -> Tensor:
    return torch.cholesky_solve(b[:, None], chol, upper=False)[:, 0]


def _gp_nll(theta: Tensor, x: Tensor, y: Tensor, mask: Tensor) -> Tensor:
    """Masked negative log marginal likelihood (up to a constant)."""
    chol = _masked_chol(x, mask, theta)
    ym = y * mask
    alpha = _cho_solve(chol, ym)
    logdet = 2.0 * (torch.log(torch.diagonal(chol)) * mask).sum()
    return 0.5 * torch.dot(ym, alpha) + 0.5 * logdet


def _fit_theta(x: Tensor, y: Tensor, mask: Tensor, d: int, steps: int = 150) -> Tensor:
    """Adam (lr 5e-2, β₁ 0.9, β₂ 0.999, ε 1e-8 outside the square root,
    bias-corrected) on the masked NLL from a fixed sane init, θ clipped to
    [-6, 4] after every update."""
    lr, b1, b2, eps = 5e-2, 0.9, 0.999, 1e-8
    theta = torch.cat([torch.full((d,), math.log(0.3)), torch.tensor([0.0, math.log(0.1)])]
                      ).to(device=x.device, dtype=torch.float32)
    m = torch.zeros_like(theta)
    v = torch.zeros_like(theta)
    for t in range(1, steps + 1):
        th = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_gp_nll(th, x, y, mask), th)
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * (g * g) + b2 * v
        mhat = m / (1 - b1**t)
        vhat = v / (1 - b2**t)
        theta = torch.clamp(theta + -lr * (mhat / (torch.sqrt(vhat) + eps)), -6.0, 4.0)
    return theta


def _gp_posterior(x: Tensor, y: Tensor, mask: Tensor, theta: Tensor, xq: Tensor):
    """Posterior mean/std at query points xq:(q,d)."""
    log_ls, log_amp = theta[:-2], theta[-2]
    chol = _masked_chol(x, mask, theta)
    alpha = _cho_solve(chol, y * mask)
    kq = _matern52(xq, x, log_ls, log_amp) * mask[None, :]
    mu = kq @ alpha
    v = torch.linalg.solve_triangular(chol, kq.T, upper=False)
    var = torch.exp(2.0 * log_amp) - (v**2).sum(dim=0)
    return mu, torch.sqrt(torch.clamp(var, min=1e-12))


def _expected_improvement(mu: Tensor, sigma: Tensor, best: Tensor) -> Tensor:
    """EI for minimization, in standardized-y units."""
    z = (best - mu) / sigma
    phi = torch.exp(-0.5 * z**2) / math.sqrt(2.0 * math.pi)
    cdf = 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))
    return (best - mu) * cdf + sigma * phi


def _halton(n: int, d: int) -> np.ndarray:
    """Halton quasi-random sequence in [0,1]^d (first d primes)."""
    primes = [2, 3, 5, 7, 11, 13][:d]
    out = np.empty((n, d))
    for j, p in enumerate(primes):
        idx = np.arange(1, n + 1)
        col = np.zeros(n)
        f = 1.0 / p
        i = idx.copy()
        while i.max() > 0:
            col += f * (i % p)
            i //= p
            f /= p
        out[:, j] = col
    return out


def _propose(x: Tensor, y: Tensor, mask: Tensor, cand: Tensor):
    """One BO iteration: standardize y, refit θ, argmax EI over ``cand``."""
    n_act = torch.clamp(mask.sum(), min=1.0)
    mu_y = (y * mask).sum() / n_act
    sd_y = torch.sqrt((mask * (y - mu_y) ** 2).sum() / n_act) + 1e-9
    ys = (y - mu_y) / sd_y * mask
    theta = _fit_theta(x, ys, mask, x.shape[1])
    best = torch.where(mask > 0, ys, torch.full_like(ys, float("inf"))).min()
    with torch.no_grad():
        mu, sigma = _gp_posterior(x, ys, mask, theta, cand)
        ei = _expected_improvement(mu, sigma, best)
    i = torch.argmax(ei)
    return cand[i], ei[i]


# ---------------------------------------------------------------------------
# Generic minimizer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BayesResult:
    best_x: np.ndarray  # in original units
    best_y: float
    xs: np.ndarray  # (n, d) all evaluated points, original units
    ys: np.ndarray  # (n,)


def bayes_minimize(
    fn: Callable[[np.ndarray], float],
    bounds: Sequence[tuple[float, float]],
    num_init: int = 6,
    num_iters: int = 14,
    num_candidates: int = 2048,
    seed: int = 0,
    device="cuda",
) -> BayesResult:
    """Minimize ``fn`` over a box with GP-EI, the surrogate on ``device``.

    ``fn`` receives a point in ORIGINAL units; the GP works in [0,1]^d.
    """
    device = checked_device(device, "bayes_minimize")
    lo = np.array([b[0] for b in bounds])
    hi = np.array([b[1] for b in bounds])
    d = len(bounds)
    total = num_init + num_iters

    xs = np.zeros((total, d))
    ys = np.zeros((total,))
    mask = np.zeros((total,))

    init = _halton(num_init, d)
    rng = np.random.default_rng(seed)
    cand = np.clip(
        _halton(num_candidates, d) + rng.uniform(0, 1e-3, (num_candidates, d)), 0.0, 1.0)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    cand_t = f32(cand)

    def eval_at(u: np.ndarray) -> float:
        v = fn(lo + u * (hi - lo))
        if not np.isfinite(v):
            finite = ys[mask > 0][np.isfinite(ys[mask > 0])]
            v = (finite.max() if len(finite) else 1.0) + 1.0
        return float(v)

    for i in range(num_init):
        xs[i] = init[i]
        ys[i] = eval_at(init[i])
        mask[i] = 1.0

    for i in range(num_init, total):
        u, _ = _propose(f32(xs), f32(ys), f32(mask), cand_t)
        u = u.cpu().numpy().astype(np.float64)
        xs[i] = u
        ys[i] = eval_at(u)
        mask[i] = 1.0

    i_best = int(np.argmin(ys))
    return BayesResult(
        best_x=lo + xs[i_best] * (hi - lo),
        best_y=float(ys[i_best]),
        xs=lo + xs * (hi - lo),
        ys=ys.copy(),
    )


# ---------------------------------------------------------------------------
# Sampler-hyperparameter objective (ε, β, M)
# ---------------------------------------------------------------------------


def bayes_search(
    dist,
    sampler: str = "mjhmc",
    eps_range: tuple[float, float] = (0.01, 10.0),
    beta_range: tuple[float, float] = (0.02, 0.9),
    m_grid: Sequence[int] = (5, 10, 20),
    num_init: int = 6,
    num_iters: int = 14,
    num_steps: int = 800,
    nbatch: int = 256,
    nlags: int = 100,
    seed: int = 0,
    device="cuda",
) -> SearchResult:
    """GP-EI search over (log10 ε, log10 β, M) on ``device``; objective =
    grad evals to ρ = 1/e. Drop-in upgrade of ``grid_search`` (same
    ``SearchResult``). MALT's second coordinate is its friction γ."""
    device = checked_device(device, "bayes_search")
    m_grid = sorted(m_grid)
    runs = {}  # M -> (run, nlags_m)

    def get_run(m: int):
        if m not in runs:
            nl = lag_window(num_steps, nlags, m)
            runs[m] = (make_point_run(dist, sampler, num_steps, nbatch, nl, seed, m,
                                      "leapfrog", device), nl)
        return runs[m]

    table = []
    counter = [0]

    def objective(p: np.ndarray) -> float:
        log_eps, log_beta, m_rel = p
        m = m_grid[int(np.clip(round(m_rel), 0, len(m_grid) - 1))]
        eps = 10.0**log_eps
        beta = 10.0**log_beta
        run, nl = get_run(m)
        rho, evals = run(eps, beta, point_generator(seed, counter[0]))
        counter[0] += 1
        decay, censored, window_end = score(rho, evals, num_steps, nbatch, nl)
        table.append(dict(epsilon=float(eps), beta=float(beta), num_leapfrog_steps=int(m),
                          decay_evals=float(decay), censored=censored))
        if censored:
            # a censored decay is only a lower bound at the window end:
            # penalize it past any in-window point, keeping it finite and
            # window-scaled so longer windows are still preferred
            return float(np.log(window_end) + 2.0)
        # log-scale objective: decay times span orders of magnitude
        return float(np.log(max(decay, 1e-9)))

    # β searched in log space like ε: MJHMC's optima sit at low β
    bounds = [
        (np.log10(eps_range[0]), np.log10(eps_range[1])),
        (np.log10(beta_range[0]), np.log10(beta_range[1])),
        (0.0, float(len(m_grid) - 1)),
    ]
    bayes_minimize(objective, bounds, num_init=num_init, num_iters=num_iters, seed=seed,
                   device=device)
    return SearchResult(best=best_of(table, finite_fallback=True), table=table)
