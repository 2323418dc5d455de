"""The ADVI head in the port against ``mjhmc_tpu.inference.vi``.

``advi_fit`` is fed the draws the JAX fit makes from its keys (``keys =
split(key, num_steps)``, one N(0, I) draw a step, or ``k1, k2 = split(k)``
for the low-rank form's two), for 50 steps: the parameters and the ELBO
trace agree within rtol 1e-4, optax's Adam against ``torch.optim.Adam``
(the same update in another rounding order). The gradient reaches the
model through its analytic ``potential_and_grad``. The statistical tests
are the JAX package's oracles of ``tests/test_inference.py`` at smaller
sizes, each cut stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.inference import vi as jvi
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.convert import advi_params_from_jax, lowrank_advi_params_from_jax
from mjhmc_tpu_torch.inference import ADVI, advi_fit, q_covariance
from mjhmc_tpu_torch.inference import vi as tvi
from mjhmc_tpu_torch.models.base import Distribution

torch.set_num_threads(1)


def _close(a, b, what, rtol=1e-4):
    b = np.asarray(b, np.float64)
    a = (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).astype(np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _jax_draws(key, steps, d, n, rank):
    xi, xi2 = [], []
    for k in jax.random.split(key, steps):
        if rank:
            k1, k2 = jax.random.split(k)
            xi.append(np.array(jax.random.normal(k1, (d, n), jnp.float32)))
            xi2.append(np.array(jax.random.normal(k2, (rank, n), jnp.float32)))
        else:
            xi.append(np.array(jax.random.normal(k, (d, n), jnp.float32)))
    return torch.as_tensor(np.stack(xi)), (torch.as_tensor(np.stack(xi2)) if rank else None)


@pytest.mark.parametrize("name,kw,rank,lr", [
    ("Gaussian", dict(ndims=5, log_conditioning=1.0), 0, 0.05),
    ("Gaussian", dict(ndims=5, log_conditioning=1.0), 5, 0.05),
    ("SparseCoding", dict(), 0, 0.05),
    ("SparseCoding", dict(), 16, 0.05),
])
def test_advi_fit_matches_jax_with_injected_draws(name, kw, rank, lr):
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    steps, n_mc, key = 50, 64, jax.random.key(7)
    jp, je = jax.jit(lambda k: jvi.advi_fit(jd, k, steps, n_mc, lr, rank=rank))(key)
    xi, xi2 = _jax_draws(key, steps, jd.ndims, n_mc, rank)
    tp, te = advi_fit(td, None, steps, n_mc, lr, rank=rank, device="cpu", xi=xi,
                      xi2=xi2)
    assert type(tp).__name__ == type(jp).__name__ and te.shape == (steps,)
    for field, a, b in zip(tp._fields, tp, jp):
        _close(a, b, field)
    _close(te, je, "elbo trace")


def test_lowrank_pieces_match_jax():
    rng = np.random.default_rng(1)
    d, r = 6, 3
    mu, omega = rng.standard_normal(d), 0.3 * rng.standard_normal(d)
    b = 0.5 * rng.standard_normal((d, r))
    jp = jvi.LowRankADVIParams(*(jnp.asarray(a, jnp.float32) for a in (mu, omega, b)))
    tp = lowrank_advi_params_from_jax(*(np.asarray(a) for a in jp))
    _close(tvi.lowrank_entropy(tp), jvi.lowrank_entropy(jp), "entropy", 1e-5)
    _close(q_covariance(tp), jvi.q_covariance(jp), "covariance", 1e-5)
    mf = advi_params_from_jax(np.asarray(jp.mu), np.asarray(jp.omega))
    _close(q_covariance(mf), jvi.q_covariance(jvi.ADVIParams(jp.mu, jp.omega)), "mf cov", 1e-6)
    for a, b_ in zip(tvi.advi_init(tmodels.Gaussian(ndims=d)),
                     jvi.advi_init(jmodels.Gaussian(ndims=d))):
        _close(a, b_, "init", 1e-7)


def test_gradient_is_the_models_analytic_one():
    """The ELBO's gradient reaches the model through potential_and_grad."""
    td = tmodels.SparseCoding()
    z = (0.1 * torch.randn(td.ndims, 8, generator=torch.Generator().manual_seed(0)))
    z.requires_grad_(True)
    tvi.logdensity(td, z).sum().backward()
    u, g = td.potential_and_grad(z.detach())
    torch.testing.assert_close(z.grad, -g, rtol=0, atol=0)
    torch.testing.assert_close(tvi.logdensity(td, z.detach()), -u, rtol=0, atol=0)


def test_advi_recovers_gaussian():
    """Mean-field ADVI on a diagonal Gaussian is exact: μ→0, σ→target; cut
    from 3,000 steps to 2,000 (n_mc 64, as JAX)."""
    dist = tmodels.Gaussian(ndims=5, log_conditioning=1.0)
    params, elbos = advi_fit(dist, torch.Generator().manual_seed(0), num_steps=2000, n_mc=64,
                             learning_rate=0.05, device="cpu")
    tgt_std = np.sqrt(dist.analytic_var().numpy())
    assert (np.abs(params.mu.numpy()) < 0.15 * tgt_std + 0.05).all()
    np.testing.assert_allclose(np.exp(params.omega.numpy()), tgt_std, rtol=0.15)
    e = elbos.numpy()
    assert e[-100:].mean() > e[:100].mean()


def test_advi_wrapper():
    head = ADVI(tmodels.Gaussian(ndims=3, log_conditioning=0.5), num_steps=300, device="cpu")
    head.fit()
    assert head.sample(1000).shape == (3, 1000)
    assert head.covariance().shape == (3, 3)
    head_lr = ADVI(tmodels.Gaussian(ndims=3), num_steps=10, rank=2, device="cpu")
    params, trace = head_lr.fit()
    assert params.b.shape == (3, 2) and trace.shape == (10,)
    assert head_lr.sample(7).shape == (3, 7)


def test_lowrank_advi_recovers_correlated_gaussian():
    """Full-rank ADVI on a correlated Gaussian matches its covariance and
    the ELBO's analytic optimum; mean-field undershoots it. Cut from 3,000
    steps to 2,000 (n_mc 128, as JAX)."""
    cov = np.array([[1.0, 0.8, 0.3], [0.8, 1.5, 0.5], [0.3, 0.5, 0.7]], np.float32)
    prec = torch.as_tensor(np.linalg.inv(cov).astype(np.float32))

    @dataclasses.dataclass(frozen=True)
    class CorrGauss(Distribution):
        ndims: int = 3

        def potential(self, x):
            return 0.5 * (x * torch.einsum("ij,...jn->...in", prec, x)).sum(dim=-2)

    vi = ADVI(CorrGauss(), num_steps=2000, n_mc=128, learning_rate=0.03, rank=3, seed=0,
              device="cpu")
    params, elbos = vi.fit()
    np.testing.assert_allclose(q_covariance(params).numpy(), cov, atol=0.15)
    e_late, e_early = float(elbos[-200:].mean()), float(elbos[:200].mean())
    assert e_late > e_early
    opt = 0.5 * np.linalg.slogdet(2 * np.pi * cov)[1]
    assert abs(e_late - opt) < 0.1, (e_late, opt)
    vi_mf = ADVI(CorrGauss(), num_steps=2000, n_mc=128, learning_rate=0.03, seed=0,
                 device="cpu")
    _, elbos_mf = vi_mf.fit()
    assert float(elbos_mf[-200:].mean()) < e_late - 0.05
