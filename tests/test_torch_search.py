"""The port's searches against ``mjhmc_tpu.search`` on the CPU.

The GP pieces (``_matern52``, ``_masked_chol``, ``_gp_nll`` and its
gradient, ``_gp_posterior``, ``_expected_improvement``) agree with JAX's
at rtol 1e-5 / atol 1e-6 on NumPy inputs with padded rows; ``_halton`` is
equal; the hand-written Adam of ``_fit_theta`` lands within rtol 1e-4 of
optax's θ after 150 steps; ``_propose`` picks JAX's candidate wherever
JAX's top two EI values part by more than 1e-4 relative; ``bayes_minimize``
proposes JAX's points on the quadratic bowl of
``tests/test_bayes_search.py`` up to the first near-tie. ``grid_search``'s
streams differ from JAX's (a generator per point from (seed, i) against
``fold_in``), so its decays are held within a factor 2 of JAX's; its
scoring rule is held exactly on injected ρ arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.experiments.autocorr_experiment import _decay_time as jax_decay_time
from mjhmc_tpu.search import bayes as jbayes
from mjhmc_tpu.search import grid_search as jax_grid_search
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.search import bayes as tbayes
from mjhmc_tpu_torch.search import bayes_search, grid_search
from mjhmc_tpu_torch.search.grid import point_generator, score

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _gp_inputs(seed, n=12, active=9, d=3):
    """(x, y, mask, theta, xq) as float32 numpy: ``n`` rows, the last
    ``n - active`` padded (masked out, filled with junk)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    mask = np.zeros(n, np.float32)
    mask[:active] = 1.0
    y[active:] = 99.0
    theta = np.concatenate([np.log(rng.uniform(0.2, 0.6, d)), [0.1, np.log(0.1)]]
                           ).astype(np.float32)
    xq = rng.uniform(0, 1, (64, d)).astype(np.float32)
    return x, y, mask, theta, xq


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_gp_pieces_match_jax(seed):
    x, y, mask, theta, xq = _gp_inputs(seed)
    _close(tbayes._matern52(_t(x), _t(xq), _t(theta[:-2]), _t(theta[-2])),
           jbayes._matern52(x, xq, theta[:-2], theta[-2]))
    _close(tbayes._masked_chol(_t(x), _t(mask), _t(theta)), jbayes._masked_chol(x, mask, theta))
    _close(tbayes._gp_nll(_t(theta), _t(x), _t(y), _t(mask)), jbayes._gp_nll(theta, x, y, mask))
    th = _t(theta).requires_grad_(True)
    (g,) = torch.autograd.grad(tbayes._gp_nll(th, _t(x), _t(y), _t(mask)), th)
    _close(g, jax.grad(jbayes._gp_nll)(theta, x, y, mask))
    mu, sd = tbayes._gp_posterior(_t(x), _t(y), _t(mask), _t(theta), _t(xq))
    jmu, jsd = jbayes._gp_posterior(x, y, mask, theta, xq)
    _close(mu, jmu)
    _close(sd, jsd)
    best = np.float32(y[mask > 0].min())
    _close(tbayes._expected_improvement(mu, sd, _t(best)),
           jbayes._expected_improvement(jmu, jsd, best))


def test_masked_chol_is_nan_where_not_positive_definite():
    """JAX's Cholesky returns NaN for a matrix that is not positive
    definite; the port's does too (``cholesky_ex`` raises nothing)."""
    x = np.zeros((3, 1), np.float32)
    theta = np.array([0.0, 0.0, -6.0], np.float32)
    mask = np.array([1.0, 1.0, 1.0], np.float32)
    # amplitude² e⁸ swallows the noise and jitter in float32: three equal
    # points give a singular matrix
    bad = np.array([0.0, 4.0, -6.0], np.float32)
    for th, singular in ((theta, False), (bad, True)):
        want = np.asarray(jbayes._masked_chol(x, mask, th))
        got = tbayes._masked_chol(_t(x), _t(mask), _t(th)).numpy()
        assert np.isnan(want).any() == singular
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("n,d", [(17, 2), (20, 3), (50, 3)])
def test_halton_is_jax_s(n, d):
    np.testing.assert_array_equal(tbayes._halton(n, d), jbayes._halton(n, d))


def test_fit_theta_matches_optax_adam():
    x, y, mask, _, _ = _gp_inputs(3)
    ys = np.where(mask > 0, (y - y[mask > 0].mean()) / y[mask > 0].std(), 0.0).astype(np.float32)
    want = np.asarray(jbayes._fit_theta(jnp.asarray(x), jnp.asarray(ys), jnp.asarray(mask), 3))
    got = tbayes._fit_theta(_t(x), _t(ys), _t(mask), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


@jax.jit
def _jax_ei(x, y, mask, cand):
    """JAX's ``_propose`` up to its argmax: the EI of every candidate."""
    n_act = jnp.maximum(jnp.sum(mask), 1.0)
    mu_y = jnp.sum(y * mask) / n_act
    sd_y = jnp.sqrt(jnp.sum(mask * (y - mu_y) ** 2) / n_act) + 1e-9
    ys = (y - mu_y) / sd_y * mask
    theta = jbayes._fit_theta(x, ys, mask, x.shape[1])
    best = jnp.min(jnp.where(mask > 0, ys, jnp.inf))
    mu, sigma = jbayes._gp_posterior(x, ys, mask, theta, cand)
    return jbayes._expected_improvement(mu, sigma, best)


def _parted(ei) -> bool:
    """JAX's top two EI values part by more than 1e-4 relative."""
    top = np.sort(np.asarray(ei, np.float64))[-2:]
    return bool(top[1] - top[0] > 1e-4 * abs(top[1]))


def _candidates(n, d, seed):
    rng = np.random.default_rng(seed)
    return np.clip(tbayes._halton(n, d) + rng.uniform(0, 1e-3, (n, d)), 0.0, 1.0
                   ).astype(np.float32)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_propose_matches_jax(seed):
    x, y, mask, _, _ = _gp_inputs(seed, n=14, active=8)
    cand = _candidates(512, 3, seed)
    ju, jei = jbayes._propose(x, y, mask, cand)
    u, ei = tbayes._propose(_t(x), _t(y), _t(mask), _t(cand))
    if _parted(_jax_ei(x, y, mask, cand)):
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_allclose(float(ei), float(jei), rtol=1e-3)


def test_bayes_minimize_proposes_jax_s_points():
    """The quadratic bowl of ``tests/test_bayes_search.py``: the init
    design equal, each proposal JAX's within atol 1e-5 up to the first
    step where JAX's top two EI values nearly tie (at least three), and
    the bowl's minimum found."""
    target = np.array([0.3, 0.7])

    def recorder(log):
        def fn(p):
            log.append(np.array(p))
            return float(np.sum((p - target) ** 2))
        return fn

    kw = dict(num_init=6, num_iters=12, seed=0)
    jpts, tpts = [], []
    jres = jbayes.bayes_minimize(recorder(jpts), [(0.0, 1.0), (0.0, 1.0)], **kw)
    res = tbayes.bayes_minimize(recorder(tpts), [(0.0, 1.0), (0.0, 1.0)], device="cpu", **kw)
    np.testing.assert_array_equal(np.array(tpts[:6]), np.array(jpts[:6]))
    rng = np.random.default_rng(0)
    cand = np.clip(tbayes._halton(2048, 2) + rng.uniform(0, 1e-3, (2048, 2)), 0.0, 1.0)
    cand = jnp.asarray(cand, jnp.float32)
    compared = 0
    for i in range(6, 18):
        xs = np.zeros((18, 2))
        ys = np.zeros(18)
        mask = np.zeros(18)
        xs[:i], mask[:i] = np.array(jpts[:i]), 1.0
        ys[:i] = jres.ys[:i]
        ei = _jax_ei(jnp.asarray(xs, jnp.float32), jnp.asarray(ys, jnp.float32),
                     jnp.asarray(mask, jnp.float32), cand)
        if not _parted(ei):
            break
        np.testing.assert_allclose(tpts[i], jpts[i], rtol=0, atol=1e-5)
        compared += 1
    assert compared >= 3, compared
    assert res.best_y < 0.01 and len(res.ys) == 18


@pytest.mark.parametrize("grid", [
    dict(dist=(4, 1.0), sampler="mjhmc", eps_grid=(0.001, 0.5), beta_grid=(0.2,), m_grid=(5,),
         num_steps=400, nbatch=128, nlags=80),
    dict(dist=(2, 1.0), sampler="control", eps_grid=(0.3, 0.8), beta_grid=(0.3, 1.0),
         m_grid=(3, 5), num_steps=300, nbatch=64, nlags=60),
], ids=["mjhmc", "control"])
def test_grid_search_matches_jax(grid):
    """The grids of ``tests/test_search.py``: the table in JAX's order with
    JAX's keys and hyperparameters, each uncensored decay within a factor
    2 of JAX's (other streams), ε = 0.5 best on the first."""
    kw = dict(grid)
    nd, lc = kw.pop("dist")
    jres = jax_grid_search(jmodels.Gaussian(ndims=nd, log_conditioning=lc), **kw)
    res = grid_search(tmodels.Gaussian(ndims=nd, log_conditioning=lc), device="cpu", **kw)
    assert [list(r) for r in res.table] == [list(r) for r in jres.table]
    for r, jr in zip(res.table, jres.table):
        for k in ("epsilon", "beta", "num_leapfrog_steps"):
            assert r[k] == jr[k]
        if not (r["censored"] or jr["censored"]):
            assert 0.5 < r["decay_evals"] / jr["decay_evals"] < 2.0, (r, jr)
    if kw["sampler"] == "mjhmc":
        assert res.best["epsilon"] == 0.5
    assert np.isfinite(res.best["decay_evals"]) and not res.best["censored"]


def _jax_score(rho, evals, num_steps, nbatch, nl):
    """``mjhmc_tpu.search.grid``'s scoring of one point, as written there."""
    evals_per_step = float(evals) / (num_steps * nbatch)
    axis = np.arange(nl) * evals_per_step
    decay = jax_decay_time(axis, rho)
    if not np.isfinite(rho).all():
        decay = float("inf")
    censored = np.isfinite(decay) and decay >= axis[-1] * 0.999
    return decay, bool(censored)


def test_scoring_rule_matches_jax():
    nl, steps, nbatch = 40, 200, 64
    lags = np.arange(nl)
    cases = {
        "decays": np.exp(-lags / 6.0),
        "at lag 0": np.r_[1.0, -0.1 * np.ones(nl - 1)],
        "censored": 1.0 - 0.001 * lags,
        "non-finite": np.r_[1.0, 0.5, np.nan, 0.2 * np.ones(nl - 3)],
        "infinite": np.r_[1.0, np.inf, 0.1 * np.ones(nl - 2)],
    }
    for name, rho in cases.items():
        for evals in (steps * nbatch * 5, steps * nbatch * 7 + 13):
            decay, censored, end = score(rho, evals, steps, nbatch, nl)
            jdecay, jcensored = _jax_score(rho, evals, steps, nbatch, nl)
            assert (decay == jdecay or (np.isinf(decay) and np.isinf(jdecay))), name
            assert censored == jcensored, name
            assert end == (nl - 1) * evals / (steps * nbatch)
    assert score(cases["censored"], 5 * steps * nbatch, steps, nbatch, nl)[1]
    assert np.isinf(score(cases["non-finite"], 5 * steps * nbatch, steps, nbatch, nl)[0])


def test_point_streams_restart_per_m_and_differ_per_point():
    a = torch.randn(4, generator=point_generator(0, 3))
    b = torch.randn(4, generator=point_generator(0, 3))
    c = torch.randn(4, generator=point_generator(0, 4))
    d = torch.randn(4, generator=point_generator(1, 3))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_bayes_search_smoke():
    """As ``tests/test_bayes_search.py``'s: the table recorded, the best
    entry finite and drawn from the allowed M grid; the init design's
    hyperparameters are JAX's."""
    kw = dict(sampler="mjhmc", m_grid=(3, 5), num_init=3, num_iters=3, num_steps=200,
              nbatch=64, nlags=50, seed=0)
    res = bayes_search(tmodels.Gaussian(ndims=2, log_conditioning=1.0), device="cpu", **kw)
    assert len(res.table) == 6
    assert np.isfinite(res.best["decay_evals"])
    assert res.best["num_leapfrog_steps"] in (3, 5)
    assert 0.01 <= res.best["epsilon"] <= 10.0
    u = jbayes._halton(3, 3)
    for r, p in zip(res.table[:3], u):
        lo, hi = np.log10([0.01, 0.02]), np.log10([10.0, 0.9])
        log_eps, log_beta = lo + p[:2] * (hi - lo)
        assert r["epsilon"] == 10.0**log_eps and r["beta"] == 10.0**log_beta
        assert r["num_leapfrog_steps"] == (3, 5)[int(np.clip(round(p[2]), 0, 1))]


def test_search_refusals_and_malt():
    dist = tmodels.Gaussian(ndims=2, log_conditioning=1.0)
    with pytest.raises(ValueError, match="only tunable for mjhmc/control"):
        grid_search(dist, sampler="malt", integrator="two_stage", device="cpu")
    with pytest.raises(ValueError):
        grid_search(dist, sampler="nuts", device="cpu")
    res = grid_search(dist, sampler="malt", eps_grid=(0.5,), beta_grid=(0.5, 2.0), num_steps=100,
                      nbatch=32, nlags=30, device="cpu")
    assert [r["beta"] for r in res.table] == [0.5, 2.0]  # γ, MALT's friction


@pytest.mark.parametrize("name", ["grid_search", "bayes_search", "bayes_minimize"])
def test_searches_default_to_the_card(name, monkeypatch):
    from mjhmc_tpu_torch import search

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arg = (lambda p: 0.0, [(0.0, 1.0)]) if name == "bayes_minimize" else (
        tmodels.Gaussian(ndims=2),)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        getattr(search, name)(*arg)
