"""Parallel tempering in the port against ``mjhmc_tpu.samplers.tempering``.

``pt_step`` is fed the draws the JAX step makes from its own key split
(``k_mom, k_mh, k_swap = split(key, 3)``), from the same start
(``convert.pt_state_from_jax``), so both sides take the same transitions:
the accepts, the swaps, ``replica_id``, ``seen_hot``, ``round_trips`` and
every int32 counter must be equal at every step, the states agree to
float32 rounding (rtol 1e-5, normwise). The ladder functions are NumPy on
both sides and must agree bit for bit. The statistical tests are the JAX
package's oracles of ``tests/test_tempering.py`` at smaller sizes, each
cut stated.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu import models as jmodels
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.convert import pt_state_from_jax
from mjhmc_tpu_torch.experiments import calculate_autocorrelation
from mjhmc_tpu_torch.samplers import (
    ControlHMC,
    ParallelTempering,
    geometric_ladder,
    make_pt_state,
    pt_run,
    pt_step,
    update_ladder,
)
from mjhmc_tpu_torch.utils import init_cache
from mjhmc_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from mjhmc_tpu_torch.utils.pytree import tree_leaves

jpt = importlib.import_module("mjhmc_tpu.samplers.tempering")

torch.set_num_threads(1)


def _close(a, b, what, rtol=1e-5):
    b = np.asarray(b)
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _start(jd, t, n, seed):
    """A JAX PTState with every replica at its own point, and the port's."""
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((t, jd.ndims, n))).astype(np.float32)
    u, g = jd.potential_and_grad(jnp.asarray(x))
    js = jpt.PTState(
        x=jnp.asarray(x), u=u, grad=g,
        grad_evals=jnp.zeros((n,), jnp.int32),
        n_accept=jnp.zeros((t, n), jnp.int32),
        n_swap_acc=jnp.zeros((t - 1, n), jnp.int32),
        n_swap_try=jnp.zeros((t - 1, n), jnp.int32),
        replica_id=jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[:, None], (t, n)),
        seen_hot=jnp.zeros((t, n), bool),
        round_trips=jnp.zeros((t, n), jnp.int32),
        n_iter=jnp.int32(0),
    )
    return js, pt_state_from_jax(*(np.asarray(a) for a in js))


INTS = ("grad_evals", "n_accept", "n_swap_acc", "n_swap_try", "replica_id", "seen_hot",
        "round_trips", "n_iter")


@pytest.mark.parametrize("name,kw,eps,m,beta_min", [
    ("Gaussian", dict(ndims=2, log_conditioning=2.0), 0.8, 5, 0.05),
    ("Gaussian", dict(ndims=50, log_conditioning=4.0), 0.1, 10, 0.2),
    ("GaussianMixture", dict(), 0.4, 5, 0.02),
])
def test_pt_step_matches_jax_with_injected_draws(name, kw, eps, m, beta_min):
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    t, n = 4, 128
    js, ts = _start(jd, t, n, seed=2)
    betas = geometric_ladder(t, beta_min)
    jb, tb = jnp.asarray(betas), torch.as_tensor(betas)
    key = jax.random.key(9)
    swaps = 0
    for step in range(5):
        key, k = jax.random.split(key)
        parity = step % 2
        js, jo = jpt.pt_step(jd, js, k, jnp.int32(parity), jb, eps, m)
        k_mom, k_mh, k_swap = jax.random.split(k, 3)  # the draws the JAX step made
        v = np.array(jax.random.normal(k_mom, (t, jd.ndims, n), jnp.float32))
        mh = np.array(jax.random.uniform(k_mh, (t, n), jnp.float32))
        sw = np.array(jax.random.uniform(k_swap, (t - 1, n), jnp.float32))
        ts, to = pt_step(td, ts, None, parity, tb, eps, m, v=torch.as_tensor(v),
                         mh_uniform=torch.as_tensor(mh), swap_uniform=torch.as_tensor(sw))
        at = f"step {step}"
        np.testing.assert_array_equal(to.accept.numpy(), np.asarray(jo.accept), err_msg=at)
        np.testing.assert_array_equal(to.swap_accept.numpy(), np.asarray(jo.swap_accept),
                                      err_msg=at)
        for field in INTS:
            np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                          np.asarray(getattr(js, field)), err_msg=f"{field} {at}")
        for field in ("x", "u", "grad"):
            _close(getattr(ts, field), getattr(js, field), f"{field} {at}")
        _close(to.x, jo.x, f"out x {at}")
        swaps += int(np.asarray(jo.swap_accept).sum())
    assert swaps > 0 and np.asarray(js.n_accept).any(), "no swap or accept exercised"
    assert int(ts.n_iter) == 5 and np.all(ts.grad_evals.numpy() == 5 * t * m)


@pytest.mark.parametrize("t,beta_min", [(1, 0.1), (2, 0.5), (6, 0.02), (7, 0.01), (12, 1e-3)])
def test_ladders_bit_equal_to_jax(t, beta_min):
    b = geometric_ladder(t, beta_min)
    jb = jpt.geometric_ladder(t, beta_min)
    assert b.dtype == jb.dtype and np.array_equal(b, jb)
    rates = np.random.default_rng(t).random(max(t - 1, 1))[: t - 1]
    for target, eta in ((0.4, 0.6), (0.25, 1.5)):
        u = update_ladder(b, rates, target, eta)
        ju = jpt.update_ladder(jb, rates, target, eta)
        assert u.dtype == ju.dtype and np.array_equal(u, ju)


def test_update_ladder_invariants():
    b = geometric_ladder(5, 0.01)
    np.testing.assert_allclose(update_ladder(b, np.full(4, 0.4)), b, rtol=1e-5)
    b3 = update_ladder(b, np.array([0.0, 0.4, 0.4, 0.9]))
    assert b3[-1] == 1.0 and (np.diff(b3) > 0).all()
    gaps_old, gaps_new = np.diff(np.log(b)), np.diff(np.log(b3))
    assert gaps_new[0] < gaps_old[0] and gaps_new[-1] > gaps_old[-1]


def test_pt_cost_model():
    """grad_evals = T · M per chain per iteration, exactly."""
    pt = ParallelTempering(tmodels.GaussianMixture(), nbatch=8, num_temps=4,
                           num_leapfrog_steps=3, seed=1, device="cpu")
    pt.sample(10)
    np.testing.assert_array_equal(pt.state.grad_evals.numpy(), np.full(8, 10 * 4 * 3))
    assert pt.grad_evals == 8 * 10 * 4 * 3 and int(pt.state.n_iter) == 10


def _stuck(sampler, dist):
    x0 = torch.full_like(sampler.state.x, -4.0)
    u0, g0 = dist.potential_and_grad(x0)
    return x0, u0, g0


def test_single_temperature_hmc_is_stuck():
    """The control experiment: plain HMC cannot cross the ≈12.5 kT barrier."""
    dist = tmodels.GaussianMixture()
    s = ControlHMC(dist, epsilon=0.4, beta=1.0, num_leapfrog_steps=5, nbatch=64, seed=0,
                   device="cpu")
    x0 = torch.full_like(s.state.chain.x, -4.0)
    u0, g0 = dist.potential_and_grad(x0)
    s.state = s.state._replace(chain=s.state.chain._replace(x=x0, u=u0, grad=g0))
    assert float(s.sample(400)["x"][-100:].mean()) < -3.0


def test_parallel_tempering_crosses_modes():
    """PT from the stuck start recovers both modes and the exact moments;
    cut from 500 + 2500 iterations to 300 + 1500 (64 chains, as JAX)."""
    dist = tmodels.GaussianMixture()  # symmetric ±4, σ = 0.8: mean 0, var 16.64
    pt = ParallelTempering(dist, epsilon=0.4, num_leapfrog_steps=5, nbatch=64, num_temps=6,
                           beta_min=0.02, seed=0, device="cpu")
    x0, u0, g0 = _stuck(pt, dist)
    pt.state = pt.state._replace(x=x0, u=u0, grad=g0)
    pt.burn_in(300)
    xs = pt.sample(1500)["x"].numpy()
    var = float(dist.analytic_var()[0])
    assert 0.4 < float((xs > 0).mean()) < 0.6
    assert abs(xs.mean()) < 0.45
    assert abs(xs.var() - var) / var < 0.12
    assert (pt.swap_rates > 0.2).all() and (pt.accept_rates > 0.5).all()
    assert pt.round_trip_rate > 0.0


def test_pt_replica_flow():
    """Replica identities stay a permutation of 0..T−1 per chain, and the
    replicas complete hot→cold round trips (32 chains, 600 iterations, as
    JAX)."""
    pt = ParallelTempering(tmodels.GaussianMixture(), epsilon=0.4, num_leapfrog_steps=5,
                           nbatch=32, num_temps=5, beta_min=0.05, seed=3, device="cpu")
    pt.sample(600)
    rid = pt.state.replica_id.numpy()
    np.testing.assert_array_equal(np.sort(rid, axis=0), np.arange(5)[:, None].repeat(32, 1))
    assert pt.round_trip_rate > 0.0
    assert (pt.state.round_trips.numpy().sum(axis=0) > 0).all()


def _window_rates(pt, steps):
    s0 = pt.state
    pt._run(steps, "stats")
    acc = (pt.state.n_swap_acc - s0.n_swap_acc).numpy().mean(axis=-1)
    tries = np.maximum((pt.state.n_swap_try - s0.n_swap_try).numpy(), 1).mean(axis=-1)
    return acc / tries


def test_adapt_ladder_equalizes_swap_rates():
    """From a far too cold base, windowed adaptation flattens the per-pair
    swap-rate profile and sampling afterwards stays exact; cut from 15
    windows of 60 and 1500 iterations of sampling to 12 of 50 and 800."""
    dist = tmodels.GaussianMixture()
    pt = ParallelTempering(dist, epsilon=0.4, num_leapfrog_steps=5, nbatch=64, num_temps=6,
                           beta_min=0.001, seed=2, device="cpu")
    pt.burn_in(200)
    r0 = _window_rates(pt, 100)
    betas = pt.adapt_ladder(num_windows=12, window_size=50, target=0.4)
    assert betas[-1] == 1.0 and (np.diff(betas) > 0).all()
    np.testing.assert_array_equal(betas, pt.betas.numpy())
    pt.burn_in(200)
    r1 = _window_rates(pt, 100)
    assert r1.std() < r0.std()
    assert (r1 > 0.15).all() and abs(r1.mean() - 0.4) < 0.2
    xs = pt.sample(800)["x"].numpy()
    var = float(dist.analytic_var()[0])
    assert abs(xs.var() - var) / var < 0.15
    assert 0.35 < float((xs > 0).mean()) < 0.65


def test_pt_2d_mixture_moments():
    """Four modes on a square, exact moments; cut from 128 chains and 300 +
    1500 iterations to 128 and 200 + 800."""
    dist = tmodels.GaussianMixture(ndims=2, means=((-3.0, -3.0), (-3.0, 3.0), (3.0, -3.0),
                                                   (3.0, 3.0)),
                                   scales=(0.7,) * 4, weights=(0.25,) * 4)
    pt = ParallelTempering(dist, epsilon=0.35, num_leapfrog_steps=5, nbatch=128, num_temps=6,
                           beta_min=0.02, seed=7, device="cpu")
    pt.burn_in(200)
    xs = pt.sample(800)["x"].numpy()
    np.testing.assert_allclose(xs.var(axis=(0, 2)), dist.analytic_var().numpy(), rtol=0.12)
    assert np.abs(xs.mean(axis=(0, 2))).max() < 0.5


def test_pt_single_temperature_reduces_to_hmc_target():
    """T = 1 is plain full-refresh HMC on the base target (256 chains, 800
    iterations, as JAX)."""
    dist = tmodels.GaussianMixture(ndims=1, means=((0.0,),), scales=(1.5,), weights=(1.0,))
    state = make_pt_state(dist, torch.Generator().manual_seed(4), 256, 1)
    state, out = pt_run(dist, state, torch.Generator().manual_seed(5), 800, torch.ones(1),
                        0.5, 5)
    xs = out["x"][200:].numpy()
    assert abs(xs.var() - 2.25) / 2.25 < 0.1
    assert out["evals_mean"][-1].item() == 800 * 5


def test_pt_state_checkpoint_roundtrip(tmp_path):
    """PTState (replica-flow fields and n_iter included) survives
    save_pytree / load_pytree bit-exactly."""
    dist = tmodels.GaussianMixture()
    pt = ParallelTempering(dist, nbatch=16, num_temps=4, seed=5, device="cpu")
    pt.sample(20)
    path = str(tmp_path / "pt.npz")
    save_pytree(path, pt.state)
    restored = load_pytree(path, make_pt_state(dist, torch.Generator().manual_seed(0), 16, 4))
    for a, b in zip(tree_leaves(pt.state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(restored.n_iter) == 20


@pytest.mark.parametrize("cached", [False, True])
def test_pt_autocorrelation_experiment(cached, monkeypatch, tmp_path):
    """calculate_autocorrelation runs PT: ρ finite, its evals axis charges
    every replica (T·M per iteration), from its own burn-in or from the
    cached init broadcast to every rung."""
    monkeypatch.setattr(init_cache, "DEFAULT_CACHE_DIR", str(tmp_path))
    res = calculate_autocorrelation(
        tmodels.GaussianMixture(), "pt", num_steps=300, nbatch=32, nlags=60, burn_steps=100,
        use_cached_init=cached, device="cpu", epsilon=0.4, num_leapfrog_steps=5,
        num_temps=4, beta_min=0.05)
    assert np.isfinite(res.rho).all() and res.rho[0] > 0.9
    assert res.grad_evals[1] - res.grad_evals[0] == 4 * 5
    assert res.total_grad_evals == 300 * 32 * 4 * 5
    assert res.name == "pt"


def test_reduced_flip_autocorrelation_experiment(monkeypatch, tmp_path):
    """calculate_autocorrelation runs reduced-flip HMC from the cached init:
    its evals axis is 2M per iteration."""
    monkeypatch.setattr(init_cache, "DEFAULT_CACHE_DIR", str(tmp_path))
    res = calculate_autocorrelation(
        tmodels.Gaussian(ndims=2, log_conditioning=1.0), "reduced_flip", num_steps=200,
        nbatch=32, nlags=40, burn_steps=50, device="cpu", epsilon=0.5, beta=0.3,
        num_leapfrog_steps=4)
    assert np.isfinite(res.rho).all() and res.rho[0] > 0.9
    np.testing.assert_allclose(np.diff(res.grad_evals), 2 * 4)
    assert res.total_grad_evals == 200 * 32 * 2 * 4
