"""Reduced-flip HMC in the port against ``mjhmc_tpu.samplers.reduced_flip``.

``reduced_flip_hmc_step`` is fed the draws the JAX step makes from its own
key split (``k_noise, k_sel = split(key)``), so both sides take the same
transitions: ``sel``, the accepts and the counters must be equal at every
step, the states agree to float32 rounding (rtol 1e-5, normwise). The
statistical tests are the JAX package's oracles of
``tests/test_reduced_flip.py`` at smaller sizes, each cut stated.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.samplers.state import ChainState as JChain
from mjhmc_tpu.samplers.state import HMCState as JState
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.convert import hmc_state_from_jax
from mjhmc_tpu_torch.samplers import (
    ControlHMC,
    ReducedFlipHMC,
    make_hmc_state,
    reduced_flip_hmc_run,
    reduced_flip_hmc_step,
)

jrf = importlib.import_module("mjhmc_tpu.samplers.reduced_flip")

torch.set_num_threads(1)

MIXTURE = dict(ndims=2, means=((-2.0, 1.0), (2.0, -1.0)), scales=(0.6, 1.1),
               weights=(0.4, 0.6))


def _start(jd, n, seed):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((jd.ndims, n))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, n)).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = jnp.zeros((n,), jnp.int32)
    js = JState(chain=JChain(x=jnp.asarray(x), v=jnp.asarray(v), u=jnp.asarray(u),
                             grad=jnp.asarray(g)), grad_evals=z, n_accept=z)
    return js, hmc_state_from_jax(x, v, g, u)


def _close(a, b, what, rtol=1e-5):
    """Normwise agreement: each element within rtol of itself or of the
    field's largest magnitude."""
    b = np.asarray(b)
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("name,kw,eps,beta,m,mass", [
    ("Gaussian", dict(ndims=2, log_conditioning=2.0), 1.0, 0.2, 5, None),
    ("Gaussian", dict(ndims=2, log_conditioning=2.0), 1.0, 0.2, 5, (1.0, 0.01)),
    ("Gaussian", dict(ndims=50, log_conditioning=4.0), 0.1, 0.1, 10, None),
    ("GaussianMixture", MIXTURE, 0.4, 0.3, 5, None),
])
def test_step_matches_jax_with_injected_draws(name, kw, eps, beta, m, mass):
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    n = 128
    js, ts = _start(jd, n, seed=1)
    inv_j = None if mass is None else jnp.asarray(1.0 / np.asarray(mass, np.float32))[:, None]
    inv_t = None if mass is None else torch.as_tensor(np.array(inv_j))
    if mass is not None:  # momenta in N(0, M), as the classes start them
        js = js._replace(chain=js.chain._replace(v=js.chain.v / jnp.sqrt(inv_j)))
        ts = ts._replace(chain=ts.chain._replace(v=torch.as_tensor(np.array(js.chain.v))))
    key = jax.random.key(5)
    seen = set()
    for step in range(5):
        key, k = jax.random.split(key)
        js, jo = jrf.reduced_flip_hmc_step(jd, js, k, eps, beta, m, inv_mass=inv_j)
        k_noise, k_sel = jax.random.split(k)  # the draws the JAX step made
        xi = np.array(jax.random.normal(k_noise, (jd.ndims, n), jnp.float32))
        uni = np.array(jax.random.uniform(k_sel, (n,), jnp.float32))
        ts, to = reduced_flip_hmc_step(td, ts, None, eps, beta, m, inv_t,
                                       xi=torch.as_tensor(xi), sel_uniform=torch.as_tensor(uni))
        at = f"step {step}"
        np.testing.assert_array_equal(to.sel.numpy(), np.asarray(jo.sel), err_msg=at)
        np.testing.assert_array_equal(ts.n_accept.numpy(), np.asarray(js.n_accept), err_msg=at)
        np.testing.assert_array_equal(ts.grad_evals.numpy(), np.asarray(js.grad_evals),
                                      err_msg=at)
        for field in ("x", "v", "u", "grad"):
            _close(getattr(ts.chain, field), getattr(js.chain, field), f"{field} {at}")
        _close(to.accept_stat, jo.accept_stat, f"accept_stat {at}")
        seen |= set(np.unique(np.asarray(jo.sel)).tolist())
    assert np.all(np.asarray(js.grad_evals) == 5 * 2 * m)
    assert len(seen) >= 2, f"only sel {seen} exercised"


def test_eval_counter_is_two_trajectories():
    """2M per iteration, exactly: the corruption leaves no backward cache."""
    s = ReducedFlipHMC(tmodels.Gaussian(ndims=2), num_leapfrog_steps=7, nbatch=32,
                       device="cpu")
    s.sample(13)
    assert s.grad_evals == 13 * 2 * 7 * 32
    s.burn_in(3)
    assert s.grad_evals == 0 and int(s.state.n_accept.sum()) == 0


def test_run_modes_agree():
    td = tmodels.Gaussian(ndims=3, log_conditioning=1.0)
    st = make_hmc_state(td, torch.Generator().manual_seed(1), 64)
    s1, samples = reduced_flip_hmc_run(td, st, torch.Generator().manual_seed(0), 20, 0.5, 0.3, 5)
    s2, stats = reduced_flip_hmc_run(td, st, torch.Generator().manual_seed(0), 20, 0.5, 0.3, 5,
                                     collect="stats")
    torch.testing.assert_close(s1.chain.x, s2.chain.x, rtol=0, atol=0)
    assert samples["x"].shape == (20, 3, 64) and samples["sel"].dtype == torch.int8
    assert samples["evals_mean"][-1].item() == 20 * 2 * 5
    torch.testing.assert_close(stats["moments"].mean(), samples["x"].mean(dim=(0, 2)),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        reduced_flip_hmc_run(td, st, None, 1, 0.5, 0.3, 5, collect="bogus")


def test_gaussian_moments():
    """tests/test_reduced_flip.py's oracle; cut from 512 chains and 300 +
    1500 iterations to 256 and 200 + 600 (the mean's bound scales with the
    chains, as JAX's does)."""
    dist = tmodels.Gaussian(ndims=4, log_conditioning=1.5)
    s = ReducedFlipHMC(dist, epsilon=0.5, beta=0.3, num_leapfrog_steps=5, nbatch=256, seed=0,
                       device="cpu")
    s.burn_in(200)
    xs = s.sample(600)["x"].numpy()
    tgt = dist.analytic_var().numpy()
    np.testing.assert_allclose(xs.mean(axis=(0, 2)), 0.0, atol=3.5 * np.sqrt(tgt.max() / 256))
    np.testing.assert_allclose(xs.var(axis=(0, 2)), tgt, rtol=0.15)


def test_small_eps_never_flips():
    """ε→0 ⇒ p_leap→1 both ways ⇒ p_flip = 0: the chain always leaps."""
    dist = tmodels.Gaussian(ndims=2, log_conditioning=0.0)
    s = ReducedFlipHMC(dist, epsilon=0.01, beta=0.5, num_leapfrog_steps=3, nbatch=64,
                       device="cpu")
    sel = s.sample(50)["sel"].numpy()
    assert (sel == 0).mean() > 0.999


def test_flips_rarer_than_control_hmc():
    """At one (ε, β, M) the reduced-flip chain reverses less often than
    flip-on-reject control HMC; cut from 512 chains and 200 + 400
    iterations to 256 and 100 + 200."""
    dist = tmodels.Gaussian(ndims=8, log_conditioning=2.0)
    kw = dict(epsilon=0.35, beta=0.2, num_leapfrog_steps=5, nbatch=256, seed=1, device="cpu")
    rf, ctl = ReducedFlipHMC(dist, **kw), ControlHMC(dist, **kw)
    rf.burn_in(100)
    ctl.burn_in(100)
    rf_fliprate = float((rf.sample(200)["sel"] == 1).float().mean())
    ctl_fliprate = float(1.0 - ctl.sample(200)["accept"].float().mean())
    assert rf_fliprate < ctl_fliprate
