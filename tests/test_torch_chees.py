"""ChEES and the masked leapfrog in the port against
``mjhmc_tpu.samplers.chees`` and ``mjhmc_tpu.ops.leapfrog.masked_leapfrog``.

``chees_hmc_step`` is fed the draws the JAX step makes from its own key
split (``k_u, k_v, k_mh = split(key, 3)``), so both sides take the same
trajectories: the accepts and the eval counters must be equal at every
step, x, log τ, the Adam moments and the dual-averaging state agree to
float32 rounding (rtol 1e-5). The statistical test is the JAX package's
oracle of ``tests/test_chees.py`` at a smaller size, its cut stated.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.ops.leapfrog import masked_leapfrog as jmasked
from mjhmc_tpu.samplers.adaptation import da_init as jda_init
from mjhmc_tpu.samplers.state import ChainState as JChain
from mjhmc_tpu.samplers.state import HMCState as JState
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.convert import chees_state_from_jax, hmc_state_from_jax
from mjhmc_tpu_torch.ops.leapfrog import leapfrog, masked_leapfrog
from mjhmc_tpu_torch.samplers import (
    chees_hmc_run,
    chees_hmc_step,
    chees_init,
    da_init,
    make_hmc_state,
)

jch = importlib.import_module("mjhmc_tpu.samplers.chees")

torch.set_num_threads(1)


def _close(a, b, what, rtol=1e-5, scale=0.0):
    """Normwise agreement: within rtol of the field's largest magnitude, or
    of ``scale``, the magnitude of the terms a difference was formed from."""
    b = np.asarray(b, np.float64)
    a = (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).astype(np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), scale, 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("name,kw,eps,with_u0", [
    ("Gaussian", dict(ndims=3, log_conditioning=1.0), 0.2, True),
    ("Gaussian", dict(ndims=3, log_conditioning=1.0), 0.2, False),
    ("GaussianMixture", dict(ndims=2, means=((-2.0, 1.0), (2.0, -1.0)), scales=(0.6, 1.1),
                             weights=(0.4, 0.6)), 0.3, True),
])
def test_masked_leapfrog_matches_jax(name, kw, eps, with_u0):
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    rng = np.random.default_rng(0)
    n, max_steps = 64, 10
    x = (2.0 * rng.standard_normal((jd.ndims, n))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, n)).astype(np.float32)
    m_i = rng.integers(0, 14, n).astype(np.int32)  # 0 and past the cap included
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    jo = jmasked(jd.potential_and_grad, jnp.asarray(x), jnp.asarray(v), jnp.asarray(g), eps,
                 max_steps, jnp.asarray(m_i), u0=jnp.asarray(u) if with_u0 else None)
    to = masked_leapfrog(td.potential_and_grad, torch.as_tensor(x), torch.as_tensor(v),
                         torch.as_tensor(g), eps, max_steps, torch.as_tensor(m_i),
                         u0=torch.as_tensor(u) if with_u0 else None)
    for what, a, b in zip(("x", "v", "u", "g"), to[:4], jo[:4]):
        _close(a, b, what)
    assert to[4].dtype == torch.int32
    np.testing.assert_array_equal(to[4].numpy(), np.asarray(jo[4]))
    np.testing.assert_array_equal(to[4].numpy(), np.minimum(m_i, max_steps))


def test_masked_leapfrog_per_chain_lengths():
    """Chain i with m_i = k equals a dedicated k-step integration; a uniform
    length equals the unmasked leapfrog."""
    td = tmodels.Gaussian(ndims=2, log_conditioning=0.5)
    gen = torch.Generator().manual_seed(2)
    x = td.init_x(gen, 4)
    v = torch.randn(x.shape, generator=gen)
    u, g = td.potential_and_grad(x)
    ks = [1, 3, 5, 8]
    xa, va, ua, ga, steps = masked_leapfrog(td.potential_and_grad, x, v, g, 0.3, 8,
                                            torch.tensor(ks, dtype=torch.int32), u0=u)
    assert steps.tolist() == ks
    for c, k in enumerate(ks):
        xe, ve, ue, ge = leapfrog(td.potential_and_grad, x[:, c:c + 1], v[:, c:c + 1],
                                  g[:, c:c + 1], 0.3, k)
        torch.testing.assert_close(xa[:, c:c + 1], xe, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(ua[c:c + 1], ue, rtol=1e-6, atol=1e-6)
    xb, vb, ub, gb = leapfrog(td.potential_and_grad, x, v, g, 0.3, 7)
    xc, vc, _, _, _ = masked_leapfrog(td.potential_and_grad, x, v, g, 0.3, 10,
                                      torch.full((4,), 7, dtype=torch.int32), u0=u)
    torch.testing.assert_close(xc, xb, rtol=0, atol=0)
    torch.testing.assert_close(vc, vb, rtol=0, atol=0)


def test_chees_step_matches_jax_with_injected_draws():
    jd = jmodels.Gaussian(ndims=4, log_conditioning=1.0)
    td = tmodels.Gaussian(ndims=4, log_conditioning=1.0)
    rng = np.random.default_rng(3)
    n, max_steps = 128, 16
    x = (np.sqrt(np.asarray(jd.analytic_var()))[:, None]
         * rng.standard_normal((4, n))).astype(np.float32)
    v = rng.standard_normal((4, n)).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = jnp.zeros((n,), jnp.int32)
    js = JState(chain=JChain(x=jnp.asarray(x), v=jnp.asarray(v), u=jnp.asarray(u),
                             grad=jnp.asarray(g)), grad_evals=z, n_accept=z)
    ts = hmc_state_from_jax(x, v, g, u)
    jcs, jda = jch.chees_init(0.5), jda_init(0.3)
    tcs, tda = chees_state_from_jax(*(np.asarray(a) for a in jcs)), da_init(0.3)
    key = jax.random.key(21)
    for step in range(10):
        key, k = jax.random.split(key)
        js, jcs, jda, jout = jch.chees_hmc_step(jd, js, jcs, jda, k, max_steps)
        k_u, k_v, k_mh = jax.random.split(k, 3)  # the draws the JAX step made
        jit = np.array(jax.random.uniform(k_u, (n,), jnp.float32, 1e-3, 1.0))
        vv = np.array(jax.random.normal(k_v, (4, n), jnp.float32))
        mh = np.array(jax.random.uniform(k_mh, (n,)))
        ts, tcs, tda, tout = chees_hmc_step(td, ts, tcs, tda, None, max_steps,
                                            jitter=torch.as_tensor(jit), v=torch.as_tensor(vv),
                                            mh_uniform=torch.as_tensor(mh))
        at = f"step {step}"
        np.testing.assert_array_equal(ts.grad_evals.numpy(), np.asarray(js.grad_evals),
                                      err_msg=at)
        np.testing.assert_array_equal(ts.n_accept.numpy(), np.asarray(js.n_accept), err_msg=at)
        for field in ("x", "v", "u", "grad"):
            _close(getattr(ts.chain, field), getattr(js.chain, field), f"{field} {at}")
        _close(tcs.log_tau, jcs.log_tau, f"log_tau {at}")
        # the Adam moments carry the surrogate gradient, a sum over chains
        # that cancels (test_surrogate_grad_matches_jax): held at 1e-3
        for field in ("m_adam", "v_adam"):
            _close(getattr(tcs, field), getattr(jcs, field), f"{field} {at}", rtol=1e-3)
        assert int(tcs.step) == int(jcs.step) == step + 1
        assert tda.step == int(jda.step)
        # log ε = μ − √t/γ·h̄: a difference of terms of μ's size
        for field in ("log_eps", "log_eps_bar", "h_bar", "mu"):
            _close(getattr(tda, field), getattr(jda, field), f"da {field} {at}",
                   scale=abs(float(jda.mu)))
        _close(tout["accept_stat"], jout["accept_stat"], f"alpha {at}")
        _close(tout["mean_steps"], jout["mean_steps"], f"mean_steps {at}")
    assert np.asarray(js.n_accept).min() < 10 < np.asarray(js.grad_evals).max()


@pytest.mark.parametrize("n,seed", [(128, 0), (128, 1), (1024, 2), (4096, 3)])
def test_surrogate_grad_matches_jax(n, seed):
    """The surrogate gradient is a sum over chains whose terms cancel, so
    float32 sums in two orders part by float32's rounding of the terms'
    magnitude: held within 1e-5 of Σ|terms| / Σα (the sum's normwise
    bound, here up to ~1e-4 of the value), and each side as close to the
    float64 value as that."""
    from mjhmc_tpu_torch.samplers.chees import chees_surrogate_grad

    rng = np.random.default_rng(seed)
    x = 3.0 * rng.standard_normal((4, n)).astype(np.float32)
    xl = x + rng.standard_normal((4, n)).astype(np.float32)
    vl = rng.standard_normal((4, n)).astype(np.float32)
    alpha = rng.random(n).astype(np.float32)
    tau_i = (0.3 * rng.integers(1, 10, n)).astype(np.float32)
    args = (x, xl, vl, alpha, tau_i, np.float32(2.0))
    gj = float(jch.chees_surrogate_grad(*(jnp.asarray(a) for a in args)))
    gt = float(chees_surrogate_grad(*(torch.as_tensor(a) for a in args)))
    g64 = float(chees_surrogate_grad(*(torch.as_tensor(a).double() for a in args)))
    xc = x - x.mean(axis=1, keepdims=True, dtype=np.float64)
    xlc = xl - xl.mean(axis=1, keepdims=True, dtype=np.float64)
    terms = alpha * ((xlc**2).sum(0) - (xc**2).sum(0)) * (xlc * vl).sum(0) * tau_i / 2.0
    bound = 1e-5 * np.abs(terms).sum() / alpha.sum()
    assert abs(gt - gj) <= bound and abs(gt - g64) <= bound and abs(gj - g64) <= bound


def test_chees_init_matches_jax():
    for tau0 in (0.1, 0.3, 1.0, 7.5):
        cs, jcs = chees_init(tau0), jch.chees_init(tau0)
        for a, b in zip(cs, jcs):
            assert a.dtype == torch.from_numpy(np.array(b)).dtype
            _close(a, b, f"tau0 {tau0}", rtol=1e-7)


def test_chees_adapts_tau_toward_scale():
    """On N(0, σ²I) from a far too short τ, ChEES grows τ past 1 and keeps
    the sampler right; cut from 512 chains to 256 (600 iterations, as
    JAX)."""
    dist = tmodels.Gaussian(ndims=8, log_conditioning=2.0)  # σ_max = 10
    state = make_hmc_state(dist, torch.Generator().manual_seed(4), 256)
    state, cs, da, trace = chees_hmc_run(dist, state, torch.Generator().manual_seed(5), 600,
                                         max_leapfrog_steps=64, tau0=0.1, eps0=0.3)
    assert float(trace["tau"][-50:].mean()) > 1.0
    acc = float(trace["accept"][-100:].mean())
    assert 0.4 < acc < 0.95, acc
    xs_var = state.chain.x.var(dim=1).numpy()
    tgt = dist.analytic_var().numpy()
    assert (xs_var > 0.2 * tgt).all() and (xs_var < 5 * tgt).all()
    assert trace["tau"].shape == trace["eps"].shape == (600,)
    assert int(cs.step) == 600 and da.step == 600
