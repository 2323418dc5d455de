"""Port MJHMC sampler vs ``mjhmc_tpu.samplers.mjhmc`` and the NumPy golden.

``mjhmc_step`` is fed the draws the JAX step makes from its own key split
(``k_gum, k_refresh = split(key)``), so both sides take identical
transitions: ``sel`` and the counters must be exactly equal at every step.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.samplers.state import ChainState as JChain
from mjhmc_tpu.samplers.state import MJState as JState
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.convert import state_from_jax
from mjhmc_tpu_torch.diagnostics import weighted_autocorrelation
from mjhmc_tpu_torch.samplers import (
    MarkovJumpHMC,
    MomentAccumulator,
    make_mj_state,
    mjhmc_run,
    mjhmc_step,
)

from reference_impl import numpy_mjhmc

jmj = importlib.import_module("mjhmc_tpu.samplers.mjhmc")

torch.set_num_threads(1)


def _start(jd, n, seed):
    rng = np.random.default_rng(seed)
    scale = np.sqrt(np.asarray(jd.analytic_var(), np.float64))[:, None]
    x = (scale * rng.standard_normal((jd.ndims, n))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, n)).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    js = JState(
        chain=JChain(x=jnp.asarray(x), v=jnp.asarray(v), u=jnp.asarray(u), grad=jnp.asarray(g)),
        h_back=jnp.zeros((n,), jnp.float32),
        back_valid=jnp.zeros((n,), bool),
        grad_evals=jnp.zeros((n,), jnp.int32),
        dwell_sum=jnp.zeros((n,), jnp.float32),
    )
    return js, state_from_jax(x, v, g, u)


def _close(a, b, what, rtol):
    """Normwise agreement: each element within rtol of itself or of the
    field's largest magnitude."""
    b = np.asarray(b)
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize(
    "name,kw,eps,beta,m,steps,rtol",
    [
        # XLA's float32 sin and torch's differ by one ulp on ~5% of arguments
        # (x/scale2 reaches ~100 rad); ten-step trajectories amplify that to
        # a few 1e-5 by the fifth iteration, so the rough well is held at 5e-5
        ("RoughWell", dict(ndims=2), 1.0, 0.1, 10, 5, 5e-5),
        # linear dynamics: rounding does not grow
        ("Gaussian", dict(ndims=2, log_conditioning=2.0), 1.0, 0.1, 5, 50, 1e-5),
    ],
)
def test_step_matches_jax_with_injected_draws(name, kw, eps, beta, m, steps, rtol):
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    n = 256
    js, ts = _start(jd, n, seed=0)
    key = jax.random.key(11)
    for step in range(steps):
        key, k = jax.random.split(key)
        js, jo = jmj.mjhmc_step(jd, js, k, eps, beta, m)
        k_gum, k_refresh = jax.random.split(k)  # the draws mjhmc_step made
        gum = np.array(jax.random.gumbel(k_gum, (3, n), jnp.float32))
        xi = np.array(jax.random.normal(k_refresh, (jd.ndims, n), jnp.float32))
        ts, to = mjhmc_step(td, ts, None, eps, beta, m,
                            gumbel=torch.as_tensor(gum), xi=torch.as_tensor(xi))
        at = f"step {step}"
        np.testing.assert_array_equal(to.sel.numpy(), np.asarray(jo.sel), err_msg=at)
        np.testing.assert_array_equal(ts.grad_evals.numpy(), np.asarray(js.grad_evals), err_msg=at)
        np.testing.assert_array_equal(ts.back_valid.numpy(), np.asarray(js.back_valid), err_msg=at)
        for field in ("x", "v", "u", "grad"):
            _close(getattr(ts.chain, field), getattr(js.chain, field), f"{field} {at}", rtol)
        _close(ts.h_back, js.h_back, f"h_back {at}", rtol)
        _close(ts.dwell_sum, js.dwell_sum, f"dwell_sum {at}", rtol)
        for field in ("x", "dwell", "accept_stat"):
            _close(getattr(to, field), getattr(jo, field), f"out {field} {at}", rtol)
        np.testing.assert_allclose(to.cache_err.numpy(), np.asarray(jo.cache_err),
                                   atol=1e-3, err_msg=at)
    assert (np.asarray(js.grad_evals) > steps * m).any(), "no cache rebuild exercised"


def test_counters_follow_cost_model():
    """Per chain: evals = M·steps + M·(1 + #R before the last step), and
    cache_err stays at float roundoff wherever the cache claims validity."""
    td = tmodels.Gaussian(ndims=2, log_conditioning=2.0)
    s = MarkovJumpHMC(td, epsilon=1.0, beta=0.3, num_leapfrog_steps=5, nbatch=128, seed=2)
    out = s.sample(40)
    sel = out["sel"].numpy()
    n_r = (sel[:-1] == 2).sum(axis=0)
    expect = 5 * 40 + 5 * (1 + n_r)
    np.testing.assert_array_equal(s.state.grad_evals.numpy(), expect)
    assert n_r.sum() > 0
    assert float(out["cache_err"].abs().max()) < 1e-3
    assert s.grad_evals == int(expect.sum())
    torch.testing.assert_close(s.dwelling_times, out["dwell"].sum(dim=0))


def test_run_modes_agree_and_burn_in_resets():
    td = tmodels.RoughWell(ndims=2)
    st = make_mj_state(td, torch.Generator().manual_seed(1), 64)
    s1, samples = mjhmc_run(td, st, torch.Generator().manual_seed(0), 30, 1.0, 0.1, 10)
    s2, stats = mjhmc_run(td, st, torch.Generator().manual_seed(0), 30, 1.0, 0.1, 10,
                          collect="stats")
    torch.testing.assert_close(s1.chain.x, s2.chain.x, rtol=0, atol=0)
    acc = MomentAccumulator.init(2, 64)
    for x, w in zip(samples["x"], samples["dwell"]):
        acc = acc.update(x, w)
    torch.testing.assert_close(stats["moments"].var(), acc.var(), rtol=1e-6, atol=0)
    assert samples["x"].shape == (30, 2, 64) and samples["evals_mean"].shape == (30,)
    _, thinned = mjhmc_run(td, st, torch.Generator().manual_seed(0), 30, 1.0, 0.1, 10, thin=3)
    torch.testing.assert_close(thinned["x"], samples["x"][::3], rtol=0, atol=0)
    with pytest.raises(ValueError):
        mjhmc_run(td, st, None, 1, 1.0, 0.1, 10, collect="bogus")

    s = MarkovJumpHMC(td, epsilon=1.0, beta=0.1, num_leapfrog_steps=10, nbatch=32, seed=0)
    s.burn_in(5)
    assert s.grad_evals == 0 and float(s.dwelling_times.sum()) == 0.0
    out = s.sampling_iteration()
    assert out["x"].shape == (1, 2, 32) and s.grad_evals >= 32 * 10


def _gaussian_np(dist):
    prec = 1.0 / np.asarray(dist.variances, np.float64)[:, None]
    return (lambda x: 0.5 * (x * x * prec).sum(axis=0)), (lambda x: x * prec)


def test_mjhmc_matches_numpy_reference():
    """The golden check of tests/test_golden_reference.py, on the port."""
    dist = tmodels.Gaussian(ndims=2, log_conditioning=1.0)
    eps, beta, m = 0.6, 0.25, 5
    n, steps = 256, 1500

    rng = np.random.default_rng(0)
    u_fn, grad_u = _gaussian_np(dist)
    x0 = np.sqrt(np.asarray(dist.variances))[:, None] * rng.standard_normal((2, n))
    xs_np, w_np, sel_np = numpy_mjhmc(u_fn, grad_u, x0, eps, beta, m, steps, rng)

    s = MarkovJumpHMC(dist, epsilon=eps, beta=beta, num_leapfrog_steps=m, nbatch=n, seed=1)
    out = s.sample(steps)
    xs_t, w_t, sel_t = (out[k].numpy() for k in ("x", "dwell", "sel"))

    freq_np = np.bincount(sel_np.ravel(), minlength=3) / sel_np.size
    freq_t = np.bincount(sel_t.ravel().astype(np.int64), minlength=3) / sel_t.size
    np.testing.assert_allclose(freq_t, freq_np, atol=0.02)
    assert abs(w_t.mean() - w_np.mean()) < 0.03 * w_np.mean()
    assert abs(w_t.std() - w_np.std()) < 0.1 * w_np.std()

    def moments(xs, w):
        ww = w[:, None, :]
        mean = (ww * xs).sum(axis=(0, 2)) / ww.sum()
        return mean, (ww * xs**2).sum(axis=(0, 2)) / ww.sum() - mean**2

    burn = 200
    _, v_np = moments(xs_np[burn:], w_np[burn:])
    _, v_t = moments(xs_t[burn:], w_t[burn:])
    tgt = dist.analytic_var().numpy()
    np.testing.assert_allclose(v_np, tgt, rtol=0.15)
    np.testing.assert_allclose(v_t, tgt, rtol=0.15)
    np.testing.assert_allclose(v_t, v_np, rtol=0.2)

    def rho(xs, w):
        return weighted_autocorrelation(torch.as_tensor(xs, dtype=torch.float32),
                                        torch.as_tensor(w, dtype=torch.float32), nlags=40)

    diff = (rho(xs_t[burn:], w_t[burn:]) - rho(xs_np[burn:], w_np[burn:])).abs().max()
    assert float(diff) < 0.1, float(diff)
