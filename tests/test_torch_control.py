"""Control HMC in the port: the plain sampler against ``mjhmc_tpu.samplers.hmc``
with injected draws, the engines' control body (plain version of both CUDA
kernels) against the TPU kernels in Pallas interpret mode, and the CLI.

``hmc_step`` is fed the draws the JAX step makes from its own key split
(``k_noise, k_mh = split(key)``), so both sides take the same transitions:
accept decisions and counters must be equal at every step, states agree to
float32 rounding (rtol 1e-5; the rough well 5e-5, its sin differing by one
ulp between XLA and torch on ~5% of arguments).

Interpret mode returns zero PRNG bits, so every uniform of the JAX kernel is
2⁻²⁵ and every chain accepts unless it diverges; the port's
``fixed_uniform=True`` reproduces that. Counters are exact (M·steps, 2M·steps
two-stage) and Σw equals the steps exactly; states are held after 5
iterations (product of t after 3, its preset ε being chaotic) at rtol 1e-4
with atol 1e-4 of the field's largest value. With an inverse mass, √M is
``torch.rsqrt`` against ``jax.lax.rsqrt``, which may round one ulp apart:
inside the same tolerance.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.ops.pallas_mjhmc import (
    energy_spec_for,
    pallas_mjhmc_mm_run,
    pallas_mjhmc_mm_stream_run,
    pallas_mjhmc_run,
    pallas_mjhmc_stream_run,
)
from mjhmc_tpu.samplers import ControlHMC as JControlHMC
from mjhmc_tpu.samplers.state import ChainState as JChain
from mjhmc_tpu.samplers.state import HMCState as JHMCState
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.__main__ import main as cli
from mjhmc_tpu_torch.convert import hmc_state_from_jax
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm
from mjhmc_tpu_torch.samplers import ControlHMC, hmc_run, hmc_step, make_hmc_state

from test_torch_engine import _jax_state, _port_state
from test_torch_mm_engine import _jax as _mm_jax
from test_torch_mm_engine import _port as _mm_port
from test_torch_mm_engine import _specs as _mm_specs
from test_torch_mm_engine import _state as _mm_state

jhmc = importlib.import_module("mjhmc_tpu.samplers.hmc")

torch.set_num_threads(1)

IP = pltpu.InterpretParams()
N = 1024


def _start(jd, n, seed):
    rng = np.random.default_rng(seed)
    scale = np.sqrt(np.asarray(jd.analytic_var(), np.float64))[:, None]
    x = (scale * rng.standard_normal((jd.ndims, n))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, n)).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = jnp.zeros((n,), jnp.int32)
    js = JHMCState(chain=JChain(x=jnp.asarray(x), v=jnp.asarray(v), u=jnp.asarray(u),
                                grad=jnp.asarray(g)), grad_evals=z, n_accept=z)
    return js, hmc_state_from_jax(x, v, g, u)


def _close(a, b, what, rtol):
    b = np.asarray(b, np.float64).reshape(a.shape)
    np.testing.assert_allclose(a.double().numpy(), b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-30), err_msg=what)


def _mass(jd, on):
    """The Stan choice M⁻¹ = the target's variances, as (JAX, port) (d, 1)."""
    if not on:
        return None, None
    im = np.asarray(jd.analytic_var(), np.float32)[:, None]
    return jnp.asarray(im), torch.tensor(im)


@pytest.mark.parametrize("name,kw,eps,beta,m,steps,rtol,integrator,mass,rejects", [
    ("RoughWell", dict(ndims=2), 1.0, 0.2, 10, 5, 5e-5, "leapfrog", False, True),
    ("Gaussian", dict(ndims=2, log_conditioning=2.0), 1.0, 0.2, 5, 30, 1e-5, "leapfrog", True,
     True),
    ("Gaussian", dict(ndims=4, log_conditioning=2.0), 1.2, 0.5, 5, 30, 1e-5, "two_stage", True,
     True),
    # the two-stage splitting accepts every rough-well chain here
    ("RoughWell", dict(ndims=2), 1.0, 0.3, 5, 5, 5e-5, "two_stage", False, False),
])
def test_hmc_step_matches_jax_with_injected_draws(name, kw, eps, beta, m, steps, rtol,
                                                  integrator, mass, rejects):
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    n = 256
    js, ts = _start(jd, n, seed=0)
    jim, tim = _mass(jd, mass)
    key = jax.random.key(11)
    accepts = []
    for step in range(steps):
        key, k = jax.random.split(key)
        js, jo = jhmc.hmc_step(jd, js, k, eps, beta, m, 1, True, jim, integrator)
        k_noise, k_mh = jax.random.split(k)  # the draws hmc_step made
        xi = np.array(jax.random.normal(k_noise, (jd.ndims, n), jnp.float32))
        mh = np.array(jax.random.uniform(k_mh, (n,), jnp.float32))
        ts, to = hmc_step(td, ts, None, eps, beta, m, inv_mass=tim, integrator=integrator,
                          xi=torch.as_tensor(xi), mh_uniform=torch.as_tensor(mh))
        at = f"step {step}"
        np.testing.assert_array_equal(to.accept.numpy(), np.asarray(jo.accept), err_msg=at)
        np.testing.assert_array_equal(ts.grad_evals.numpy(), np.asarray(js.grad_evals), at)
        np.testing.assert_array_equal(ts.n_accept.numpy(), np.asarray(js.n_accept), at)
        for f in ("x", "v", "u", "grad"):
            _close(getattr(ts.chain, f), getattr(js.chain, f), f"{f} {at}", rtol)
        # exp(H0 − H_L): the difference of two O(10) energies carries their
        # absolute f32 rounding (~1e-6 each), amplified along the trajectory
        np.testing.assert_allclose(to.accept_stat.numpy(), np.asarray(jo.accept_stat),
                                   rtol=0, atol=1e-4, err_msg=f"accept_stat {at}")
        accepts.append(to.accept.numpy())
    acc = np.array(accepts)
    assert acc.any() and (~acc).any() == rejects, "accepted and rejected chains"
    assert int(ts.grad_evals[0]) == steps * m * (2 if integrator == "two_stage" else 1)


def test_control_hmc_object_matches_jax_statistically():
    """ControlHMC(device='cpu') with mass_diag on gauss2d: variances within
    10% of [1, 100] and of the JAX ControlHMC's, acceptance within 0.05 of
    it, counters M·steps per chain after burn_in reset them; momenta start
    in N(0, M)."""
    kw = dict(ndims=2, log_conditioning=2.0)
    args = dict(epsilon=0.8, beta=0.3, num_leapfrog_steps=5, nbatch=512,
                mass_diag=(1.0, 0.01))
    s = ControlHMC(tmodels.Gaussian(**kw), seed=2, device="cpu", **args)
    plain = ControlHMC(tmodels.Gaussian(**kw), seed=2, device="cpu",
                       **dict(args, mass_diag=None))
    torch.testing.assert_close(s.state.chain.v, plain.state.chain.v * torch.tensor([[1.0], [0.1]]),
                               rtol=1e-6, atol=0)
    s.burn_in(100)
    assert s.grad_evals == 0 and int(s.state.n_accept.sum()) == 0
    out = s.sample(300)
    assert s.grad_evals == 5 * 300 * 512 and out["x"].shape == (300, 2, 512)
    xs = out["x"].double()
    var = xs.var(dim=(0, 2)).numpy()
    np.testing.assert_allclose(var, [1.0, 100.0], rtol=0.1)

    ref = JControlHMC(jmodels.Gaussian(**kw), seed=1, **args)
    ref.burn_in(100)
    jout = ref.sample(300)
    jx = np.asarray(jout["x"], np.float64)
    np.testing.assert_allclose(var, jx.var(axis=(0, 2)), rtol=0.1)
    assert abs(float(out["accept"].float().mean()) - float(np.mean(jout["accept"]))) < 0.05


def test_hmc_run_modes_agree():
    td = tmodels.RoughWell(ndims=2)
    st = make_hmc_state(td, torch.Generator().manual_seed(1), 64)
    s1, samples = hmc_run(td, st, torch.Generator().manual_seed(0), 20, 1.0, 0.2, 10)
    s2, stats = hmc_run(td, st, torch.Generator().manual_seed(0), 20, 1.0, 0.2, 10,
                        collect="stats")
    assert torch.equal(s1.chain.x, s2.chain.x) and torch.equal(s1.n_accept, s2.n_accept)
    xs = samples["x"].double()
    torch.testing.assert_close(stats["moments"].var().double(),
                               (xs**2).mean(dim=(0, 2)) - xs.mean(dim=(0, 2))**2,
                               rtol=1e-4, atol=0)
    assert samples["accept"].shape == (20, 64) and samples["evals_mean"][-1] == 200
    with pytest.raises(ValueError):
        hmc_run(td, st, None, 1, 1.0, 0.2, 10, collect="bogus")


@pytest.mark.parametrize("name,kw,integrator,mass", [
    ("RoughWell", dict(ndims=2), "leapfrog", False),
    ("Gaussian", dict(ndims=2, log_conditioning=2.0), "two_stage", True),
])
def test_control_run_and_stream_match_interpret_kernel(name, kw, integrator, mass):
    """The elementwise kernel's control body: 100 iterations with exact
    counters (M·100, 2M·100 two-stage) and Σw = 100; run, stream and states
    after 5; emissions are the post-transition x with weight 1."""
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    jspec, tspec = energy_spec_for(jd), cm.energy_spec_for(td)
    js = _jax_state(jd, seed=2)
    ts = _port_state(js)
    im = np.asarray(jd.analytic_var(), np.float32) if mass else None
    br = dict(variant="control", integrator=integrator, inv_mass=im)
    eps, beta, m = 0.5, 0.2, 10
    cost = (2 if integrator == "two_stage" else 1) * m
    scal = (jnp.int32(7), jnp.float32(eps), jnp.float32(beta))
    out_j = pallas_mjhmc_run(jspec, *js, *scal, 100, m, interpret=IP, **br)
    out_t = cm.run_reference(tspec, *ts, 7, eps, beta, 100, m, True, **br)
    np.testing.assert_array_equal(out_t.evals.numpy(), cost * 100)
    np.testing.assert_array_equal(np.asarray(out_j.evals).ravel(), cost * 100)
    np.testing.assert_array_equal(out_t.w.numpy(), 100.0)
    xs_j, ws_j, es_j, so_j = pallas_mjhmc_stream_run(jspec, *js, *scal, 5, 1, m,
                                                     interpret=IP, **br)
    xs_t, ws_t, es_t, so_t = cm.stream_reference(tspec, *ts, 7, eps, beta, 5, 1, m, True, **br)
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(5, N))
    np.testing.assert_array_equal(ws_t.numpy(), 1.0)
    _close(xs_t, np.asarray(xs_j).reshape(5, jd.ndims, N), "stream xs", 1e-4)
    assert torch.equal(xs_t[-1], so_t.x)
    # atol 1e-4 of the largest |x| for every field, as the MJHMC engine test
    # holds them: on the rough well x/scale2 reaches ~100 rad, where sin
    # turns an ulp of x into a visible difference of the gradient
    atol = 1e-4 * float(np.abs(np.asarray(so_j.x)).max())
    for f in ("x", "v", "grad", "u", "wx", "wx2"):
        a = getattr(so_t, f)
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(so_j, f)).reshape(a.shape),
                                   rtol=1e-4, atol=atol, err_msg=f"{f} after 5")
    for f in ("h_back", "back_valid"):  # passed through
        assert torch.equal(getattr(so_t, f), ts[4 if f == "h_back" else 5])


@pytest.mark.parametrize("name,scale,eps,m,t_states,integrator,mass", [
    ("ProductOfT", 2.0, 0.2, 5, 3, "two_stage", False),
    ("SparseCoding", 0.1, 0.02, 10, 5, "leapfrog", True),
])
def test_control_mm_run_and_stream_match_interpret_kernel(name, scale, eps, m, t_states,
                                                          integrator, mass):
    """The matmul kernel's control body: counters exact over 5 iterations
    (run and stream), Σw = 5, states and emissions after ``t_states``."""
    jd, jspec, tspec = _mm_specs(name)
    st = _mm_state(jd, scale, seed=4)
    im = np.linspace(0.5, 2.0, jd.ndims).astype(np.float32) if mass else None
    br = dict(variant="control", integrator=integrator, inv_mass=im)
    cost = (2 if integrator == "two_stage" else 1) * m
    scal = (jnp.int32(7), jnp.float32(eps), jnp.float32(0.2))
    n = st[0].shape[1]
    out_j = pallas_mjhmc_mm_run(jspec, *_mm_jax(st), *scal, t_states, m, interpret=IP, **br)
    out_t = cm.run_reference(tspec, *_mm_port(st), 7, eps, 0.2, t_states, m, True, **br)
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel())
    np.testing.assert_array_equal(out_t.evals.numpy(), cost * t_states)
    for f in ("x", "v", "grad", "u", "wx", "wx2"):
        a = getattr(out_t, f)
        _close(a, np.asarray(getattr(out_j, f)).reshape(a.shape), f"{name} {f}", 1e-4)
    xs_j, _, es_j, _ = pallas_mjhmc_mm_stream_run(jspec, *_mm_jax(st), *scal, 5, 1, m,
                                                  interpret=IP, **br)
    xs_t, ws_t, es_t, so_t = cm.stream_reference(tspec, *_mm_port(st), 7, eps, 0.2, 5, 1, m,
                                                 True, **br)
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(5, n))
    np.testing.assert_array_equal(so_t.w.numpy(), 5.0)
    assert bool((ws_t == 1).all())
    _close(xs_t[:t_states], np.asarray(xs_j)[:t_states], f"{name} stream xs", 1e-4)


def test_control_engines_on_cpu():
    """CudaControlHMC(device='cpu') runs the plain version with no launch
    counted: β defaults to 0.2, initial momenta are N(0, M) with an
    inverse mass, counters are M (2M two-stage) per iteration."""
    td = tmodels.Gaussian(ndims=2, log_conditioning=2.0)
    before = [getattr(f, k) for f in cm.WRAPPERS for k in cm.COUNTS]
    eng = cm.CudaControlHMC(td, epsilon=0.5, num_leapfrog_steps=4, nbatch=64, seed=1,
                            device="cpu", inv_mass=(1.0, 100.0), integrator="two_stage")
    plain = cm.CudaControlHMC(td, epsilon=0.5, num_leapfrog_steps=4, nbatch=64, seed=1,
                              device="cpu")
    assert (eng.variant, eng.beta) == ("control", 0.2)
    torch.testing.assert_close(eng.v, plain.v / torch.tensor([[1.0], [10.0]]), rtol=1e-6, atol=0)
    eng.run(3)
    xs, ws, es = eng.sample(4, thin=2, return_evals=True)
    assert [getattr(f, k) for f in cm.WRAPPERS for k in cm.COUNTS] == before
    assert torch.equal(xs[-1], eng.last_out.x) and bool((ws == 1).all())
    assert eng.grad_evals == 2 * 4 * 11 * 64 and torch.equal(es[-1], eng.last_out.evals)


@pytest.mark.parametrize("integrator", ["leapfrog", "two_stage"])
def test_cli_sample_control(capsys, integrator):
    """`sample --sampler control` on the CUDA engine's plain version: the
    record's grad_evals is M·(burn + steps)·nbatch (2M two-stage); the
    plain sampler (--engine torch) counts the sampling steps, as JAX's CLI
    does after burn_in resets the counters."""
    base = ["sample", "--config", "gauss2d", "--sampler", "control", "--device", "cpu",
            "--nbatch", "64", "--burn", "10", "--steps", "30", "--integrator", integrator]
    k = 2 if integrator == "two_stage" else 1
    for engine, evals in (("cuda", k * 5 * 40 * 64), ("torch", k * 5 * 30 * 64)):
        cli(base + ["--engine", engine])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["sampler"] == "control" and rec["engine"] == engine
        assert rec["grad_evals"] == evals and rec["chains"] == 64 and rec["steps"] == 30
        assert all(np.isfinite(rec["var"])) and rec["ess"] > 0
