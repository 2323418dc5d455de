"""MALT in the port: the plain sampler against ``mjhmc_tpu.samplers.malt``
with injected draws, the engines' MALT body (plain version of both CUDA
kernels) against the TPU kernels in Pallas interpret mode, and the CLI.

``malt_step`` is fed the draws the JAX step makes from its key tree
(``k_v, k_traj, k_mh = split(key, 3)``, one ``split`` of ``k_traj`` per
leapfrog step and two O-step keys in each), so both sides take the same
transitions: accept decisions and counters must be equal, states agree to
float32 rounding (rtol 1e-5, atol of the field's largest value).

In interpret mode every uniform is 2⁻²⁵, so every O-step adds the same
normal ~5.89·√(1−η²) to every momentum and a chain accepts iff Δ < 25·ln 2.
On gauss2d at ε 0.8, γ 1.54 that splits the chains (~72% rejected), on the
rough well at ε 1, γ 0.3 with M⁻¹ = (0.5, 2) too (~39%): the tests assert
both kinds. Counters are exact (M·steps), Σw equals the steps;
states are held after 5 iterations (product of t after 3) at rtol 1e-4.
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
from mjhmc_tpu.samplers.malt import MALT as JMALT
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.__main__ import main as cli
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm
from mjhmc_tpu_torch.samplers import MALT, malt_run, malt_step, make_hmc_state

from test_torch_control import _close, _mass, _start
from test_torch_engine import _jax_state, _port_state
from test_torch_mm_engine import _jax as _mm_jax
from test_torch_mm_engine import _port as _mm_port
from test_torch_mm_engine import _specs as _mm_specs
from test_torch_mm_engine import _state as _mm_state

jmalt = importlib.import_module("mjhmc_tpu.samplers.malt")

torch.set_num_threads(1)

IP = pltpu.InterpretParams()
N = 1024


def _malt_draws(key, m, shape):
    """The JAX step's draws: v0, the 2M O-step normals in trajectory order,
    and the Metropolis uniform."""
    k_v, k_traj, k_mh = jax.random.split(key, 3)
    v0 = jax.random.normal(k_v, shape, jnp.float32)
    noise = []
    for k in jax.random.split(k_traj, m):
        k1, k2 = jax.random.split(k)
        noise += [jax.random.normal(k1, shape, jnp.float32),
                  jax.random.normal(k2, shape, jnp.float32)]
    mh = jax.random.uniform(k_mh, (shape[1],), jnp.float32)
    return (torch.as_tensor(np.array(a)) for a in (v0, jnp.stack(noise), mh))


@pytest.mark.parametrize("name,kw,eps,gamma,m,steps,rtol,mass", [
    ("RoughWell", dict(ndims=2), 1.0, 1.0, 10, 5, 5e-5, False),
    ("Gaussian", dict(ndims=2, log_conditioning=2.0), 1.5, 0.5, 5, 15, 1e-5, True),
    ("Gaussian", dict(ndims=4, log_conditioning=2.0), 0.2, 0.0, 5, 15, 1e-5, False),
])
def test_malt_step_matches_jax_with_injected_draws(name, kw, eps, gamma, m, steps, rtol, mass):
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    n = 256
    js, ts = _start(jd, n, seed=1)
    jim, tim = _mass(jd, mass)
    key = jax.random.key(5)
    accepts = []
    for step in range(steps):
        key, k = jax.random.split(key)
        js, jo = jmalt.malt_step(jd, js, k, eps, gamma, m, 1, jim)
        v0, noise, mh = _malt_draws(k, m, (jd.ndims, n))
        ts, to = malt_step(td, ts, None, eps, gamma, m, inv_mass=tim, v0=v0, noise=noise,
                           mh_uniform=mh)
        at = f"step {step}"
        np.testing.assert_array_equal(to.accept.numpy(), np.asarray(jo.accept), err_msg=at)
        np.testing.assert_array_equal(ts.grad_evals.numpy(), np.asarray(js.grad_evals), at)
        np.testing.assert_array_equal(ts.n_accept.numpy(), np.asarray(js.n_accept), at)
        for f in ("x", "v", "u", "grad"):
            _close(getattr(ts.chain, f), getattr(js.chain, f), f"{f} {at}", rtol)
        # exp(−Δ): Δ sums M energy differences of O(10) energies
        np.testing.assert_allclose(to.accept_stat.numpy(), np.asarray(jo.accept_stat),
                                   rtol=0, atol=1e-4, err_msg=f"accept_stat {at}")
        accepts.append(to.accept.numpy())
    acc = np.array(accepts)
    assert acc.any() and (~acc).any(), "both accepted and rejected chains"
    assert int(ts.grad_evals[0]) == steps * m


def test_malt_object_matches_jax_statistically():
    """MALT(device='cpu') on gauss2d with mass_diag: variances within 10% of
    [1, 100] and of the JAX MALT's; accept_rate within 0.05 of it;
    counters M·steps after burn_in; γ=0 is full-refresh HMC and samples
    the same variances."""
    kw = dict(ndims=2, log_conditioning=2.0)
    args = dict(epsilon=0.8, gamma=1.0, num_leapfrog_steps=5, nbatch=512,
                mass_diag=(1.0, 0.01))
    s = MALT(tmodels.Gaussian(**kw), seed=2, device="cpu", **args)
    s.burn_in(100)
    assert s.grad_evals == 0
    out = s.sample(300)
    assert s.grad_evals == 5 * 300 * 512 and out["accept"].shape == (300, 512)
    var = out["x"].double().var(dim=(0, 2)).numpy()
    np.testing.assert_allclose(var, [1.0, 100.0], rtol=0.1)
    ref = JMALT(jmodels.Gaussian(**kw), seed=1, **args)
    ref.burn_in(100)
    jx = np.asarray(ref.sample(300)["x"], np.float64)
    np.testing.assert_allclose(var, jx.var(axis=(0, 2)), rtol=0.1)
    assert abs(s.accept_rate - ref.accept_rate) < 0.05 and 0.3 < s.accept_rate < 1.0

    s0 = MALT(tmodels.Gaussian(**kw), seed=3, device="cpu", **dict(args, gamma=0.0))
    s0.burn_in(100)
    np.testing.assert_allclose(s0.sample(300)["x"].double().var(dim=(0, 2)).numpy(),
                               [1.0, 100.0], rtol=0.1)


def test_malt_run_modes_agree():
    td = tmodels.Gaussian(ndims=2, log_conditioning=2.0)
    st = make_hmc_state(td, torch.Generator().manual_seed(1), 64)
    s1, samples = malt_run(td, st, torch.Generator().manual_seed(0), 20, 0.5, 1.0, 5)
    s2, stats = malt_run(td, st, torch.Generator().manual_seed(0), 20, 0.5, 1.0, 5,
                         collect="stats")
    assert torch.equal(s1.chain.x, s2.chain.x) and torch.equal(s1.n_accept, s2.n_accept)
    xs = samples["x"].double()
    torch.testing.assert_close(stats["moments"].var().double(),
                               (xs**2).mean(dim=(0, 2)) - xs.mean(dim=(0, 2))**2,
                               rtol=1e-4, atol=0)
    assert samples["evals_mean"][-1] == 100


@pytest.mark.parametrize("name,kw,eps,gamma,mass", [
    ("Gaussian", dict(ndims=2, log_conditioning=2.0), 0.8, 1.54, None),
    ("RoughWell", dict(ndims=2), 1.0, 0.3, (0.5, 2.0)),
])
def test_malt_run_and_stream_match_interpret_kernel(name, kw, eps, gamma, mass):
    """The elementwise kernel's MALT body (β carries γ): 100 iterations with
    exact counters M·100 and Σw = 100; run, stream and states after 5. A
    rejected chain keeps x and takes −v0, the fixed-uniform normal times √M."""
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    jspec, tspec = energy_spec_for(jd), cm.energy_spec_for(td)
    js = _jax_state(jd, seed=2)
    ts = _port_state(js)
    im = None if mass is None else np.asarray(mass, np.float32)
    br = dict(variant="malt", inv_mass=im)
    m = 10
    scal = (jnp.int32(7), jnp.float32(eps), jnp.float32(gamma))
    out_j = pallas_mjhmc_run(jspec, *js, *scal, 100, m, interpret=IP, **br)
    out_t = cm.run_reference(tspec, *ts, 7, eps, gamma, 100, m, True, **br)
    np.testing.assert_array_equal(out_t.evals.numpy(), m * 100)
    np.testing.assert_array_equal(np.asarray(out_j.evals).ravel(), m * 100)
    np.testing.assert_array_equal(out_t.w.numpy(), 100.0)
    xs_j, _, es_j, so_j = pallas_mjhmc_stream_run(jspec, *js, *scal, 5, 1, m, interpret=IP, **br)
    xs_t, ws_t, es_t, so_t = cm.stream_reference(tspec, *ts, 7, eps, gamma, 5, 1, m, True, **br)
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(5, N))
    np.testing.assert_array_equal(ws_t.numpy(), 1.0)
    _close(xs_t, np.asarray(xs_j).reshape(5, jd.ndims, N), "stream xs", 1e-4)
    # atol 1e-4 of the largest |x| for every field, as the MJHMC engine test
    # holds them: on the rough well x/scale2 reaches ~100 rad, where sin
    # turns an ulp of x into a visible difference of the gradient
    atol = 1e-4 * float(np.abs(np.asarray(so_j.x)).max())
    for f in ("x", "v", "grad", "u", "wx", "wx2"):
        a = getattr(so_t, f)
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(so_j, f)).reshape(a.shape),
                                   rtol=1e-4, atol=atol, err_msg=f"{f} after 5")
    v0 = cm._box_muller(torch.full((2 * jd.ndims, 1), cm.FIXED_UNIFORM), jd.ndims)
    if im is not None:
        v0 = v0 * torch.rsqrt(torch.tensor(im))[:, None]
    rejected = (so_t.v == -v0).all(dim=0)
    rejected_j = np.isclose(np.asarray(so_j.v).reshape(jd.ndims, N), -v0.numpy(),
                            rtol=1e-6, atol=0).all(axis=0)
    np.testing.assert_array_equal(rejected.numpy(), rejected_j)
    assert bool(rejected.any()) and bool((~rejected).any()), "both kinds of chains"


@pytest.mark.parametrize("name,scale,eps,gamma,m,t_states,mass", [
    ("ProductOfT", 2.0, 0.05, 1.0, 5, 3, True),
    ("SparseCoding", 0.1, 0.02, 1.0, 10, 5, False),
])
def test_malt_mm_run_and_stream_match_interpret_kernel(name, scale, eps, gamma, m, t_states,
                                                       mass):
    """The matmul kernel's MALT body: counters exact (run and stream), Σw =
    steps, states and emissions after ``t_states``."""
    jd, jspec, tspec = _mm_specs(name)
    st = _mm_state(jd, scale, seed=4)
    im = np.linspace(0.5, 2.0, jd.ndims).astype(np.float32) if mass else None
    br = dict(variant="malt", inv_mass=im)
    scal = (jnp.int32(7), jnp.float32(eps), jnp.float32(gamma))
    n = st[0].shape[1]
    out_j = pallas_mjhmc_mm_run(jspec, *_mm_jax(st), *scal, t_states, m, interpret=IP, **br)
    out_t = cm.run_reference(tspec, *_mm_port(st), 7, eps, gamma, t_states, m, True, **br)
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel())
    np.testing.assert_array_equal(out_t.evals.numpy(), m * t_states)
    for f in ("x", "v", "grad", "u", "wx", "wx2"):
        a = getattr(out_t, f)
        _close(a, np.asarray(getattr(out_j, f)).reshape(a.shape), f"{name} {f}", 1e-4)
    xs_j, _, es_j, _ = pallas_mjhmc_mm_stream_run(jspec, *_mm_jax(st), *scal, 5, 1, m,
                                                  interpret=IP, **br)
    xs_t, ws_t, es_t, so_t = cm.stream_reference(tspec, *_mm_port(st), 7, eps, gamma, 5, 1, m,
                                                 True, **br)
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(5, n))
    np.testing.assert_array_equal(so_t.w.numpy(), 5.0)
    assert bool((ws_t == 1).all())
    _close(xs_t[:t_states], np.asarray(xs_j)[:t_states], f"{name} stream xs", 1e-4)


def test_malt_engine_on_cpu_and_refusals():
    """CudaMALT(device='cpu'): β (γ) defaults to 1, counters M per
    iteration, weight-1 post-transition emissions, no launch counted; the
    two-stage integrator is refused by the engine, the wrappers and the
    plain version alike, as the JAX engine refuses it."""
    td = tmodels.RoughWell(ndims=2)
    before = [getattr(f, k) for f in cm.WRAPPERS for k in cm.COUNTS]
    eng = cm.CudaMALT(td, epsilon=0.5, num_leapfrog_steps=4, nbatch=64, seed=1, device="cpu")
    assert (eng.variant, eng.beta) == ("malt", 1.0)
    eng.run(3)
    xs, ws, es = eng.sample(4, thin=2, return_evals=True)
    assert [getattr(f, k) for f in cm.WRAPPERS for k in cm.COUNTS] == before
    assert torch.equal(xs[-1], eng.last_out.x) and bool((ws == 1).all())
    assert eng.grad_evals == 4 * 11 * 64
    with pytest.raises(NotImplementedError, match="leapfrog"):
        cm.CudaMALT(td, nbatch=64, device="cpu", integrator="two_stage")
    spec = cm.energy_spec_for(td)
    with pytest.raises(NotImplementedError, match="leapfrog"):
        cm.cuda_mjhmc_stream_run(spec, *eng._state(), 1, 0.5, 1.0, 1, 1, 4, variant="malt",
                                 integrator="two_stage")
    with pytest.raises(NotImplementedError, match="leapfrog"):
        cm.run_reference(spec, *eng._state(), 1, 0.5, 1.0, 1, 4, variant="malt",
                         integrator="two_stage")


def test_cli_sample_malt(capsys):
    """`sample --sampler malt --gamma`: the engine's record counts
    M·(burn + steps)·nbatch, the plain sampler's M·steps·nbatch (burn_in
    resets it, as in JAX); two-stage MALT exits with the reason."""
    base = ["sample", "--config", "gauss2d", "--sampler", "malt", "--gamma", "0.5",
            "--device", "cpu", "--nbatch", "64", "--burn", "10", "--steps", "30"]
    for engine, evals in (("cuda", 5 * 40 * 64), ("torch", 5 * 30 * 64)):
        cli(base + ["--engine", engine])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["sampler"] == "malt" and rec["engine"] == engine
        assert rec["grad_evals"] == evals and rec["chains"] == 64
        assert all(np.isfinite(rec["var"])) and rec["ess"] > 0
    with pytest.raises(SystemExit, match="leapfrog"):
        cli(base + ["--engine", "cuda", "--integrator", "two_stage"])
