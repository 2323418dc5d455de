"""The two branches of every engine body in the port — the BCSS two-stage
integrator and a diagonal inverse mass — against the TPU kernels in Pallas
interpret mode, and the plain MJHMC sampler's ``inv_mass``/``mass_diag``
against ``mjhmc_tpu.samplers.mjhmc`` with injected draws.

Interpret mode returns zero PRNG bits (every uniform 2⁻²⁵); the port's
``fixed_uniform=True`` reproduces that. MJHMC counters equal the JAX
kernel's exactly; without a mass MJHMC always takes L, so they are M·steps
+ M, and under two-stage 2M·steps + 2M (the one fresh backward rebuild at
step 0), as ``test_interpret_mode_two_stage_counters`` pins for the JAX
kernel (with a mass, momenta drawn from N(0, I) make some chains refresh). NUTS leaf counts are exact and its states agree to
rtol 1e-5. Other states are held after 5 iterations (product of t after
3) at rtol 1e-4, atol 1e-4 of the largest |x|; √M is ``torch.rsqrt``
against ``jax.lax.rsqrt``, one ulp apart at most, inside that tolerance.
"""

import importlib
import re

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
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.convert import hmc_state_from_jax
from mjhmc_tpu_torch.ops import _build
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm
from mjhmc_tpu_torch.samplers import MarkovJumpHMC, mjhmc_step

from test_torch_engine import _jax_state, _port_state
from test_torch_mjhmc import _start
from test_torch_mm_engine import _jax as _mm_jax
from test_torch_mm_engine import _port as _mm_port
from test_torch_mm_engine import _specs as _mm_specs
from test_torch_mm_engine import _state as _mm_state

jmj = importlib.import_module("mjhmc_tpu.samplers.mjhmc")

torch.set_num_threads(1)

IP = pltpu.InterpretParams()
N = 1024


def _assert_states(out_t, out_j, fields, what):
    atol = 1e-4 * float(np.abs(np.asarray(out_j.x)).max())
    for f in fields:
        a = getattr(out_t, f)
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(out_j, f)).reshape(a.shape),
                                   rtol=1e-4, atol=atol, err_msg=f"{what} {f}")


@pytest.mark.parametrize("name,kw,eps,m,integrator,mass", [
    ("RoughWell", dict(ndims=2), 0.4, 5, "two_stage", None),
    ("Gaussian", dict(ndims=2, log_conditioning=2.0), 1.0, 10, "leapfrog", (1.0, 100.0)),
    ("Gaussian", dict(ndims=2, log_conditioning=2.0), 1.0, 5, "two_stage", (0.5, 50.0)),
])
def test_mjhmc_branches_match_interpret_kernel(name, kw, eps, m, integrator, mass):
    """The elementwise kernel's MJHMC body with each branch: 50 iterations
    with exact counters and Σw over all chains to rtol 1e-4, states and the
    stream after 5."""
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    jspec, tspec = energy_spec_for(jd), cm.energy_spec_for(td)
    js = _jax_state(jd, seed=1)
    ts = _port_state(js)
    im = None if mass is None else np.asarray(mass, np.float32)
    br = dict(integrator=integrator, inv_mass=im)
    cost = (2 if integrator == "two_stage" else 1) * m
    scal = (jnp.int32(7), jnp.float32(eps), jnp.float32(0.1))
    out_j = pallas_mjhmc_run(jspec, *js, *scal, 50, m, interpret=IP, **br)
    out_t = cm.run_reference(tspec, *ts, 7, eps, 0.1, 50, m, True, **br)
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel())
    if mass is None:  # L every time: one rebuild at step 0
        np.testing.assert_array_equal(out_t.evals.numpy(), cost * 50 + cost)
    np.testing.assert_allclose(float(out_t.w.double().sum()),
                               float(np.asarray(out_j.w, np.float64).sum()), rtol=1e-4)
    xs_j, ws_j, es_j, so_j = pallas_mjhmc_stream_run(jspec, *js, *scal, 5, 1, m,
                                                     interpret=IP, **br)
    xs_t, ws_t, es_t, so_t = cm.stream_reference(tspec, *ts, 7, eps, 0.1, 5, 1, m, True, **br)
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(5, N))
    np.testing.assert_allclose(ws_t.numpy(), np.asarray(ws_j).reshape(5, N), rtol=1e-4)
    _assert_states(so_t, so_j, ("x", "v", "grad", "u", "h_back", "wx", "wx2"), f"{name} after 5")
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j).reshape(5, jd.ndims, N), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(xs_j)).max()))


@pytest.mark.parametrize("name,scale,eps,m,t_states,integrator,mass", [
    ("ProductOfT", 2.0, 0.2, 5, 3, "two_stage", None),
    ("SparseCoding", 0.1, 0.02, 10, 5, "leapfrog", "linspace"),
])
def test_mjhmc_mm_branches_match_interpret_kernel(name, scale, eps, m, t_states, integrator,
                                                  mass):
    """The matmul kernel's MJHMC body with each branch (two-stage: two
    contractions per gradient, no pair form): counters and cache flags
    exact, states after ``t_states``, Σw·x and Σw·x² per dim, the stream's
    counters."""
    jd, jspec, tspec = _mm_specs(name)
    st = _mm_state(jd, scale, seed=7)
    im = np.linspace(0.5, 2.0, jd.ndims).astype(np.float32) if mass else None
    br = dict(integrator=integrator, inv_mass=im)
    cost = (2 if integrator == "two_stage" else 1) * m
    scal = (jnp.int32(7), jnp.float32(eps), jnp.float32(0.1))
    out_j = pallas_mjhmc_mm_run(jspec, *_mm_jax(st), *scal, t_states, m, interpret=IP, **br)
    out_t = cm.run_reference(tspec, *_mm_port(st), 7, eps, 0.1, t_states, m, True, **br)
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel())
    if mass is None:  # L every time: one rebuild at step 0
        np.testing.assert_array_equal(out_t.evals.numpy(), cost * t_states + cost)
    np.testing.assert_array_equal(out_t.back_valid.numpy(), np.asarray(out_j.back_valid).ravel())
    _assert_states(out_t, out_j, ("x", "v", "grad", "u", "h_back"), name)
    for f in ("wx", "wx2"):
        np.testing.assert_allclose(getattr(out_t, f).double().sum(1).numpy(),
                                   np.asarray(getattr(out_j, f), np.float64).sum(1), rtol=1e-4)
    _, _, es_j, _ = pallas_mjhmc_mm_stream_run(jspec, *_mm_jax(st), *scal, 2, 2, m,
                                               interpret=IP, **br)
    _, _, es_t, _ = cm.stream_reference(tspec, *_mm_port(st), 7, eps, 0.1, 2, 2, m, True, **br)
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(2, -1))


@pytest.mark.parametrize("name,kw,eps,steps,mass", [
    ("Gaussian", dict(ndims=2, log_conditioning=1.0), 0.4, 5, (0.5, 3.0)),
    ("RoughWell", dict(ndims=2), 1.0, 1, (2.0, 0.5)),
])
def test_nuts_inv_mass_matches_interpret_kernel(name, kw, eps, steps, mass):
    """The NUTS body with an inverse mass (in ½vᵀM⁻¹v, the U-turn dot
    products, the drift and the momentum draw): leaf counts exact, weight-1
    emissions, states and stream to rtol 1e-5."""
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    jspec, tspec = energy_spec_for(jd), cm.energy_spec_for(td)
    js = _jax_state(jd, seed=3)
    ts = _port_state(js)
    im = np.asarray(mass, np.float32)
    scal = (jnp.int32(7), jnp.float32(eps), jnp.float32(0.0))
    depth = 5
    out_j = pallas_mjhmc_run(jspec, *js, *scal, steps, depth, interpret=IP, variant="nuts",
                             inv_mass=im)
    out_t = cm.run_reference(tspec, *ts, 7, eps, 0.0, steps, depth, True, inv_mass=im,
                             variant="nuts")
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel())
    assert int(out_t.evals.max()) > steps  # trees grew
    atol = 1e-5 * float(np.abs(np.asarray(out_j.x)).max())
    for f in ("x", "v", "grad", "u", "wx", "wx2"):
        a = getattr(out_t, f)
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(out_j, f)).reshape(a.shape),
                                   rtol=1e-5, atol=atol, err_msg=f"{name} {f}")
    xs_j, _, es_j, _ = pallas_mjhmc_stream_run(jspec, *js, *scal, steps, 1, depth,
                                               interpret=IP, variant="nuts", inv_mass=im)
    xs_t, ws_t, es_t, _ = cm.stream_reference(tspec, *ts, 7, eps, 0.0, steps, 1, depth,
                                              True, inv_mass=im, variant="nuts")
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(steps, N))
    assert bool((ws_t == 1).all())
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j).reshape(steps, jd.ndims, N),
                               rtol=1e-5, atol=atol)


def test_mjhmc_step_inv_mass_matches_jax_with_injected_draws():
    """mjhmc_step with a diagonal M⁻¹ (the plain sampler's mass_diag path):
    the same transitions and counters as the JAX step fed the same draws."""
    kw = dict(ndims=2, log_conditioning=2.0)
    jd, td = jmodels.Gaussian(**kw), tmodels.Gaussian(**kw)
    n, eps, beta, m = 256, 1.0, 0.2, 5
    js, ts = _start(jd, n, seed=3)
    im = np.asarray([[1.0], [100.0]], np.float32)
    key = jax.random.key(2)
    for step in range(20):
        key, k = jax.random.split(key)
        js, jo = jmj.mjhmc_step(jd, js, k, eps, beta, m, inv_mass=jnp.asarray(im))
        k_gum, k_refresh = jax.random.split(k)
        gum = np.array(jax.random.gumbel(k_gum, (3, n), jnp.float32))
        xi = np.array(jax.random.normal(k_refresh, (2, n), jnp.float32))
        ts, to = mjhmc_step(td, ts, None, eps, beta, m, inv_mass=torch.tensor(im),
                            gumbel=torch.as_tensor(gum), xi=torch.as_tensor(xi))
        np.testing.assert_array_equal(to.sel.numpy(), np.asarray(jo.sel), err_msg=f"{step}")
        np.testing.assert_array_equal(ts.grad_evals.numpy(), np.asarray(js.grad_evals))
        for f in ("x", "v", "u", "grad"):
            b = np.asarray(getattr(js.chain, f))
            np.testing.assert_allclose(getattr(ts.chain, f).numpy(), b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max(), err_msg=f"{f} {step}")


def test_markov_jump_hmc_mass_diag():
    """MarkovJumpHMC(mass_diag=M) starts momenta in N(0, M) and samples an
    ill-conditioned Gaussian preconditioned to isotropy."""
    td = tmodels.Gaussian(ndims=2, log_conditioning=2.0)
    args = dict(epsilon=1.0, beta=0.1, num_leapfrog_steps=5, nbatch=256, seed=4, device="cpu")
    s = MarkovJumpHMC(td, mass_diag=(1.0, 0.01), **args)
    plain = MarkovJumpHMC(td, **args)
    torch.testing.assert_close(s.state.chain.v, plain.state.chain.v * torch.tensor([[1.0], [0.1]]),
                               rtol=1e-6, atol=0)
    s.burn_in(100)
    out = s.sample(400)
    w = out["dwell"].double()[:, None, :]
    xs = out["x"].double()
    mean = (w * xs).sum(dim=(0, 2)) / w.sum()
    var = (w * xs * xs).sum(dim=(0, 2)) / w.sum() - mean**2
    np.testing.assert_allclose(var.numpy(), [1.0, 100.0], rtol=0.15)


def test_cuda_engine_inv_mass_initial_momenta():
    """CudaMJHMC(inv_mass=M⁻¹) draws its initial momenta from N(0, M), as
    PallasMJHMC does, and refuses an inverse mass of the wrong length."""
    td = tmodels.Gaussian(ndims=2, log_conditioning=2.0)
    a = cm.CudaMJHMC(td, nbatch=64, seed=3, device="cpu", inv_mass=(4.0, 0.25))
    b = cm.CudaMJHMC(td, nbatch=64, seed=3, device="cpu")
    torch.testing.assert_close(a.v, b.v / torch.tensor([[2.0], [0.5]]), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="entries"):
        cm.cuda_mjhmc_run(a.spec, *a._state(), 1, 1.0, 0.1, 1, 5, inv_mass=(1.0, 2.0, 3.0))


def test_hmc_state_from_jax_takes_both_layouts():
    rng = np.random.default_rng(0)
    x, v, g = (rng.standard_normal((2, 8, 16)).astype(np.float32) for _ in range(3))
    u = rng.standard_normal((8, 16)).astype(np.float32)
    st = hmc_state_from_jax(x, v, g, u, n_accept=np.ones((128,), np.int32))
    assert st.chain.x.shape == (2, 128) and st.chain.u.shape == (128,)
    np.testing.assert_array_equal(st.chain.x.numpy(), x.reshape(2, 128))
    assert st.grad_evals.dtype == torch.int32 and int(st.grad_evals.sum()) == 0
    assert int(st.n_accept.sum()) == 128


def test_build_parts_match_the_sources():
    """The build compiles every kernel source, and each kernel instance the
    engine header leaves to another source (``extern template``) is
    instantiated in exactly one of them."""
    assert set(_build.KERNEL_SOURCES) == {p.name for p in _build.CSRC.glob("*.cu")}
    assert "mjhmc_engine.cu" in _build.KERNEL_SOURCES
    header = (_build.CSRC / "mjhmc_engine.cuh").read_text()
    declared = re.findall(r"extern template Launch launch_instance<([^>]+)>;", header)
    # the D=50 instances (4 MJHMC, 4 NUTS, 2 control, 2 MALT) and the zoo
    # instances (2 MJHMC, 2 NUTS, control and MALT for each of the five
    # (energy, D) pairs)
    assert len(declared) == 12 + 5 * 6
    for inst in declared:
        where = [name for name in _build.KERNEL_SOURCES
                 if f"template Launch launch_instance<{inst}>;" in (_build.CSRC / name).read_text()]
        assert len(where) == 1, (inst, where)
    # each NUTS instance's tile query beside it, and the two PROF instances
    tiles = re.findall(r"extern template cudaError_t nuts_tile<([^>]+)>\(int, int, int\*\);", header)
    assert sorted(tiles) == sorted(i[len("kNuts, "):] for i in declared if i.startswith("kNuts, "))
    profs = re.findall(r"extern template cudaError_t launch_nuts_prof<([^>]+)>", header)
    assert sorted(profs) == ["10, kFunnel", "2, kGaussian"]
    # the D=50 NUTS instances' emitting kernels, each in a source of its own
    emits = re.findall(r"extern template cudaError_t launch_nuts<([^>]+)>\(const Args&", header)
    assert sorted(emits) == sorted(f"50, {e}, true, {br}" for e in ("kGaussian", "kRoughWell")
                                   for br in ("false", "true"))
    for decl, insts in (("cudaError_t nuts_tile<{}>(int, int, int*);", tiles),
                        ("cudaError_t launch_nuts_prof<{}>(const Args&, cudaStream_t);", profs),
                        ("cudaError_t launch_nuts<{}>(const Args&, cudaStream_t);", emits)):
        for inst in insts:
            where = [name for name in _build.KERNEL_SOURCES
                     if f"template {decl.format(inst)}" in (_build.CSRC / name).read_text()]
            assert len(where) == 1, (inst, where)
    # the matmul kernel: every body of each energy at full f32 and at the
    # preset's JAX default precision, and the sweep's four MJHMC runs
    mm = (_build.CSRC / "mjhmc_mm_engine.cuh").read_text()
    declared = re.findall(r"extern template Instance (\w+_instance<[^>]+>)\(\);", mm)
    assert len(declared) == 2 * 3 * 4 + 4 and len(set(declared)) == len(declared)
    for inst in declared:
        where = [name for name in _build.KERNEL_SOURCES
                 if f"template Instance {inst}();" in (_build.CSRC / name).read_text()]
        assert len(where) == 1, (inst, where)
