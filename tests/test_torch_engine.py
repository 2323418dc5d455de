"""The CUDA engine's plain version vs the TPU kernels in Pallas interpret mode.

Interpret mode returns zero PRNG bits, so every uniform of the JAX kernel
is 2⁻²⁵; the port's ``fixed_uniform=True`` reproduces that. Both start from
the same state, carried across with ``convert.state_from_jax``. Counters
must be exactly equal; floats agree to rtol 1e-4 (x/scale2 reaches ~100 rad,
where ulp differences in sin grow along the chaotic rough-well dynamics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.ops.pallas_mjhmc import (
    energy_spec_for,
    pallas_mjhmc_run,
    pallas_mjhmc_stream_run,
)
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.convert import state_from_jax
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

N, S = 1024, 8
L = N // S
EPS, BETA, M = 1.0, 0.1, 10
DISTS = [("RoughWell", dict(ndims=2)), ("Gaussian", dict(ndims=2, log_conditioning=2.0))]


def _jax_state(jd, seed=0):
    """Engine-layout (d, 8, L) / (8, L) state, as PallasMJHMC builds it."""
    x = jd.init_x(jax.random.key(seed), N)
    v = jax.random.normal(jax.random.key(seed + 1), x.shape, jnp.float32)
    u, g = jd.potential_and_grad(x)
    d = jd.ndims
    z = jnp.zeros((S, L), jnp.float32)
    return (x.reshape(d, S, L), v.reshape(d, S, L), g.reshape(d, S, L),
            u.reshape(S, L), z, z)


def _port_state(jstate):
    st = state_from_jax(*(np.array(a) for a in jstate))
    return (st.chain.x, st.chain.v, st.chain.grad, st.chain.u, st.h_back,
            st.back_valid.float())


def _flat(a):
    a = np.asarray(a)
    return a.reshape(a.shape[0], -1) if a.ndim == 3 else a.reshape(-1)


def _close(a, b, atol, what):
    np.testing.assert_allclose(a.numpy(), _flat(b), rtol=1e-4, atol=atol, err_msg=what)


def _close_sum(a, b, what):
    """Σw over all chains to rtol 1e-4: over 100 iterations single chains
    of the rough well may drift apart by more (chaotic dynamics)."""
    np.testing.assert_allclose(float(a.double().sum()), float(np.asarray(b, np.float64).sum()),
                               rtol=1e-4, err_msg=what)


def _pair(name, kw):
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    return energy_spec_for(jd), cm.energy_spec_for(td), jd


@pytest.mark.parametrize("name,kw", DISTS)
def test_run_matches_interpret_kernel(name, kw):
    jspec, tspec, jd = _pair(name, kw)
    js = _jax_state(jd)
    ts = _port_state(js)
    ip = pltpu.InterpretParams()
    for steps in (100, 5):
        out_j = pallas_mjhmc_run(jspec, *js, jnp.int32(7), jnp.float32(EPS),
                                 jnp.float32(BETA), steps, M, interpret=ip)
        out_t = cm.run_reference(tspec, *ts, 7, EPS, BETA, steps, M,
                                 fixed_uniform=True)
        np.testing.assert_array_equal(out_t.evals.numpy(), _flat(out_j.evals))
        np.testing.assert_array_equal(out_t.back_valid.numpy(), _flat(out_j.back_valid))
        _close_sum(out_t.w, out_j.w, f"w after {steps}")
    atol = 1e-4 * float(np.abs(_flat(out_j.x)).max())
    for field in ("x", "v", "grad", "u", "h_back", "wx", "wx2"):
        _close(getattr(out_t, field), getattr(out_j, field), atol, f"{field} after 5")
    if name == "RoughWell":
        np.testing.assert_array_equal(out_t.evals.numpy(), 5 * M + M)


@pytest.mark.parametrize("name,kw", DISTS)
def test_stream_matches_interpret_kernel(name, kw):
    jspec, tspec, jd = _pair(name, kw)
    js = _jax_state(jd, seed=3)
    ts = _port_state(js)
    ip = pltpu.InterpretParams()
    args_j = (jspec, *js, jnp.int32(7), jnp.float32(EPS), jnp.float32(BETA))
    args_t = (tspec, *ts, 7, EPS, BETA)
    # 100 iterations, every 5th emitted: counters exact
    _, _, es_j, out_j = pallas_mjhmc_stream_run(*args_j, 20, 5, M, interpret=ip)
    _, _, es_t, out_t = cm.stream_reference(*args_t, 20, 5, M, fixed_uniform=True)
    assert es_t.dtype == torch.int32 and es_t.shape == (20, N)
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(20, N))
    np.testing.assert_array_equal(es_t[-1].numpy(), out_t.evals.numpy())
    _close_sum(out_t.w, out_j.w, "w after 100")
    # 5 iterations, each emitted: emissions within tolerance
    xs_j, ws_j, _, _ = pallas_mjhmc_stream_run(*args_j, 5, 1, M, interpret=ip)
    xs_t, ws_t, _, _ = cm.stream_reference(*args_t, 5, 1, M, fixed_uniform=True)
    atol = 1e-4 * float(np.abs(np.asarray(xs_j)).max())
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j).reshape(5, jd.ndims, N),
                               rtol=1e-4, atol=atol)
    np.testing.assert_allclose(ws_t.numpy(), np.asarray(ws_j).reshape(5, N), rtol=1e-4)


def test_philox_pinned_words():
    """Random123's known-answer vectors for Philox4x32-10."""
    m = 0xFFFFFFFF
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((m, m, m, m), (m, m), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        assert tuple(int(w) for w in cm.philox4x32(ctr, key)) == want


def test_mulhilo_and_uniforms():
    """The 16-bit-limb product equals Python's exact one; a chunk of
    iterations drawn in one pass equals one-by-one draws; uniforms lie in
    (0, 1) and follow the kernel's word layout."""
    rng = np.random.default_rng(0)
    b = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.int64)
    for a in (0xD2511F53, 0xCD9E8D57, 0xFFFFFFFF):
        hi, lo = cm._mulhilo(a, torch.as_tensor(b))
        exact = [a * int(v) for v in b]
        assert hi.tolist() == [p >> 32 for p in exact]
        assert lo.tolist() == [p & 0xFFFFFFFF for p in exact]
    chunk = cm.philox_uniforms(9, range(3, 40), 17, 5, "cpu")
    one = torch.stack([cm.philox_uniforms(9, range(t, t + 1), 17, 5, "cpu")[0]
                       for t in range(3, 40)])
    assert torch.equal(chunk, one) and chunk.shape == (37, 5, 17)
    assert float(chunk.min()) > 0 and float(chunk.max()) < 1
    # word 4b+j of an iteration is output j of block b; u = f32(w>>8)·2⁻²⁴ + 2⁻²⁵
    words = cm.philox4x32((16, 39, 1, 0), (9, 0))
    want = np.float32(int(words[0]) >> 8) * np.float32(2.0**-24) + np.float32(2.0**-25)
    assert chunk[-1, 4, 16].item() == want


def test_philox_engine_gauss2d_statistics():
    """The plain version in Philox mode samples gauss2d: dwell-weighted
    variance within 15% of [1, 100]; counters are M·steps plus multiples of M."""
    td = tmodels.Gaussian(ndims=2, log_conditioning=2.0)
    eng = cm.CudaMJHMC(td, epsilon=1.0, beta=0.1, num_leapfrog_steps=5,
                       nbatch=1024, seed=3, device="cpu")
    out = eng.run(1500)
    _, var = cm.CudaMJHMC.moments(out)
    np.testing.assert_allclose(var.numpy(), [1.0, 100.0], rtol=0.15)
    extra = out.evals - 5 * 1500
    assert bool((extra >= 5).all()) and bool((extra % 5 == 0).all())
    assert int(extra.max()) > 5  # refreshes happened


def test_wrappers_route_cpu_to_plain_version():
    """CPU tensors take the plain version (identical results, no launch);
    other devices and everything outside the slice raise."""
    jspec, tspec, jd = _pair("RoughWell", dict(ndims=2))
    ts = _port_state(_jax_state(jd))
    before = (cm.cuda_mjhmc_run.launches, cm.cuda_mjhmc_stream_run.launches)
    a = cm.cuda_mjhmc_run(tspec, *ts, 5, EPS, BETA, 7, M)
    b = cm.run_reference(tspec, *ts, 5, EPS, BETA, 7, M)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    xs, ws, es, out = cm.cuda_mjhmc_stream_run(tspec, *ts, 5, EPS, BETA, 3, 2, M)
    assert xs.shape == (3, 2, N) and ws.shape == es.shape == (3, N)
    assert (cm.cuda_mjhmc_run.launches, cm.cuda_mjhmc_stream_run.launches) == before

    meta = tuple(t.to("meta") for t in ts)
    with pytest.raises(ValueError, match="cuda tensors"):
        cm.cuda_mjhmc_run(tspec, *meta, 5, EPS, BETA, 7, M)
    # the step bodies and branches that are not kernels refuse
    with pytest.raises(NotImplementedError, match="leapfrog"):
        cm.cuda_mjhmc_run(tspec, *ts, 5, EPS, BETA, 7, M, variant="malt",
                          integrator="two_stage")
    for kw in (dict(variant="hmc"), dict(integrator="yoshida"), dict(inv_mass=(1.0,) * 3)):
        with pytest.raises(ValueError):
            cm.cuda_mjhmc_run(tspec, *ts, 5, EPS, BETA, 7, M, **kw)
    with pytest.raises(NotImplementedError, match="no fused CUDA energy"):
        cm.cuda_mjhmc_run(jspec, *ts, 5, EPS, BETA, 7, M)
    with pytest.raises(NotImplementedError, match="plain samplers"):
        cm.CudaMJHMC(_Unported(), device="cpu")


class _Unported(tmodels.Distribution):
    """A distribution the engine has no energy for."""

    ndims = 2


def test_energy_specs_match_distributions():
    """Spec forms (the kernel's) agree with the models' energies."""
    for td in (tmodels.RoughWell(ndims=2), tmodels.Gaussian(ndims=50, log_conditioning=4.0)):
        spec = cm.energy_spec_for(td)
        x = td.init_x(torch.Generator().manual_seed(0), 64)
        p = torch.as_tensor(spec.param_vector(td.ndims))[:, None]
        u, g = td.potential_and_grad(x)
        torch.testing.assert_close(spec.u_sum(x, p), u, rtol=1e-5, atol=1e-5 * float(u.abs().max()))
        torch.testing.assert_close(spec.du(x, p), g, rtol=1e-5, atol=1e-5 * float(g.abs().max()))
        assert len(spec.constants()) == 5
