"""Bayesian logistic regression in the port: the model against
``mjhmc_tpu.models.logreg``, ``LogregSpec`` against the JAX spec, the
matmul engine's MJHMC, control and MALT bodies on it (plain version) against
the TPU kernels in Pallas interpret mode, and the CLI.

The design matrix and labels come from the same NumPy code, so they are
equal array for array. Energies and gradients are held at rtol 1e-5, the
spec forms at rtol 1e-4 (as ``tests/test_pallas_engine.py`` holds the JAX
spec to its model), the Laplace oracle at rtol 1e-6 (the same float64
NumPy). Interpret mode returns zero PRNG bits, so every uniform of the JAX
kernel is 2⁻²⁵; the port's ``fixed_uniform=True`` reproduces that. The
bodies run at 64 observations (the kernel's preset is 256), 128 chains and
4 iterations against ``precision="highest"``: counters exact, states and
dwell sums within rtol 1e-4 (atol 1e-4 of the field's largest value).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjhmc_tpu.models.logreg import LogisticRegression as JLogreg
from mjhmc_tpu.ops.pallas_mjhmc import (
    energy_spec_for,
    pallas_mjhmc_mm_run,
    pallas_mjhmc_mm_stream_run,
)
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.__main__ import main as cli
from mjhmc_tpu_torch.convert import distribution_from_jax
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

IP = pltpu.InterpretParams()
N, NOBS, STEPS = 128, 64, 4


def _x(d, n, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((d, n))).astype(np.float32)


def _close(a, b, what, rtol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64).reshape(a.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(), err_msg=what)


@pytest.mark.parametrize("kw", [{}, dict(ndims=8, nobs=64, prior_scale=2.0, data_seed=3)])
def test_model_matches_jax(kw):
    jd, td = JLogreg(**kw), tmodels.LogisticRegression(**kw)
    for a, b in zip(td._data, jd._data):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x = _x(td.ndims, 64, 1, scale=2.0)
    uj, gj = jd.potential_and_grad(jnp.asarray(x))
    ut, gt = td.potential_and_grad(torch.as_tensor(x))
    _close(ut.numpy(), uj, "u", 1e-5)
    _close(gt.numpy(), gj, "grad", 1e-5)
    _close(td.potential(torch.as_tensor(x)).numpy(), jd.potential(jnp.asarray(x)), "potential",
           1e-5)
    np.testing.assert_allclose(td.map_estimate(), jd.map_estimate(), rtol=1e-6)
    np.testing.assert_allclose(td.laplace_var(), jd.laplace_var(), rtol=1e-6)
    assert td.stable_hash() == jd.stable_hash()
    assert distribution_from_jax(jd.config_dict()) == td
    assert isinstance(tmodels.get_distribution("logreg", **kw), tmodels.LogisticRegression)


def test_spec_matches_jax_spec():
    jd, td = JLogreg(ndims=16, nobs=NOBS), tmodels.LogisticRegression(ndims=16, nobs=NOBS)
    jspec = dataclasses.replace(energy_spec_for(jd), precision="highest")
    tspec = dataclasses.replace(cm.energy_spec_for(td), precision="highest")
    assert isinstance(tspec, cm.LogregSpec) and tspec.aux_rows() == NOBS
    (xs_t,), (xs_j,) = tspec.param_arrays(), jspec.param_arrays()
    np.testing.assert_array_equal(xs_t, np.asarray(xs_j))
    x = _x(16, N, 2, scale=2.0)
    p = torch.as_tensor(xs_t)
    _close(tspec.u_sum(torch.as_tensor(x), p).numpy(),
           jspec.u_sum(jnp.asarray(x), jnp.asarray(xs_j)), "u_sum", 1e-4)
    _close(tspec.du(torch.as_tensor(x), p).numpy(),
           jspec.du(jnp.asarray(x), jnp.asarray(xs_j)), "du", 1e-4)
    # the spec's forms are the model's energy
    u, g = td.potential_and_grad(torch.as_tensor(x))
    _close(tspec.u_sum(torch.as_tensor(x), p).numpy(), u.numpy(), "u_sum vs model", 1e-5)
    _close(tspec.du(torch.as_tensor(x), p).numpy(), g.numpy(), "du vs model", 1e-5)
    s = 1.0 / td.prior_scale**2
    assert tspec.constants() == (s, 0.5 * s, 0.0, 0.0)


def _start(jd, seed):
    x = _x(jd.ndims, N, seed)
    v = _x(jd.ndims, N, seed + 100)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = np.zeros(N, np.float32)
    js = (jnp.asarray(x), jnp.asarray(v), jnp.asarray(g), jnp.asarray(u)[None],
          jnp.zeros((1, N)), jnp.zeros((1, N)))
    ts = tuple(torch.as_tensor(a) for a in (x, v, g, u, z, z.copy()))
    return js, ts


@pytest.mark.parametrize("variant,beta", [("mjhmc", 0.1), ("control", 0.2), ("malt", 1.0)])
def test_bodies_match_interpret_kernels(variant, beta):
    """Run and stream: counters and stream es exact, x, v, g, u, xs and
    the dwell sums within rtol 1e-4."""
    jd, td = JLogreg(ndims=16, nobs=NOBS), tmodels.LogisticRegression(ndims=16, nobs=NOBS)
    jspec = dataclasses.replace(energy_spec_for(jd), precision="highest")
    tspec = dataclasses.replace(cm.energy_spec_for(td), precision="highest")
    js, ts = _start(jd, 3)
    m, eps = 6, 0.15
    out_j = pallas_mjhmc_mm_run(jspec, *js, jnp.int32(7), jnp.float32(eps), jnp.float32(beta),
                                STEPS, m, interpret=IP, variant=variant)
    out_t = cm.run_reference(tspec, *ts, 7, eps, beta, STEPS, m, fixed_uniform=True,
                             variant=variant)
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel())
    assert int(out_t.evals.min()) >= STEPS * m
    for f in ("x", "v", "grad", "u"):
        _close(getattr(out_t, f).numpy(), getattr(out_j, f), f"{variant} {f}", 1e-4)
    _close(out_t.w.double().sum().numpy(), np.asarray(out_j.w, np.float64).sum(), "Σw", 1e-4)
    for f in ("wx", "wx2"):
        _close(getattr(out_t, f).double().sum(1).numpy(),
               np.asarray(getattr(out_j, f), np.float64).sum(1), f"Σ{f}", 1e-4)

    xs_j, ws_j, es_j, _ = pallas_mjhmc_mm_stream_run(
        jspec, *js, jnp.int32(11), jnp.float32(eps), jnp.float32(beta), STEPS, 1, m,
        interpret=IP, variant=variant)
    xs_t, ws_t, es_t, so_t = cm.stream_reference(tspec, *ts, 11, eps, beta, STEPS, 1, m,
                                                 fixed_uniform=True, variant=variant)
    assert xs_t.shape == (STEPS, 16, N) and es_t.dtype == torch.int32
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(STEPS, N))
    np.testing.assert_array_equal(es_t[-1].numpy(), so_t.evals.numpy())
    _close(xs_t.numpy(), xs_j, f"{variant} xs", 1e-4)
    _close(ws_t.double().sum(1).numpy(), np.asarray(ws_j, np.float64).reshape(STEPS, N).sum(1),
           "Σws", 1e-4)


def test_engine_routes_logreg_to_the_matmul_kernel():
    """CudaMJHMC(device='cpu') on logreg takes the matmul wrappers' plain
    version (no launch counted); another shape, (16, 64), passes the shape
    check (an on-demand instance runs it on the card) and stops only at the
    device check on meta tensors."""
    td = tmodels.LogisticRegression()
    eng = cm.CudaMJHMC(td, epsilon=0.15, beta=0.1, num_leapfrog_steps=6, nbatch=64,
                       device="cpu")
    assert eng._matmul and eng.x.shape == (16, 64)
    before = {k: getattr(cm.cuda_mjhmc_mm_run, k) for k in cm.COUNTS}
    out = eng.run(3)
    assert {k: getattr(cm.cuda_mjhmc_mm_run, k) for k in cm.COUNTS} == before
    assert bool(torch.isfinite(out.x).all()) and int(out.evals.min()) >= 18
    small = cm.energy_spec_for(tmodels.LogisticRegression(nobs=64))
    ts = tuple(t.to("meta") for t in (eng.x, eng.v, eng.g, eng.u, eng.h_back, eng.back_valid))
    assert not cm.mm_compiled_ahead(small, sweep_run=False)
    with pytest.raises(ValueError, match="cuda tensors"):
        cm.cuda_mjhmc_mm_run(small, *ts, 5, 0.15, 0.1, 3, 6)
    with pytest.raises(ValueError, match="cuda tensors"):
        cm.cuda_mjhmc_mm_run(eng.spec, *ts, 5, 0.15, 0.1, 3, 6)


@pytest.mark.parametrize("sampler", ["mjhmc", "control", "malt", "nuts"])
def test_cli_sample_logreg(sampler, capsys):
    """`sample --config logreg --engine cuda --device cpu`: the JAX record's
    keys; grad_evals M·(burn + steps)·nbatch for control and MALT, the
    integrated leaves for NUTS, M per iteration plus rebuilds for MJHMC."""
    burn, steps, n = 5, 10, 32
    cli(["sample", "--config", "logreg", "--engine", "cuda", "--device", "cpu", "--sampler",
         sampler, "--nbatch", str(n), "--burn", str(burn), "--steps", str(steps)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"config", "sampler", "engine", "steps", "chains", "grad_evals", "mean",
                        "var", "ess", "ess_per_grad_eval"}
    assert rec["sampler"] == sampler and rec["chains"] == n and len(rec["var"]) == 8
    assert all(np.isfinite(rec["var"])) and rec["ess"] > 0
    ge, m = rec["grad_evals"], 6
    if sampler in ("control", "malt"):
        assert ge == m * (burn + steps) * n
    elif sampler == "mjhmc":
        assert ge >= m * (burn + steps) * n and ge % m == 0
    else:
        assert (burn + steps) * n <= ge <= (burn + steps) * n * 255
