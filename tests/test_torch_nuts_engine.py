"""The NUTS engine's plain version vs the TPU kernels' NUTS variant in
Pallas interpret mode (``pallas_mjhmc_run`` / ``pallas_mjhmc_stream_run``
with ``variant="nuts"``), and its law in Philox mode.

Interpret mode returns zero PRNG bits, so every uniform of the JAX kernel
is 2⁻²⁵ (every round goes right); the port's ``fixed_uniform=True``
reproduces that. The arguments are those of
``test_interpret_mode_nuts_invariants`` (Gaussian(2, 1.0), ε 0.4,
max_depth 5) at 5 steps. Leaf counts must be exactly equal, x, v, g, u
within rtol 1e-5 (atol 1e-5 of the field's largest value). The backward
branch runs only in Philox mode, which the statistical test covers: the
plain version's variances on gauss2d within 12% of analytic and its mean
leaves per iteration within 10% of the JAX ``samplers.NUTS`` at the same
ε and max_depth.
"""

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
    pallas_mjhmc_run,
    pallas_mjhmc_stream_run,
)
from mjhmc_tpu.samplers import NUTS
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.__main__ import main as cli
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

N, S = 1024, 8
L = N // S
EPS, DEPTH, STEPS = 0.4, 5, 5
IP = pltpu.InterpretParams()


def _case(name="Gaussian", **kw):
    kw = kw or dict(ndims=2, log_conditioning=1.0)
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    x = np.array(jd.init_x(jax.random.key(0), N))
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = np.zeros(N, np.float32)
    state = (x, np.zeros_like(x), g, u, z, z.copy())
    d = jd.ndims
    js = (jnp.asarray(x).reshape(d, S, L), jnp.zeros((d, S, L)), jnp.asarray(g).reshape(d, S, L),
          jnp.asarray(u).reshape(S, L), jnp.zeros((S, L)), jnp.zeros((S, L)))
    ts = tuple(torch.as_tensor(a) for a in state)
    return energy_spec_for(jd), cm.energy_spec_for(td), js, ts


def _close(a, b, what, rtol=1e-5):
    b = np.asarray(b, np.float64).reshape(a.shape)
    np.testing.assert_allclose(a.double().numpy(), b, rtol=rtol,
                               atol=rtol * np.abs(b).max(), err_msg=what)


@pytest.mark.parametrize("name,kw,eps,steps", [
    ("Gaussian", {}, EPS, STEPS),
    # one iteration: the rough well's trajectories are chaotic at ε 1 and
    # its sin differs by one ulp between XLA and torch on ~5% of arguments
    # (ROADMAP §3)
    ("RoughWell", dict(ndims=2), 1.0, 1),
])
def test_nuts_run_matches_interpret_kernel(name, kw, eps, steps, rtol=1e-5):
    jspec, tspec, js, ts = _case(name, **kw)
    out_j = pallas_mjhmc_run(jspec, *js, jnp.int32(7), jnp.float32(eps), jnp.float32(0.0),
                             steps, DEPTH, interpret=IP, variant="nuts")
    out_t = cm.run_reference(tspec, *ts, 7, eps, 0.0, steps, DEPTH, fixed_uniform=True,
                             variant="nuts")
    assert out_t.evals.dtype == torch.int32
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel())
    assert int(out_t.evals.min()) >= steps and int(out_t.evals.max()) <= steps * (2**DEPTH - 1)
    np.testing.assert_array_equal(out_t.w.numpy(), float(steps))
    np.testing.assert_array_equal(np.asarray(out_j.w).ravel(), float(steps))
    for f in ("x", "v", "grad", "u", "wx", "wx2"):
        _close(getattr(out_t, f), getattr(out_j, f), f"{name} {f}", rtol)
    for f in ("h_back", "back_valid"):  # passed through
        assert torch.equal(getattr(out_t, f), ts[4 if f == "h_back" else 5])


def test_nuts_stream_matches_interpret_kernel():
    """3 emissions at thin 2: post-transition xs, unit ws, cumulative leaf
    counts exact, es[-1] the run's counters."""
    jspec, tspec, js, ts = _case()
    xs_j, ws_j, es_j, out_j = pallas_mjhmc_stream_run(
        jspec, *js, jnp.int32(11), jnp.float32(EPS), jnp.float32(0.0), 3, 2, DEPTH,
        interpret=IP, variant="nuts")
    xs_t, ws_t, es_t, out_t = cm.stream_reference(tspec, *ts, 11, EPS, 0.0, 3, 2, DEPTH,
                                                  fixed_uniform=True, variant="nuts")
    assert xs_t.shape == (3, 2, N) and ws_t.shape == es_t.shape == (3, N)
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(3, N))
    np.testing.assert_array_equal(es_t[-1].numpy(), out_t.evals.numpy())
    np.testing.assert_array_equal(ws_t.numpy(), 1.0)
    np.testing.assert_array_equal(np.asarray(ws_j).reshape(3, N), 1.0)
    _close(xs_t, np.asarray(xs_j).reshape(3, 2, N), "xs")
    _close(xs_t[-1], out_j.x, "xs[-1] vs x")


def test_nuts_plain_philox_statistics():
    """Philox mode on gauss2d (variances [1, 100]) at ε 1, max_depth 6."""
    kw = dict(ndims=2, log_conditioning=2.0)
    eps, depth, burn, steps = 1.0, 6, 30, 150
    eng = cm.CudaNUTS(tmodels.Gaussian(**kw), epsilon=eps, num_leapfrog_steps=depth,
                      nbatch=512, seed=4, device="cpu")
    eng.run(burn)
    out = eng.run(steps)
    _, var = cm.CudaMJHMC.moments(out)
    np.testing.assert_allclose(var.numpy(), [1.0, 100.0], rtol=0.12)
    leaves = float(out.evals.double().mean()) / steps

    ref = NUTS(jmodels.Gaussian(**kw), epsilon=eps, max_depth=depth, nbatch=512, seed=1)
    ref.burn_in(burn)
    ev = np.asarray(ref.sample(steps)["evals_mean"])
    leaves_xla = float(ev[-1] - ev[0]) / (steps - 1)
    assert abs(leaves / leaves_xla - 1) < 0.1, (leaves, leaves_xla)


@pytest.mark.parametrize("ndims", [1, 2, 50])
def test_nuts_sums_over_dims_in_kernel_order(ndims):
    """The plain versions of the elementwise energies and the NUTS tree
    sum over dims row after row from 0, as the kernels do, at any number of
    columns (one chain included); with at most two rows that is torch's
    sum."""
    for cols in (1, 3, 257):
        t = torch.as_tensor(np.random.default_rng(ndims).normal(size=(3, ndims, cols)),
                            dtype=torch.float32)
        want = np.zeros((3, cols), np.float32)
        for row in t.numpy().transpose(1, 0, 2):
            want = want + row
        got = cm._sum_dims_in_order(t)
        np.testing.assert_array_equal(got.numpy(), want)
        if ndims <= 2:
            assert torch.equal(got, t.sum(dim=-2))
    g = cm.GaussianSpec(tuple(np.linspace(0.5, 2.0, ndims)))
    p = torch.as_tensor(g.param_vector(ndims))[:, None]
    np.testing.assert_array_equal(g.u_sum(t, p).numpy(),
                                  np.float32(0.5) * cm._sum_dims_in_order(t * t * p).numpy())


def test_cuda_nuts_engine_on_cpu():
    """CudaNUTS(device='cpu'): run and sample take the NUTS plain version
    (no launch counted); emissions are post-transition with weight 1."""
    eng = cm.CudaNUTS(tmodels.Gaussian(ndims=2, log_conditioning=2.0), epsilon=0.5,
                      num_leapfrog_steps=4, nbatch=64, seed=2, device="cpu")
    assert (eng.variant, eng.num_leapfrog_steps, eng.beta) == ("nuts", 4, 0.0)
    counts = [(f, k) for f in (cm.cuda_mjhmc_run, cm.cuda_mjhmc_stream_run)
              for k in ("launches", "nuts_launches")]
    before = [getattr(f, k) for f, k in counts]
    eng.run(3)
    xs, ws, es = eng.sample(4, thin=2, return_evals=True)
    assert [getattr(f, k) for f, k in counts] == before
    out = eng.last_out
    assert torch.equal(xs[-1], out.x) and torch.equal(es[-1], out.evals)
    assert bool((ws == 1).all()) and bool((out.w == 8).all())
    assert eng.steps_total == 11 and eng.grad_evals >= 11 * 64
    assert bool((out.evals <= 8 * 15).all())


def test_nuts_routing_and_refusals():
    jspec, tspec, js, ts = _case()
    a = cm.cuda_mjhmc_run(tspec, *ts, 5, EPS, 0.0, 2, DEPTH, variant="nuts")
    b = cm.run_reference(tspec, *ts, 5, EPS, 0.0, 2, DEPTH, variant="nuts")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    xs, ws, es, _ = cm.cuda_mjhmc_stream_run(tspec, *ts, 5, EPS, 0.0, 2, 1, DEPTH,
                                             variant="nuts")
    assert torch.equal(es, cm.stream_reference(tspec, *ts, 5, EPS, 0.0, 2, 1, DEPTH,
                                               variant="nuts")[2])
    # matmul energies take the matmul kernel's NUTS body
    assert cm.CudaNUTS(tmodels.ProductOfT(), nbatch=8, device="cpu")._matmul
    pot = cm.energy_spec_for(tmodels.ProductOfT())
    with pytest.raises(ValueError, match="other kernel"):
        cm.cuda_mjhmc_run(pot, *ts, 5, EPS, 0.0, 2, DEPTH, variant="nuts")
    for variant in ("control", "malt"):  # ported: the CPU takes their plain versions
        a = cm.cuda_mjhmc_run(tspec, *ts, 5, EPS, 0.5, 2, DEPTH, variant=variant)
        b = cm.run_reference(tspec, *ts, 5, EPS, 0.5, 2, DEPTH, variant=variant)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(NotImplementedError, match="leapfrog"):
        cm.cuda_mjhmc_run(tspec, *ts, 5, EPS, 0.0, 2, DEPTH, variant="nuts",
                          integrator="two_stage")
    with pytest.raises(NotImplementedError, match="leapfrog"):
        cm.run_reference(tspec, *ts, 5, EPS, 0.0, 2, DEPTH, integrator="two_stage", variant="nuts")
    with pytest.raises(ValueError, match="cuda tensors"):
        cm.cuda_mjhmc_run(tspec, *(t.to("meta") for t in ts), 5, EPS, 0.0, 2, DEPTH,
                          variant="nuts")


def test_cli_sample_nuts(capsys):
    cli(["sample", "--config", "gauss2d", "--engine", "cuda", "--sampler", "nuts",
         "--device", "cpu", "--nbatch", "64", "--burn", "10", "--steps", "30"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["sampler"] == "nuts" and rec["engine"] == "cuda" and rec["chains"] == 64
    assert rec["steps"] == 30 and rec["grad_evals"] >= 40 * 64
    assert len(rec["var"]) == 2 and all(np.isfinite(rec["var"])) and rec["ess"] > 0
    cli(["sample", "--config", "gauss2d", "--engine", "torch", "--sampler", "nuts",
         "--device", "cpu", "--nbatch", "16", "--burn", "2", "--steps", "5"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["sampler"] == "nuts" and rec["engine"] == "torch" and rec["grad_evals"] >= 5 * 16
