"""The matmul engine's plain version vs the TPU kernels in Pallas interpret
mode (``pallas_mjhmc_mm_run`` / ``pallas_mjhmc_mm_stream_run``).

Interpret mode returns zero PRNG bits, so every uniform of the JAX kernel
is 2⁻²⁵; the port's ``fixed_uniform=True`` reproduces that. Both start from
the same NumPy-made state. Counters and the cache flags must be exactly
equal. Floats are held at rtol 1e-4 with atol 1e-4 of the field's largest
value, against ``precision="highest"`` (full f32 products):

- sparse coding at 5 iterations;
- product of t at 3: at the preset's ε=0.2 the leapfrog is unstable along
  W's stiffest direction near y = 0 (ε·ω ≈ 2.4 > 2), so the last-ulp
  differences of two f32 summation orders grow ~6× per iteration and pass
  1e-4 on ~30% of chains by iteration 5 (torch and XLA on the CPU, as the
  kernel and cuBLAS on the card);
- dwell sums over all chains (Σw, and Σw·x, Σw·x² per dim), not per chain:
  a chain's dwell weight hangs on H differences of O(1) between energies of
  O(10³), whose f32 rounding moves single weights by ~1e-3.

Sparse coding is also held against its TPU default ``"bf16x3"`` (three
bf16 passes, the lo·lo term dropped, ~2⁻¹⁶ relative per product, and the
fit term multiplies residual errors by σ⁻² = 100), the port at
``"bf16x3"`` too: counters exact, states at the same tolerance; the dwell
sums at rtol 1e-4 or at twice the spread one-ulp nudges of x put into
Σw in the plain version alone, if more (a bf16 split is not continuous:
measured 2.1e-4 apart here at 5 iterations, where a nudge alone moves Σw by
3.0e-4). The other precisions are in test_torch_mm_precision.py.
"""

import dataclasses
import json
import os
import subprocess
import sys

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
)
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.__main__ import main as cli
from mjhmc_tpu_torch.convert import state_from_jax
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256
# name, init scale, (ε, M) of the preset, iterations at which states are held
SPECS = [("ProductOfT", 2.0, 0.2, 5, 3), ("SparseCoding", 0.1, 0.02, 10, 5)]
IP = pltpu.InterpretParams()


def _state(jd, scale, seed=0):
    """(d, n) / (n,) NumPy state: x from the init's scale, v ~ N(0, I)."""
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((jd.ndims, N))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, N)).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = np.zeros(N, np.float32)
    return x, v, g, u, z, z.copy()


def _jax(state):
    x, v, g, u, hb, bv = (jnp.asarray(a) for a in state)
    return x, v, g, u[None], hb[None], bv[None]  # scalars (1, n)


def _port(state):
    return tuple(torch.as_tensor(a) for a in state)


def _specs(name, precision="highest"):
    jd, td = getattr(jmodels, name)(), getattr(tmodels, name)()
    jspec = dataclasses.replace(energy_spec_for(jd), precision=precision)
    return jd, jspec, dataclasses.replace(cm.energy_spec_for(td), precision=precision)


def _close(a, b, what, rtol=1e-4):
    b = np.asarray(b, np.float64).reshape(a.shape)
    np.testing.assert_allclose(a.double().numpy(), b, rtol=rtol,
                               atol=rtol * np.abs(b).max(), err_msg=what)


def _counters(out_t, out_j, what, w_rtol=1e-4):
    """Counters and cache flags exact; Σw over all chains."""
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel(), what)
    np.testing.assert_array_equal(out_t.back_valid.numpy(),
                                  np.asarray(out_j.back_valid).ravel(), what)
    _close(out_t.w.double().sum(), np.asarray(out_j.w, np.float64).sum(), f"{what} Σw", w_rtol)


def _states(out_t, out_j, what, fields=("x", "v", "grad", "u", "h_back"), w_rtol=1e-4):
    """States per element; Σw·x and Σw·x² per dim over all chains."""
    for f in fields:
        _close(getattr(out_t, f), getattr(out_j, f), f"{what} {f}")
    for f in ("wx", "wx2"):
        _close(getattr(out_t, f).double().sum(1), np.asarray(getattr(out_j, f),
               np.float64).sum(1), f"{what} Σ{f}", w_rtol)


@pytest.mark.parametrize("name,scale,eps,m,t_states", SPECS)
def test_mm_run_matches_interpret_kernel(name, scale, eps, m, t_states):
    jd, jspec, tspec = _specs(name)
    st = _state(jd, scale)
    scal = (jnp.int32(7), jnp.float32(eps), jnp.float32(0.1))
    for steps in sorted({5, t_states}):
        out_j = pallas_mjhmc_mm_run(jspec, *_jax(st), *scal, steps, m, interpret=IP)
        out_t = cm.run_reference(tspec, *_port(st), 7, eps, 0.1, steps, m,
                                 fixed_uniform=True)
        _counters(out_t, out_j, f"{name} after {steps}")
        if steps == t_states:
            _states(out_t, out_j, f"{name} after {steps}")
    assert int(out_t.evals.min()) >= 5 * m + m


@pytest.mark.parametrize("name,scale,eps,m,t_states", SPECS)
def test_mm_stream_matches_interpret_kernel(name, scale, eps, m, t_states):
    """5 emissions, thin 1: es exact (es[-1] the run's counters); xs of the
    first t_states iterations within tolerance; Σws per emission rtol 1e-4;
    no row padding left in the emissions."""
    jd, jspec, tspec = _specs(name)
    st = _state(jd, scale, seed=3)
    xs_j, ws_j, es_j, out_j = pallas_mjhmc_mm_stream_run(
        jspec, *_jax(st), jnp.int32(11), jnp.float32(eps), jnp.float32(0.1), 5, 1, m,
        interpret=IP)
    xs_t, ws_t, es_t, out_t = cm.stream_reference(tspec, *_port(st), 11, eps, 0.1,
                                                  5, 1, m, fixed_uniform=True)
    assert xs_t.shape == (5, jd.ndims, N) and ws_t.shape == es_t.shape == (5, N)
    assert es_t.dtype == torch.int32
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(5, N))
    np.testing.assert_array_equal(es_t[-1].numpy(), out_t.evals.numpy())
    _counters(out_t, out_j, f"{name} stream")
    _close(xs_t[:t_states], np.asarray(xs_j)[:t_states], "xs")
    _close(ws_t.double().sum(1), np.asarray(ws_j, np.float64).reshape(5, N).sum(1), "Σws")


def test_sparse_coding_matches_bf16x3_default():
    jd, jspec, tspec = _specs("SparseCoding", precision="bf16x3")
    st = _state(jd, 0.1, seed=5)
    out_j = pallas_mjhmc_mm_run(jspec, *_jax(st), jnp.int32(7), jnp.float32(0.02),
                                jnp.float32(0.1), 5, 10, interpret=IP)
    out_t = cm.run_reference(tspec, *_port(st), 7, 0.02, 0.1, 5, 10,
                             fixed_uniform=True)
    assert tspec.precision == "bf16x3"
    # the dwell sums at rtol 1e-4, or at twice the spread that one-ulp
    # nudges of x put into Σw in the plain version alone, if more
    # (test_torch_mm_precision.py's module docstring)
    spread = 0.0
    for to in (float("inf"), float("-inf")):
        x_n = torch.nextafter(_port(st)[0], torch.full_like(_port(st)[0], to))
        out_n = cm.run_reference(tspec, x_n, *_port(st)[1:], 7, 0.02, 0.1, 5, 10,
                                 fixed_uniform=True)
        dw = (out_n.w.double() - out_t.w.double()).square().sum().sqrt()
        spread = max(spread, float(dw / out_t.w.double().sum()))
    w_rtol = max(1e-4, 2 * spread)
    _counters(out_t, out_j, "bf16x3", w_rtol)
    _states(out_t, out_j, "bf16x3", ("x", "v", "grad", "u"), w_rtol)


@pytest.mark.parametrize("name,scale,eps,m,t_states", SPECS)
def test_engine_run_and_sample_match_interpret_kernels(name, scale, eps, m, t_states):
    """CudaMJHMC(device='cpu') takes the matmul path: run + sample from a
    carried-over JAX state give the two interpret-mode kernels' exact
    counters, with no kernel launch counted."""
    jd, jspec, _ = _specs(name)
    st = _state(jd, scale, seed=6)
    scal = (jnp.int32(1), jnp.float32(eps), jnp.float32(0.1))
    out_j = pallas_mjhmc_mm_run(jspec, *_jax(st), *scal, 2, m, interpret=IP)
    _, _, es_j, _ = pallas_mjhmc_mm_stream_run(jspec, *out_j[:6], *scal, 2, 2, m,
                                               interpret=IP)
    eng = cm.CudaMJHMC(getattr(tmodels, name)(), epsilon=eps, beta=0.1,
                       num_leapfrog_steps=m, nbatch=N, device="cpu", fixed_uniform=True)
    assert eng._matmul and eng.x.shape == (jd.ndims, N)
    eng.spec = dataclasses.replace(eng.spec, precision="highest")  # as jspec
    eng.load_state(state_from_jax(*st))
    before = (cm.cuda_mjhmc_mm_run.launches, cm.cuda_mjhmc_mm_stream_run.launches)
    out_t = eng.run(2)
    xs_t, ws_t, es_t = eng.sample(2, thin=2, return_evals=True)
    assert (cm.cuda_mjhmc_mm_run.launches, cm.cuda_mjhmc_mm_stream_run.launches) == before
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel())
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(2, N))
    assert eng.grad_evals == int(np.asarray(out_j.evals).sum() + np.asarray(es_j[-1]).sum())
    assert eng.steps_total == 6 and xs_t.shape == (2, jd.ndims, N)
    mean, var = cm.CudaMJHMC.moments(eng.last_out)
    assert mean.shape == var.shape == (jd.ndims,) and bool(torch.isfinite(var).all())


def test_mm_wrappers_route_and_refuse():
    """CPU tensors take the plain version with no launch; each wrapper takes
    only its own kernel's specs; what is not ported raises."""
    jd, jspec, tspec = _specs("ProductOfT")
    ts = _port(_state(jd, 2.0))
    a = cm.cuda_mjhmc_mm_run(tspec, *ts, 5, 0.2, 0.1, 3, 5)
    b = cm.run_reference(tspec, *ts, 5, 0.2, 0.1, 3, 5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    xs, ws, es, _ = cm.cuda_mjhmc_mm_stream_run(tspec, *ts, 5, 0.2, 0.1, 3, 2, 5)
    assert xs.shape == (3, 36, N) and ws.shape == es.shape == (3, N)
    with pytest.raises(ValueError, match="other kernel"):
        cm.cuda_mjhmc_run(tspec, *ts, 5, 0.2, 0.1, 3, 5)
    rw = cm.energy_spec_for(tmodels.RoughWell())
    with pytest.raises(ValueError, match="other kernel"):
        cm.cuda_mjhmc_mm_stream_run(rw, *ts, 5, 1.0, 0.1, 3, 1, 5)
    with pytest.raises(NotImplementedError, match="no fused CUDA energy"):
        cm.cuda_mjhmc_mm_run(jspec, *ts, 5, 0.2, 0.1, 3, 5)
    a = cm.cuda_mjhmc_mm_run(tspec, *ts, 5, 0.2, 0.1, 3, 5, variant="nuts")
    b = cm.run_reference(tspec, *ts, 5, 0.2, 0.1, 3, 5, variant="nuts")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(NotImplementedError, match="leapfrog"):
        cm.cuda_mjhmc_mm_run(tspec, *ts, 5, 0.2, 0.1, 3, 5, variant="malt",
                             integrator="two_stage")
    with pytest.raises(NotImplementedError, match="stub_dots"):
        cm.cuda_mjhmc_mm_run(cm.ProductOfTSpec(tmodels.ProductOfT(), stub_dots=True), *ts,
                             5, 0.2, 0.1, 3, 5, variant="control")
    with pytest.raises(ValueError, match="cuda tensors"):
        cm.cuda_mjhmc_mm_run(tspec, *(t.to("meta") for t in ts), 5, 0.2, 0.1, 3, 5)


def test_cli_sample_product_of_t_subprocess(tmp_path):
    """`sample --config product_of_t --engine cuda --device cpu`: a
    well-formed record whose grad_evals is the sum of the per-chain
    counters, each M·(burn + steps) plus multiples of M."""
    save = tmp_path / "s.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "mjhmc_tpu_torch", "sample", "--config", "product_of_t",
         "--engine", "cuda", "--device", "cpu", "--nbatch", "256", "--burn", "40",
         "--steps", "60", "--save", str(save)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["config"] == "product_of_t" and rec["engine"] == "cuda"
    assert rec["chains"] == 256 and rec["steps"] == 60
    assert len(rec["var"]) == len(rec["mean"]) == 8 and all(np.isfinite(rec["var"]))
    assert rec["ess"] > 0
    data = np.load(save)
    evals = data["evals"]
    assert rec["grad_evals"] == int(evals.sum())
    extra = evals - 5 * 100
    assert (extra >= 5).all() and (extra % 5 == 0).all()
    assert data["x"].shape == (60, 36, 256) and data["dwell"].shape == (60, 256)


def test_cli_plain_sampler_sparse_coding(capsys):
    cli(["sample", "--config", "sparse_coding", "--engine", "torch", "--device", "cpu",
         "--steps", "8", "--burn", "4", "--nbatch", "32"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["engine"] == "torch" and rec["chains"] == 32
    assert rec["grad_evals"] >= 8 * 32 * 10 and all(np.isfinite(rec["var"]))


#: the presets' chains (mjhmc_tpu_torch/config.py), the H100's SMs and its
#: shared memory: an SM's 228 KB, a block's 227 KB at most, 1 KB an SM
#: reserves for each resident block
PRESET_CHAINS = {"ProductOfT": 4096, "SparseCoding": 8192, "LogisticRegression": 2048}
SMS, SMEM_SM, SMEM_BLOCK, SMEM_RESERVED = 132, 233472, 232448, 1024
#: every run instance of mm_kernel: (model, precision, body, with the branches)
MM_INSTANCES = [(name, prec, body, br)
                for name, precs in (("ProductOfT", ("highest", "default")),
                                    ("SparseCoding", ("highest", "bf16x3")),
                                    ("LogisticRegression", ("highest", "default")))
                for prec in precs
                for body, br in (("mjhmc", False), ("mjhmc", True), ("control", True),
                                 ("malt", True))]
MM_INSTANCES += [("ProductOfT", p, "mjhmc", False) for p in ("bf16x3", "bf16x2")]
MM_INSTANCES += [("SparseCoding", p, "mjhmc", False) for p in ("bf16x2", "default")]


@pytest.mark.parametrize("name,precision,body,branches", MM_INSTANCES,
                         ids=[" ".join(map(str, k)) for k in MM_INSTANCES])
def test_mm_tiles_fill_the_card(name, precision, body, branches):
    """mm_kernel's tile mirror (``mm_tile_rule``, ``mm_smem_bytes``): a chain's
    threads own whole groups of four dims and whole rows of the
    intermediate, the columns fill mma n-tiles of 8 and the operand rows
    are NC + 4 floats; at the preset's chains the grid has at least 2 × 132
    blocks (logreg's control and MALT: 256 at the 8-column n-tile, the most
    2,048 chains give), two blocks fit an SM's shared memory and one stays
    under 227 KB. (Phase 2 of chip_smoke.py holds the mirror to the
    library's own bytes and blocks an SM.)"""
    spec = dataclasses.replace(cm.energy_spec_for(getattr(tmodels, name)()),
                               precision=precision)
    chains, threads = cm.mm_tile_rule(spec, body)[:2]
    d, k = cm.MM_KERNEL_SHAPES[type(spec)]
    nc = 2 * chains if body == "mjhmc" else chains
    rows_owners = threads // chains
    dim_owners = min(rows_owners, d // 4)
    assert threads % chains == 0 and threads % 32 == 0 and nc % 8 == 0
    assert (d // 4) % dim_owners == 0 and k % rows_owners == 0
    bytes_ = cm.mm_smem_bytes(spec, body, branches)
    # the operands X (d rows) and Y or Z (k rows) at NC + 4 floats a row
    assert bytes_ >= 4 * (d + k) * (nc + 4)
    blocks = -(-PRESET_CHAINS[name] // chains)
    assert blocks >= (256 if (name, body) in {("LogisticRegression", "control"),
                                              ("LogisticRegression", "malt")} else 2 * SMS)
    assert 2 * (bytes_ + SMEM_RESERVED) <= SMEM_SM and bytes_ < SMEM_BLOCK


@pytest.mark.parametrize("body", ["mjhmc", "control", "malt refresh", "malt noise"])
def test_philox_blocks_give_the_owner_groups_words(body):
    """The kernel's owner of dims i..i+3 (i % 4 == 0) takes their normals'
    words from whole Philox blocks where the plain version draws word by
    word: words i..i+3 and D+i..D+i+3 (control tag 4, MALT's refresh tag 5
    at slot 0, MALT's O-step o tag 6 at slot o·ceil(2D/4)) are one block
    each, MJHMC's 1+i..4+i and 1+D+i..4+D+i words 1-3 of one block and word
    0 of the next. Held at sparse coding's D = 128 and product of t's 36,
    against ``philox_uniforms`` (word k from output k % 4 of slot k // 4)."""
    seed, n, t = 12345, 5, 3
    for d in (128, 36):
        nblocks = (2 * d + 3) // 4
        tag, slot0, w0 = {"mjhmc": (0, 0, 1), "control": (4, 0, 0), "malt refresh": (5, 0, 0),
                          "malt noise": (6, 7 * nblocks, 0)}[body]
        nwords = slot0 * 4 + w0 + 2 * d + 1
        single = cm.philox_uniforms(seed, range(t, t + 1), n, nwords, "cpu", tag=tag)[0]
        single = single[slot0 * 4:]  # the draw's words from its first slot
        for i in range(0, d, 4):
            for base in (w0 + i, w0 + d + i):
                first = base // 4
                blocks = [torch.stack(cm.philox_block(seed, n, t, slot0 + b, tag, "cpu"))
                          for b in (first, first + 1)]
                got = torch.cat(blocks)[base % 4:base % 4 + 4]
                assert torch.equal(cm._uniform_of(got), single[base:base + 4]), (d, i, base)
