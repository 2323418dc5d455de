"""The ceiling probes' plain versions (``ops/ceilings.py``) vs the JAX
dossier's Pallas probes themselves (root ``bench_mfu.py``), run on the CPU
in TPU interpret mode.

``bench_mfu._force`` is patched to capture each call's output: the
two-point timer calls the low-iteration kernel four times, then the
high-iteration one four times. The inputs are rebuilt from the probes' own
NumPy seeds. Tolerances:

- ``fma_chain``: rtol 1e-5 (the chain is contractive: |d/dx| <= 0.51);
- ``tc_chain``: within 1e-2 of the output's largest value. The port rounds
  both operands to bf16 before each product, as one bf16 MXU pass does on
  the TPU; XLA on the CPU multiplies in f32, which moved the chain by
  1.7e-3 after 1 iteration and 3.5e-3 after 3 at depth 36.

A NumPy bf16 chain pins the plain version's rounding exactly.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bench_mfu
from mjhmc_tpu_torch.ops import ceilings as ce

torch.set_num_threads(1)


def _probe_outputs(monkeypatch, probe, **kw):
    """(low-iteration output, high-iteration output) of a JAX probe."""
    outs = []
    monkeypatch.setattr(bench_mfu, "_force", lambda out: outs.append(np.asarray(out)))
    with pltpu.force_tpu_interpret_mode():
        probe(**kw)
    assert len(outs) == 8
    return outs[0], outs[-1]


def _vpu_inputs(rows, lanes):
    rng = np.random.default_rng(1)
    a = np.asarray(0.5 + 0.01 * rng.random((rows, lanes)), np.float32)
    b = np.asarray(0.1 * rng.random((rows, lanes)), np.float32)
    return torch.as_tensor(a), torch.as_tensor(b)


def _mxu_inputs(depth, lanes):
    rng = np.random.default_rng(0)
    w = np.asarray(rng.normal(size=(depth, depth)) / np.sqrt(depth), np.float32)
    b = np.asarray(rng.normal(size=(depth, lanes)), np.float32)
    return torch.as_tensor(w), torch.as_tensor(b)


@pytest.mark.parametrize("transcendental", [False, True])
def test_fma_chain_matches_jax_probe(monkeypatch, transcendental):
    rows, lanes, lo, hi = 8, 128, 16, 32
    out_lo, out_hi = _probe_outputs(
        monkeypatch, bench_mfu.measure_vpu_ceiling, rows=rows, lanes=lanes,
        iters_lo=lo, iters_hi=hi, transcendental=transcendental)
    if transcendental:  # the JAX probe runs an eighth of the iterations
        lo, hi = lo // 8, hi // 8
    a, b = _vpu_inputs(rows, lanes)
    for iters, want in ((lo, out_lo), (hi, out_hi)):
        got = ce.fma_chain_reference(a, b, iters, transcendental)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("depth", [36, 80])
def test_tc_chain_matches_jax_probe(monkeypatch, depth):
    lanes = 128
    out_lo, out_hi = _probe_outputs(monkeypatch, bench_mfu.measure_mxu_ceiling,
                                    depth=depth, lanes=lanes, iters_lo=1, iters_hi=3)
    w, b = _mxu_inputs(depth, lanes)
    for iters, want in ((1, out_lo), (3, out_hi)):
        got = ce.tc_chain_reference(w, b, iters).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())


def _bf16(x):
    """Round f32 to bf16 (nearest-even) and back, in NumPy."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def test_tc_chain_reference_rounds_operands_to_bf16():
    w, b = _mxu_inputs(36, 64)
    wb, c = _bf16(w.numpy()).astype(np.float64), np.float32(1.0 / 36)
    chains = [b.numpy() + np.float32(i) for i in range(4)]
    for _ in range(3):
        chains = [(wb @ _bf16(x).astype(np.float64)).astype(np.float32) * c for x in chains]
    want = ((chains[0] + chains[1]) + chains[2]) + chains[3]
    got = ce.tc_chain_reference(w, b, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    # the rounding matters: the same chain without it lands elsewhere
    plain = [b.numpy() + np.float32(i) for i in range(4)]
    for _ in range(3):
        plain = [(w.numpy() @ x) * c for x in plain]
    assert np.abs(got - sum(plain)).max() > 1e-4 * np.abs(want).max()


def test_ceiling_wrappers_route_cpu_to_plain_version():
    a, b = _vpu_inputs(4, 32)
    w, bb = _mxu_inputs(16, 32)
    before = (ce.fma_chain.launches, ce.tc_chain.launches)
    assert torch.equal(ce.fma_chain(a, b, 7, True), ce.fma_chain_reference(a, b, 7, True))
    assert torch.equal(ce.tc_chain(w, bb, 2), ce.tc_chain_reference(w, bb, 2))
    assert (ce.fma_chain.launches, ce.tc_chain.launches) == before
    with pytest.raises(ValueError, match="cuda tensors"):
        ce.fma_chain(a.to("meta"), b.to("meta"), 3)
    with pytest.raises(ValueError, match="cuda tensors"):
        ce.tc_chain(w.to("meta"), bb.to("meta"), 3)


def test_tc_flop_count_is_the_jax_formula():
    """2·depth²·lanes per chain, four chains, the unpadded depth
    (bench_mfu.py:138); the scale is the f32 of 1/depth."""
    assert ce.tc_flops_per_iteration(36, 128) == 2.0 * 36 * 36 * 128 * 4
    assert ce.tc_scale(36) == float(np.float32(1 / 36))
