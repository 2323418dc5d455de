"""NUTS on the matmul engine: its plain version against the TPU kernels'
NUTS body in Pallas interpret mode (``pallas_mjhmc_mm_run`` /
``pallas_mjhmc_mm_stream_run`` with ``variant="nuts"``) on the three
matmul energies, and the wrappers' routing.

Interpret mode returns zero PRNG bits, so every uniform of the JAX kernel is
2⁻²⁵ (every round goes right, every leaf is taken); the port's
``fixed_uniform=True`` reproduces that. Both sides start from the same
NumPy-made state and run 128 chains, against ``precision="highest"`` (full
float32 products): product of t at ε 0.12 (stable: ε·ω ≈ 1.2 < 2),
max_depth 4 and 2 iterations, sparse coding at ε 0.02, max_depth 4 and 3
iterations, logistic regression (16 features, 64 observations) at ε 0.15,
max_depth 5 and 3 iterations. Product of t is held for fewer leaves: with
every uniform 2⁻²⁵ each iteration's momentum is 5.9 in every dim and every
leaf is taken, so its chains fly out into the heavy tails along full
trees, where last-ulp differences of two summation orders grow past 1e-4
within ~60 leaves (x and g on 7 of 8 chains by 3 iterations of 31 leaves).
The two sum their products in different orders, and a tree decision can
flip with the last ulp of H, so leaf counts must be equal on ≥ 0.99 of the
chains and x, v, g, u, the stream's xs and the moments within rtol 1e-4
(atol 1e-4 of the field's largest value) on those.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.models.logreg import LogisticRegression as JLogreg
from mjhmc_tpu.ops.pallas_mjhmc import (
    energy_spec_for,
    pallas_mjhmc_mm_run,
    pallas_mjhmc_mm_stream_run,
)
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

IP = pltpu.InterpretParams()
N = 128
# name, JAX and port distributions, init scale, ε, max_depth, iterations
CASES = [
    ("product_of_t", jmodels.ProductOfT(), tmodels.ProductOfT(), 2.0, 0.12, 4, 2),
    ("sparse_coding", jmodels.SparseCoding(), tmodels.SparseCoding(), 0.1, 0.02, 4, 3),
    ("logreg", JLogreg(nobs=64), tmodels.LogisticRegression(nobs=64), 1.0, 0.15, 5, 3),
]


def _start(jd, scale, seed):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((jd.ndims, N))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, N)).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = np.zeros(N, np.float32)
    js = (jnp.asarray(x), jnp.asarray(v), jnp.asarray(g), jnp.asarray(u)[None],
          jnp.zeros((1, N)), jnp.zeros((1, N)))
    return js, tuple(torch.as_tensor(a) for a in (x, v, g, u, z, z.copy()))


def _within(a, b):
    """(n,) bool: the chain's entries lie within rtol 1e-4 (atol 1e-4 of
    the field's largest value)."""
    a = a.double().numpy()
    b = np.asarray(b, np.float64).reshape(a.shape)
    ok = np.abs(a - b) <= 1e-4 * np.abs(b).max() + 1e-4 * np.abs(b)
    return ok.reshape(-1, ok.shape[-1]).all(axis=0)


@pytest.mark.parametrize("name,jd,td,scale,eps,depth,steps", CASES, ids=[c[0] for c in CASES])
def test_nuts_run_matches_interpret_kernel(name, jd, td, scale, eps, depth, steps):
    jspec = dataclasses.replace(energy_spec_for(jd), precision="highest")
    tspec = dataclasses.replace(cm.energy_spec_for(td), precision="highest")
    js, ts = _start(jd, scale, 1)
    out_j = pallas_mjhmc_mm_run(jspec, *js, jnp.int32(7), jnp.float32(eps), jnp.float32(0.0),
                                steps, depth, interpret=IP, variant="nuts")
    out_t = cm.run_reference(tspec, *ts, 7, eps, 0.0, steps, depth, fixed_uniform=True,
                             variant="nuts")
    assert out_t.evals.dtype == torch.int32
    same = out_t.evals.numpy() == np.asarray(out_j.evals).ravel()
    assert same.mean() >= 0.99, same.mean()
    assert int(out_t.evals.min()) >= steps and int(out_t.evals.max()) <= steps * (2**depth - 1)
    np.testing.assert_array_equal(out_t.w.numpy(), float(steps))
    ok = same.copy()
    for f in ("x", "v", "grad", "u", "wx", "wx2"):
        ok &= _within(getattr(out_t, f), getattr(out_j, f))
    assert ok[same].all(), f"{name}: {int((~ok & same).sum())} chains with equal counts outside"
    for f in ("h_back", "back_valid"):  # passed through
        assert torch.equal(getattr(out_t, f), ts[4 if f == "h_back" else 5])


@pytest.mark.parametrize("name,jd,td,scale,eps,depth,steps", CASES, ids=[c[0] for c in CASES])
def test_nuts_stream_matches_interpret_kernel(name, jd, td, scale, eps, depth, steps):
    """An emission per iteration: post-transition xs, unit ws, cumulative
    leaf counts; es[-1] is the run's counters."""
    jspec = dataclasses.replace(energy_spec_for(jd), precision="highest")
    tspec = dataclasses.replace(cm.energy_spec_for(td), precision="highest")
    js, ts = _start(jd, scale, 2)
    xs_j, ws_j, es_j, _ = pallas_mjhmc_mm_stream_run(
        jspec, *js, jnp.int32(11), jnp.float32(eps), jnp.float32(0.0), steps, 1, depth,
        interpret=IP, variant="nuts")
    xs_t, ws_t, es_t, out_t = cm.stream_reference(tspec, *ts, 11, eps, 0.0, steps, 1, depth,
                                                  fixed_uniform=True, variant="nuts")
    assert xs_t.shape == (steps, td.ndims, N) and ws_t.shape == es_t.shape == (steps, N)
    same = (es_t.numpy() == np.asarray(es_j).reshape(steps, N)).all(axis=0)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(es_t[-1].numpy(), out_t.evals.numpy())
    np.testing.assert_array_equal(ws_t.numpy(), 1.0)
    np.testing.assert_array_equal(np.asarray(ws_j).reshape(steps, N), 1.0)
    xs_j = np.asarray(xs_j).reshape(steps, td.ndims, N)
    ok = np.stack([_within(xs_t[i], xs_j[i]) for i in range(steps)]).all(axis=0)
    assert ok[same].all(), f"{name}: {int((~ok & same).sum())} chains with equal counts outside"
    assert torch.equal(xs_t[-1], out_t.x)


#: trees past round 10, fixed-uniform: product of t at ε 0.001 (every
#: tree runs the 4,095 leaves of twelve rounds, the cap) and logistic
#: regression (64 observations) at ε 0.0045 (trees end after round 11 or
#: at the cap); one iteration, 128 chains (one of the TPU kernel's lane
#: tiles), ~8 and ~7 s on one thread
DEEP_CASES = [
    ("product_of_t", jmodels.ProductOfT(), tmodels.ProductOfT(), 2.0, 0.001, False),
    ("logreg", JLogreg(nobs=64), tmodels.LogisticRegression(nobs=64), 1.0, 0.0045, True),
]


@pytest.mark.parametrize("name,jd,td,scale,eps,stream", DEEP_CASES,
                         ids=[c[0] for c in DEEP_CASES])
def test_nuts_matches_interpret_kernel_at_max_depth_12(name, jd, td, scale, eps, stream):
    """max_depth 12, the depth JAX's NUTS arbitration extends to: leaf
    counts equal on every chain, every tree past round 10 and some at the
    2¹² − 1 cap; x, v, g, u (the stream's xs) within rtol 1e-4 (atol 1e-4
    of the field's largest value) on every chain."""
    jspec = dataclasses.replace(energy_spec_for(jd), precision="highest")
    tspec = dataclasses.replace(cm.energy_spec_for(td), precision="highest")
    js, ts = _start(jd, scale, 1)
    if stream:
        xs_j, _, es_j, out_j = pallas_mjhmc_mm_stream_run(
            jspec, *js, jnp.int32(7), jnp.float32(eps), jnp.float32(0.0), 1, 1, 12,
            interpret=IP, variant="nuts")
        xs_t, _, es_t, out_t = cm.stream_reference(tspec, *ts, 7, eps, 0.0, 1, 1, 12,
                                                   fixed_uniform=True, variant="nuts")
        np.testing.assert_array_equal(es_t.numpy().ravel(), np.asarray(es_j).ravel())
        assert _within(xs_t[0], np.asarray(xs_j).reshape(td.ndims, N)).all()
    else:
        out_j = pallas_mjhmc_mm_run(jspec, *js, jnp.int32(7), jnp.float32(eps),
                                    jnp.float32(0.0), 1, 12, interpret=IP, variant="nuts")
        out_t = cm.run_reference(tspec, *ts, 7, eps, 0.0, 1, 12, fixed_uniform=True,
                                 variant="nuts")
    leaves = out_t.evals.numpy()
    np.testing.assert_array_equal(leaves, np.asarray(out_j.evals).ravel())
    assert leaves.min() >= 2**11 - 1 and (leaves == 2**12 - 1).any(), np.unique(leaves)
    for f in ("x", "v", "grad", "u"):
        assert _within(getattr(out_t, f), getattr(out_j, f)).all(), f


def test_matmul_nuts_routes_and_refuses():
    """CPU tensors take the plain version with no launch counted; CudaNUTS
    takes the matmul wrappers; two-stage NUTS, trees deeper than the kernel
    holds and the kernel's missing shapes are refused."""
    td = tmodels.ProductOfT()
    tspec = cm.energy_spec_for(td)
    _, ts = _start(jmodels.ProductOfT(), 2.0, 3)
    before = [getattr(f, k) for f in (cm.cuda_mjhmc_mm_run, cm.cuda_mjhmc_mm_stream_run)
              for k in cm.COUNTS]
    a = cm.cuda_mjhmc_mm_run(tspec, *ts, 5, 0.12, 0.0, 2, 4, variant="nuts")
    b = cm.run_reference(tspec, *ts, 5, 0.12, 0.0, 2, 4, variant="nuts")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    xs, ws, es, _ = cm.cuda_mjhmc_mm_stream_run(tspec, *ts, 5, 0.12, 0.0, 2, 1, 4,
                                                variant="nuts")
    assert torch.equal(es[-1], b.evals) and bool((ws == 1).all())
    eng = cm.CudaNUTS(td, epsilon=0.12, num_leapfrog_steps=4, nbatch=64, device="cpu")
    assert eng._matmul and eng.variant == "nuts"
    eng.run(2)
    xs, _, es = eng.sample(2, return_evals=True)
    assert torch.equal(xs[-1], eng.x) and int(es[-1].min()) >= 2
    assert [getattr(f, k) for f in (cm.cuda_mjhmc_mm_run, cm.cuda_mjhmc_mm_stream_run)
            for k in cm.COUNTS] == before
    with pytest.raises(NotImplementedError, match="leapfrog"):
        cm.cuda_mjhmc_mm_run(tspec, *ts, 5, 0.12, 0.0, 2, 4, variant="nuts",
                             integrator="two_stage")
    with pytest.raises(NotImplementedError, match="leapfrog"):
        cm.CudaNUTS(td, integrator="two_stage", device="cpu")
    meta = tuple(t.to("meta") for t in ts)
    with pytest.raises(NotImplementedError, match="max_depth 1..31"):
        cm.cuda_mjhmc_mm_run(tspec, *meta, 5, 0.12, 0.0, 2, 32, variant="nuts")
    for depth in (4, 13):
        with pytest.raises(ValueError, match="cuda tensors"):
            cm.cuda_mjhmc_mm_run(tspec, *meta, 5, 0.12, 0.0, 2, depth, variant="nuts")
    assert cm.nuts_scratch_rows(8) == 22  # 6 endpoint rows, 2 proposal rows, 2·7 stack rows


#: the presets' chains (mjhmc_tpu_torch/config.py), the H100's SMs and its
#: shared memory: an SM's 228 KB, a block's 227 KB at most, 1 KB an SM
#: reserves for each resident block
PRESET_CHAINS = {"product_of_t": 4096, "sparse_coding": 8192, "logreg": 2048}
SMS, SMEM_SM, SMEM_BLOCK, SMEM_RESERVED = 132, 233472, 232448, 1024
#: the NUTS instances: each preset at highest and at its JAX default precision
NUTS_INSTANCES = [("product_of_t", "highest"), ("product_of_t", "default"),
                  ("sparse_coding", "highest"), ("sparse_coding", "bf16x3"),
                  ("logreg", "highest"), ("logreg", "default")]


def _preset_spec(name, precision=None):
    dist = {"product_of_t": tmodels.ProductOfT, "sparse_coding": tmodels.SparseCoding,
            "logreg": tmodels.LogisticRegression}[name]()
    spec = cm.energy_spec_for(dist)
    return spec if precision is None else dataclasses.replace(spec, precision=precision)


@pytest.mark.parametrize("name", list(PRESET_CHAINS))
def test_nuts_scratch_only_where_the_tree_leaves_shared_memory(name):
    """The wrapper allocates the NUTS tree state in device memory, (rows, d,
    n), for sparse coding only (11 KB a chain at max_depth 8); product of t
    and logreg keep it in shared memory and get none, at every depth to the
    tile depth (12). Past it every preset's buffer holds the stack rows past
    12 (sparse coding's tree state grows by them), then each block's span
    slots past 12, flat."""
    spec = _preset_spec(name)
    for depth in range(1, cm.NUTS_MM_TILE_DEPTH + 1):
        scratch = cm.nuts_scratch(spec, depth, 100, "meta")
        if name == "sparse_coding":
            assert scratch.shape == (cm.nuts_scratch_rows(depth), 128, 100)
            assert scratch.dtype == torch.float32
        else:
            assert scratch is None
    assert cm.nuts_mm_tile_rule(spec).onchip == (name != "sparse_coding")
    rule = cm.nuts_mm_tile_rule(spec)
    dp = cm.nuts_mm_geometry_of(spec).dp
    for depth in (13, 14, cm.NUTS_MM_MAX_DEPTH):
        deep = 2 * (depth - 12)
        rows = cm.nuts_scratch_rows(depth) if name == "sparse_coding" else deep
        tree = rows * dp * 100
        want = -(-tree // 4) * 4 + -(-100 // rule.chains) * deep * rule.threads
        scratch = cm.nuts_scratch(spec, depth, 100, "meta")
        assert cm.nuts_deep_rows(depth) == deep
        assert scratch.shape == (want,) and scratch.dtype == torch.float32


@pytest.mark.parametrize("name,precision", NUTS_INSTANCES,
                         ids=[" ".join(k) for k in NUTS_INSTANCES])
def test_nuts_tiles_fill_the_card(name, precision):
    """The NUTS tile mirror (``nuts_mm_tile_rule``, ``nuts_mm_smem_bytes``): at
    the preset's chains the grid has at least 2 × 132 blocks (logreg's 2,048
    chains at the 8-column mma.sync tile: 256, still two an SM on most); a
    block holds whole columns (threads a multiple of the chains, the dims
    and the intermediate's rows a multiple of the owners a column); at
    max_depth 8 two blocks fit an SM's shared memory, and at max_depth 12 a
    block stays under 227 KB; the bytes grow with the depth. (Phase 2 of
    chip_smoke.py holds the mirror to the library's own bytes.)"""
    spec = _preset_spec(name, precision)
    nc, threads = cm.nuts_mm_tile_rule(spec)[:2]
    d, k = cm.MM_KERNEL_SHAPES[type(spec)]
    owners = threads // nc
    assert threads % nc == 0 and d % owners == 0 and k % owners == 0 and nc % 8 == 0
    blocks = -(-PRESET_CHAINS[name] // nc)
    assert blocks >= (SMS if name == "logreg" else 2 * SMS), blocks
    at8, at12 = (cm.nuts_mm_smem_bytes(spec, depth) for depth in (8, 12))
    assert 2 * (at8 + SMEM_RESERVED) <= SMEM_SM
    assert at12 < SMEM_BLOCK
    assert cm.nuts_mm_smem_bytes(spec, 1) < at8 < at12


def test_bench_mm_ab_compare_counts_distinct_outputs(tmp_path, capsys):
    """``bench_mm_ab --compare`` (the A/B of two checkouts' matmul kernels)
    lists every case of any record with the number of distinct output
    hashes among the records that hold it, and each record's times."""
    from mjhmc_tpu_torch import bench_mm_ab

    recs = {"parent1": {"logreg/nuts/default/plain": dict(out="a", run_ms=0.9, stream_ms=0.95),
                        "logreg/mjhmc/default/plain": dict(out="m", run_ms=0.06, stream_ms=0.07)},
            "change1": {"logreg/nuts/default/plain": dict(out="b", run_ms=0.12, stream_ms=0.13),
                        "logreg/mjhmc/default/plain": dict(out="m", run_ms=0.06, stream_ms=0.07)},
            "v1": {"logreg/nuts/default/plain": dict(out="b", run_ms=0.11, stream_ms=0.12)}}
    lines = bench_mm_ab.compare(recs)
    assert lines == [
        "logreg/nuts/default/plain 2 outputs parent1:0.9/0.95 change1:0.12/0.13 v1:0.11/0.12",
        "logreg/mjhmc/default/plain 1 outputs parent1:0.06/0.07 change1:0.06/0.07"]
    paths = []
    for tag, rec in recs.items():
        paths.append(tmp_path / f"{tag}.json")
        paths[-1].write_text(json.dumps(rec))
    assert bench_mm_ab.main(["--compare", *map(str, paths)]) == 0
    assert capsys.readouterr().out.splitlines() == lines
    with pytest.raises(SystemExit):
        bench_mm_ab.main([])
