"""NUTS trees past max_depth 12, in both kernels' plain versions and the
wrappers' mirrors of the matmul kernel's layout.

JAX's ``PallasNUTS`` takes any static max_depth; the port's kernels take
1..31 (2^31 − 1 leaves: every leaf count and tree position fits an int32,
as the JAX kernel's counters are) and refuse 32. Here, without nvcc:

- the elementwise plain version against ``pallas_mjhmc_run`` /
  ``pallas_mjhmc_stream_run`` in Pallas interpret mode at max_depth 14 on
  gauss2d (1,024 chains, ε 1e-4, fixed uniforms: every tree runs the
  16,383 leaves of fourteen rounds): leaf counts exact on every chain, x,
  v, g, u (the stream's xs) within rtol 1e-5 (atol 1e-5 of the field's
  largest value), as ``test_torch_nuts_engine.py`` holds them;
- the matmul plain version against ``pallas_mjhmc_mm_run`` at max_depth 13
  on product of t (128 chains, ``highest``, ε 0.00025: every tree runs the
  8,191 leaves of thirteen rounds) with the allowances of
  ``test_torch_mm_nuts.py``'s depth-12 case: leaf counts equal on every
  chain, x, v, g, u within rtol 1e-4 (atol 1e-4 of the field's largest
  value). The two sum their products in different orders; over 8,191
  leaves at that case's ε 0.001 (twice its trajectory's length) those
  last-ulp differences put g past 1e-4 on 103 of the 128 chains, at ε
  0.0005 on 1, x and u staying within on all, so the trees here span a
  quarter of that length;
- the matmul tile mirror at depths 1-12, pinned to the values the mirror
  gave before trees past 12 were ported (the presets and the on-demand and
  chunked shapes of ``tests/test_torch_any_mm_shapes.py`` and
  ``tests/test_torch_mm_chunked.py``, every dot precision), and at 13-31
  the same tile and shared bytes with the deep stack rows and span slots
  in the device buffer;
- the deep launches' routing (the keys shallow trees run on) and the
  buffer check.
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from mjhmc_tpu import models as jmodels
from mjhmc_tpu.ops.pallas_mjhmc import (
    energy_spec_for,
    pallas_mjhmc_mm_run,
    pallas_mjhmc_run,
    pallas_mjhmc_stream_run,
)
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.ops import _build
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

IP = pltpu.InterpretParams()
SMEM_BLOCK = 232448  # a block's shared memory at most on the H100


def _close(a, b, what, rtol):
    b = np.asarray(b, np.float64).reshape(a.shape)
    np.testing.assert_allclose(a.double().numpy(), b, rtol=rtol,
                               atol=rtol * np.abs(b).max(), err_msg=what)


# ---- the elementwise kernel's plain version at max_depth 14 ----------------
EW_N, EW_S, EW_EPS, EW_DEPTH = 1024, 8, 1e-4, 14


def _gauss2d():
    """gauss2d (variances 1 and 100) from a NumPy-made state, in the JAX
    kernel's (d, S, L) chain blocks and the port's (d, n)."""
    kw = dict(ndims=2, log_conditioning=2.0)
    jd, td = jmodels.Gaussian(**kw), tmodels.Gaussian(**kw)
    rng = np.random.default_rng(14)
    x = (rng.standard_normal((2, EW_N)) * np.array([[1.0], [10.0]])).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = np.zeros(EW_N, np.float32)
    lanes = EW_N // EW_S
    js = (jnp.asarray(x).reshape(2, EW_S, lanes), jnp.zeros((2, EW_S, lanes)),
          jnp.asarray(g).reshape(2, EW_S, lanes), jnp.asarray(u).reshape(EW_S, lanes),
          jnp.zeros((EW_S, lanes)), jnp.zeros((EW_S, lanes)))
    ts = tuple(torch.as_tensor(a) for a in (x, np.zeros_like(x), g, u, z, z.copy()))
    return energy_spec_for(jd), cm.energy_spec_for(td), js, ts


def test_elementwise_run_matches_interpret_kernel_at_max_depth_14():
    """Every tree runs its 2¹⁴ − 1 leaves (ε far below any U-turn): the
    stack rows of spans 12 and 13 are written and read; counts exact,
    states within rtol 1e-5."""
    jspec, tspec, js, ts = _gauss2d()
    out_j = pallas_mjhmc_run(jspec, *js, jnp.int32(7), jnp.float32(EW_EPS), jnp.float32(0.0),
                             1, EW_DEPTH, interpret=IP, variant="nuts")
    out_t = cm.run_reference(tspec, *ts, 7, EW_EPS, 0.0, 1, EW_DEPTH, fixed_uniform=True,
                             variant="nuts")
    leaves = out_t.evals.numpy()
    np.testing.assert_array_equal(leaves, np.asarray(out_j.evals).ravel())
    assert (leaves == 2**EW_DEPTH - 1).all(), np.unique(leaves)
    for f in ("x", "v", "grad", "u", "wx", "wx2"):
        _close(getattr(out_t, f), getattr(out_j, f), f, 1e-5)


def test_elementwise_stream_matches_interpret_kernel_at_max_depth_14():
    """The stream at max_depth 14: one emission, its cumulative leaf count
    exact, its xs within rtol 1e-5, es[-1] the run's counters."""
    jspec, tspec, js, ts = _gauss2d()
    xs_j, ws_j, es_j, out_j = pallas_mjhmc_stream_run(
        jspec, *js, jnp.int32(11), jnp.float32(EW_EPS), jnp.float32(0.0), 1, 1, EW_DEPTH,
        interpret=IP, variant="nuts")
    xs_t, ws_t, es_t, out_t = cm.stream_reference(tspec, *ts, 11, EW_EPS, 0.0, 1, 1, EW_DEPTH,
                                                  fixed_uniform=True, variant="nuts")
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(1, EW_N))
    np.testing.assert_array_equal(es_t[-1].numpy(), out_t.evals.numpy())
    assert int(es_t.min()) == 2**EW_DEPTH - 1
    np.testing.assert_array_equal(ws_t.numpy(), 1.0)
    np.testing.assert_array_equal(np.asarray(ws_j).reshape(1, EW_N), 1.0)
    _close(xs_t, np.asarray(xs_j).reshape(1, 2, EW_N), "xs", 1e-5)
    for f in ("x", "v", "grad", "u"):
        _close(getattr(out_t, f), getattr(out_j, f), f, 1e-5)


# ---- the matmul kernel's plain version at max_depth 13 ---------------------
MM_N, MM_EPS, MM_DEPTH = 128, 0.00025, 13


def _within(a, b):
    """(n,) bool: the chain's entries lie within rtol 1e-4 (atol 1e-4 of
    the field's largest value)."""
    a = a.double().numpy()
    b = np.asarray(b, np.float64).reshape(a.shape)
    ok = np.abs(a - b) <= 1e-4 * np.abs(b).max() + 1e-4 * np.abs(b)
    return ok.reshape(-1, ok.shape[-1]).all(axis=0)


def test_matmul_run_matches_interpret_kernel_at_max_depth_13():
    """Product of t at ``highest``: every tree runs its 2¹³ − 1 leaves (the
    stack rows and span slots of span 12, which a launch keeps in the device
    buffer); counts equal on every chain, states within rtol 1e-4."""
    jd, td = jmodels.ProductOfT(), tmodels.ProductOfT()
    jspec = dataclasses.replace(energy_spec_for(jd), precision="highest")
    tspec = dataclasses.replace(cm.energy_spec_for(td), precision="highest")
    rng = np.random.default_rng(1)
    x = (2.0 * rng.standard_normal((jd.ndims, MM_N))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, MM_N)).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = np.zeros(MM_N, np.float32)
    js = (jnp.asarray(x), jnp.asarray(v), jnp.asarray(g), jnp.asarray(u)[None],
          jnp.zeros((1, MM_N)), jnp.zeros((1, MM_N)))
    ts = tuple(torch.as_tensor(a) for a in (x, v, g, u, z, z.copy()))
    out_j = pallas_mjhmc_mm_run(jspec, *js, jnp.int32(7), jnp.float32(MM_EPS), jnp.float32(0.0),
                                1, MM_DEPTH, interpret=IP, variant="nuts")
    out_t = cm.run_reference(tspec, *ts, 7, MM_EPS, 0.0, 1, MM_DEPTH, fixed_uniform=True,
                             variant="nuts")
    leaves = out_t.evals.numpy()
    np.testing.assert_array_equal(leaves, np.asarray(out_j.evals).ravel())
    assert leaves.min() >= 2**12 - 1 and (leaves == 2**13 - 1).any(), np.unique(leaves)
    for f in ("x", "v", "grad", "u"):
        assert _within(getattr(out_t, f), getattr(out_j, f)).all(), f


# ---- the matmul tile mirror --------------------------------------------------
def _specs():
    """label -> the spec (its JAX default precision) of the presets, the
    on-demand shapes (chip_smoke.ANY_MM_SHAPES) and the chunked shapes."""
    out = {name: cm.energy_spec_for(getattr(tmodels, cls)())
           for name, cls in (("product_of_t", "ProductOfT"), ("sparse_coding", "SparseCoding"),
                             ("logreg", "LogisticRegression"))}
    for label, (name, kw, _, _) in chip_smoke.ANY_MM_SHAPES.items():
        out[label] = cm.energy_spec_for(chip_smoke.any_mm_model(tmodels, name, kw))
    for label, kw in (("logreg 4x20000", dict(ndims=4, nobs=20000)),
                      ("logreg 124x32561", dict(ndims=124, nobs=32561))):
        out[label] = cm.energy_spec_for(tmodels.LogisticRegression(**kw))
    out["sparse_coding 4096x1024"] = cm.energy_spec_for(
        tmodels.SparseCoding(npixels=1024, nbasis=4096, phi_source="gabor"))
    return out


#: "label precision" -> (the tile rule's (chains, threads, minb, off, onchip,
#: chunk, xg_off), shared bytes a block at max_depth 1 and their growth a
#: depth, the device buffer's floats for 1,000 chains at max_depth 1 and
#: their growth a depth), as the mirror gave them before the port took
#: trees past 12 (both grow linearly in the depth to 12); the chunked tiles
#: with X and G on chip at the bf16 precisions as the ring gives them
#: (``RING_STAGES``: its stages, 256 threads, the stages beside the tree and
#: the buffer's blocks as many as a cluster plan may launch)
PARENT_LAYOUT = {
    "product_of_t highest": ((8, 96, 4, False, True, 0, False), 26544, 3072, 0, 0),
    "product_of_t bf16x3": ((8, 96, 4, False, True, 0, False), 34608, 3072, 0, 0),
    "product_of_t bf16x2": ((8, 96, 4, False, True, 0, False), 25392, 3072, 0, 0),
    "product_of_t default": ((8, 96, 4, False, True, 0, False), 25392, 3072, 0, 0),
    "sparse_coding highest": ((16, 256, 2, False, False, 0, False), 92416, 2048, 1024000, 256000),
    "sparse_coding bf16x3": ((16, 256, 2, False, False, 0, False), 92416, 2048, 1024000, 256000),
    "sparse_coding bf16x2": ((16, 256, 2, False, False, 0, False), 59648, 2048, 1024000, 256000),
    "sparse_coding default": ((16, 256, 2, False, False, 0, False), 59648, 2048, 1024000, 256000),
    "logreg highest": ((8, 128, 3, False, True, 0, False), 57984, 2048, 0, 0),
    "logreg bf16x3": ((8, 128, 3, False, True, 0, False), 57984, 2048, 0, 0),
    "logreg bf16x2": ((8, 128, 3, False, True, 0, False), 41600, 2048, 0, 0),
    "logreg default": ((8, 128, 3, False, True, 0, False), 41600, 2048, 0, 0),
    "sparse_coding 96x64 highest": ((16, 256, 2, False, False, 0, False), 71680, 2048, 768000,
                                    192000),
    "sparse_coding 96x64 bf16x3": ((16, 256, 2, False, False, 0, False), 71680, 2048, 768000,
                                   192000),
    "sparse_coding 96x64 bf16x2": ((16, 256, 2, False, False, 0, False), 47104, 2048, 768000,
                                   192000),
    "sparse_coding 96x64 default": ((16, 256, 2, False, False, 0, False), 47104, 2048, 768000,
                                    192000),
    "logreg 16x64 highest": ((8, 128, 3, False, True, 0, False), 20352, 2048, 0, 0),
    "logreg 16x64 bf16x3": ((8, 128, 3, False, True, 0, False), 20352, 2048, 0, 0),
    "logreg 16x64 bf16x2": ((8, 128, 3, False, True, 0, False), 16256, 2048, 0, 0),
    "logreg 16x64 default": ((8, 128, 3, False, True, 0, False), 16256, 2048, 0, 0),
    "product_of_t 36x72 highest": ((8, 96, 4, False, True, 0, False), 39360, 3072, 0, 0),
    "product_of_t 36x72 bf16x3": ((8, 96, 4, False, True, 0, False), 49344, 3072, 0, 0),
    "product_of_t 36x72 bf16x2": ((8, 96, 4, False, True, 0, False), 33984, 3072, 0, 0),
    "product_of_t 36x72 default": ((8, 96, 4, False, True, 0, False), 33984, 3072, 0, 0),
    "product_of_t 10x13 highest": ((8, 96, 4, False, True, 0, False), 8720, 1536, 0, 0),
    "product_of_t 10x13 bf16x3": ((8, 96, 4, False, True, 0, False), 9504, 1536, 0, 0),
    "product_of_t 10x13 bf16x2": ((8, 96, 4, False, True, 0, False), 8480, 1536, 0, 0),
    "product_of_t 10x13 default": ((8, 96, 4, False, True, 0, False), 8480, 1536, 0, 0),
    "logreg 7x100 highest": ((8, 128, 3, False, True, 0, False), 21376, 2048, 0, 0),
    "logreg 7x100 bf16x3": ((8, 128, 3, False, True, 0, False), 29712, 2048, 0, 0),
    "logreg 7x100 bf16x2": ((8, 128, 3, False, True, 0, False), 22544, 2048, 0, 0),
    "logreg 7x100 default": ((8, 128, 3, False, True, 0, False), 22544, 2048, 0, 0),
    "sparse_coding 200x100 highest": ((16, 256, 1, False, False, 0, False), 200976, 2048,
                                      1664000, 416000),
    "sparse_coding 200x100 bf16x3": ((8, 128, 1, False, False, 0, False), 207888, 1024,
                                     1664000, 416000),
    "sparse_coding 200x100 bf16x2": ((16, 256, 1, False, False, 0, False), 134160, 2048,
                                     1664000, 416000),
    "sparse_coding 200x100 default": ((16, 256, 1, False, False, 0, False), 134160, 2048,
                                      1664000, 416000),
    "sparse_coding 288x144 highest": ((16, 256, 2, True, False, 0, False), 54080, 2048,
                                      2386944, 576000),
    "sparse_coding 288x144 bf16x3": ((16, 256, 2, True, False, 0, False), 54080, 2048,
                                     2386944, 576000),
    "sparse_coding 288x144 bf16x2": ((8, 128, 1, False, False, 0, False), 194368, 1024,
                                     2304000, 576000),
    "sparse_coding 288x144 default": ((8, 128, 1, False, False, 0, False), 194368, 1024,
                                      2304000, 576000),
    "logreg 4x20000 highest": ((8, 128, 3, True, True, 512, False), 40576, 2048, 160000, 0),
    "logreg 4x20000 bf16x3": ((8, 256, 1, True, True, 512, False), 117568, 4096, 640000, 0),
    "logreg 4x20000 bf16x2": ((8, 256, 1, True, True, 512, False), 117568, 4096, 320000, 0),
    "logreg 4x20000 default": ((8, 256, 2, True, True, 512, False), 109120, 4096, 320000, 0),
    "logreg 124x32561 highest": ((8, 128, 2, True, True, 512, False), 77312, 9216, 8075500, 0),
    "logreg 124x32561 bf16x3": ((8, 256, 2, True, True, 128, False), 114736, 10240, 8339456,
                                0),
    "logreg 124x32561 bf16x2": ((8, 256, 2, True, True, 128, False), 114736, 10240, 4169728,
                                0),
    "logreg 124x32561 default": ((8, 256, 1, True, True, 256, False), 116784, 10240, 4169728,
                                 0),
    "sparse_coding 4096x1024 highest": ((8, 1024, 1, True, False, 512, True), 36864, 8192,
                                        50372608, 8192000),
    "sparse_coding 4096x1024 bf16x3": ((8, 1024, 1, True, False, 512, True), 36864, 8192,
                                       50372608, 8192000),
    "sparse_coding 4096x1024 bf16x2": ((8, 1024, 1, True, False, 512, True), 36864, 8192,
                                       46178304, 8192000),
    "sparse_coding 4096x1024 default": ((8, 1024, 1, True, False, 512, True), 36864, 8192,
                                        46178304, 8192000),
}
#: the ring's stages of the chunked bf16 tiles above (the rest have none)
RING_STAGES = {"logreg 4x20000 bf16x3": 4, "logreg 4x20000 bf16x2": 4,
               "logreg 4x20000 default": 4, "logreg 124x32561 bf16x3": 3,
               "logreg 124x32561 bf16x2": 3, "logreg 124x32561 default": 3}
SPECS = _specs()


def _spec(key):
    label, precision = key.rsplit(" ", 1)
    return dataclasses.replace(SPECS[label], precision=precision)


@pytest.mark.parametrize("key", list(PARENT_LAYOUT))
def test_tile_mirror_keeps_the_parents_layout_to_max_depth_12(key):
    """At depths 1-12 the tile, its shared bytes and its device buffer are
    the ones the mirror gave before trees past 12 were ported: the tile rule
    still fits the layout at NUTS_MM_TILE_DEPTH (12)."""
    spec = _spec(key)
    rule, smem1, dsmem, scratch1, dscratch = PARENT_LAYOUT[key]
    assert tuple(cm.nuts_mm_tile_rule(spec)) == (*rule, RING_STAGES.get(key, 0))
    assert cm.NUTS_MM_TILE_DEPTH == 12
    for depth in range(1, 13):
        assert cm.nuts_mm_smem_bytes(spec, depth) == smem1 + (depth - 1) * dsmem, depth
        assert cm.nuts_scratch_floats(spec, depth, 1000) == scratch1 + (depth - 1) * dscratch
        assert cm.nuts_deep_rows(depth) == 0


@pytest.mark.parametrize("key", list(PARENT_LAYOUT))
def test_deep_trees_keep_the_tile_and_add_their_rows_to_the_buffer(key):
    """Past 12 the tile and its shared bytes stay the depth-12 ones (under a
    block's 227 KB), and the device buffer grows by the stack rows of the
    spans past 12 (2(max_depth − 12) rows of the padded dims a chain: where
    the tree state is on chip, after the parameter matrix; else with it)
    and then each block's 2(max_depth − 12) span slots a thread, after the
    slices, 16-byte aligned."""
    spec = _spec(key)
    rule = cm.nuts_mm_tile_rule(spec)
    geom = cm.nuts_mm_geometry_of(spec)
    at12 = cm.nuts_mm_smem_bytes(spec, 12)
    params = cm.param_floats(spec) if rule.off else 0
    n = 1000
    blocks = cm.launched_blocks(rule, n, cm.nuts_splits(rule))  # the tiles, but with a ring
    for depth in (13, 14, 31):
        deep = 2 * (depth - 12)
        assert cm.nuts_deep_rows(depth) == deep
        assert cm.nuts_mm_smem_bytes(spec, depth) == at12 <= SMEM_BLOCK
        rows = deep if rule.onchip else cm.nuts_scratch_rows(depth)
        head = -(-(params + rows * geom.dp * n) // 4) * 4
        want = head + blocks * ((geom.slice if rule.xg_off else 0) + deep * rule.threads)
        assert cm.nuts_scratch_floats(spec, depth, n) == want
        buf = cm.nuts_scratch(spec, depth, n, "meta")
        assert buf.shape == (want,) and buf.dtype == torch.float32


def test_elementwise_tree_rows_at_the_cap():
    """The elementwise kernel's tree rows at max_depth 31: 75 rows, in
    shared memory up to 10 dims (96,000 bytes a one-warp block at D 10),
    else the (75, d, n) scratch."""
    assert cm.nuts_tree_rows(31) == 75
    assert cm.nuts_smem_bytes(10, 32, 31) == 96_000 < SMEM_BLOCK
    assert cm.nuts_tree_scratch(10, 31, 64, "meta") is None
    assert cm.nuts_tree_scratch(50, 31, 64, "meta").shape == (75, 50, 64)
    assert cm.nuts_tree_scratch(50, 14, 64, "meta").shape == (41, 50, 64)


# ---- routing and the buffer check -------------------------------------------
def test_deep_trees_run_on_the_keys_shallow_trees_run_on(monkeypatch):
    """A NUTS tree past 12 runs on the library or key a shallower tree runs
    on (the C entries route it to the DEEP instance compiled beside the
    others): the library's at the presets' shapes and precisions, else the
    one on-demand key of the shape, whose macros name no depth; the tile
    query passes the depth through."""
    loads, asked = [], []

    def nuts_tile(energy, precision, depth, out):
        asked.append(depth)
        for i, v in enumerate((8, 256, 1024, 1, 0, 0, 0, 0)):
            out[i] = v
        return 0

    class Lib:
        def __getattr__(self, name):
            return nuts_tile if name.endswith("nuts_tile") else name

    monkeypatch.setattr(_build, "load_instance", lambda inst: loads.append(inst) or Lib())
    monkeypatch.setattr(_build, "load", lambda: Lib())
    preset = SPECS["product_of_t"]
    for depth in (8, 14, 31):
        assert cm.nuts_mm_tile(preset, depth) == (8, 256, 1024, 1)
    assert loads == [] and asked == [8, 14, 31]
    for label in ("product_of_t 36x72", "logreg 124x32561", "sparse_coding 4096x1024"):
        spec = SPECS[label]
        rule = cm.nuts_mm_tile_rule(spec)
        loads.clear()
        for depth in (8, 14):
            cm.nuts_mm_tile(spec, depth)
        key = _build.mm_instance(cm.KERNEL_VARIANTS["nuts"], spec.energy_id, *cm.mm_shape(spec),
                                 cm.PRECISIONS.index(spec.precision), rule.off, rule.chunk,
                                 rule.xg_off)
        assert loads == [key, key]
        assert len(key.macros) == (8 if rule.chunk else 6)


@pytest.mark.parametrize("label", ["product_of_t", "sparse_coding", "sparse_coding 4096x1024"])
def test_buffer_check_holds_the_deep_slots(label):
    """The launch holds the deep buffer to the instance's report at that
    depth (its tree floats a chain and a block's span slots, out[6] and
    out[7]): the
    mirror's buffer passes; a report of one slot fewer, or of the depth-12
    tree, is refused before any launch."""
    spec = SPECS[label]
    rule, geom = cm.nuts_mm_tile_rule(spec), cm.nuts_mm_geometry_of(spec)
    params = cm.param_floats(spec) if rule.off else 0
    kept = []

    def entries(report):
        def tile(*args):
            out = args[-1]
            for i, v in enumerate(report):
                out[i] = v
            return 0
        out = ctypes.POINTER(ctypes.c_int)
        kept.append(cm.MmEntries(None, None,
                                 ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_int] * 3, out)(tile)))
        return kept[-1]

    n, depth = 1000, 14
    deep = 2 * (depth - 12)
    tree = (deep if rule.onchip else cm.nuts_scratch_rows(depth)) * geom.dp
    report = (rule.chains, rule.threads, 0, 1, geom.slice if rule.xg_off else 0, params, tree,
              deep * rule.threads, rule.stages, int(cm.nuts_splits(rule)), 66, 32, 16, 7)
    buf = cm.nuts_scratch(spec, depth, n, "meta")
    cm._check_buffer(entries(report), spec, "nuts", False, depth, n, buf)
    for bad in ((*report[:7], report[7] - 1),
                (*report[:6], 0 if rule.onchip else cm.nuts_scratch_rows(12) * geom.dp, 0)):
        with pytest.raises(RuntimeError, match="indexes a device buffer"):
            cm._check_buffer(entries(bad), spec, "nuts", False, depth, n, buf)
