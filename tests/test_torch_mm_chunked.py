"""The matmul engine past one block's shared memory: the chunked tiles.

Where even the 8-column tile's k-row intermediates (Y, Z) pass the 227 KB a
block may hold, the tile rule (``cuda_mjhmc.mm_tile_rule``,
``nuts_mm_tile_rule``, mirroring ``TileRule`` in
``csrc/mjhmc_mm_engine.cuh``) runs the K rows in chunks with the parameter
matrix in the device buffer, and where even 8 columns of X and G do not fit
beside a chunk, X, G and the mass move to each block's slice of that
buffer. At the bf16 precisions a chunked tile with X and G on chip keeps a
ring of chunks of the parameter matrix's fragments in shared memory, and
with few chains a cluster of CTAs splits one tile's chunks
(``cm.cluster_plan``). Here, without nvcc: the rule's tiles at logistic
regression 4 × 20,000 and at LIBSVM a9a's shape (124 × 32,561), and at
sparse coding on 32 × 32 patches with a 4× overcomplete dictionary (1,024 ×
4,096); the cluster plan by chain count; the device buffer's size against
the geometry, split tiles and NUTS's deep rows included; no refusal below
it; the on-demand key naming the chunk and not the cluster; and the plain
version (the kernels'
stand-in on the CPU) against the TPU kernel in Pallas interpret mode at 4 ×
20,000 (fixed uniforms, as ``tests/test_torch_any_mm_shapes.py`` holds the
smaller shapes: counters and cache flags exact, control's and MALT's weights
exact, MJHMC's Σw and every state within rtol 1e-4, atol 1e-4 of the
field's largest value, at ``precision="highest"``; the stream kernels share
the run's body and are held on the card).
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.ops.pallas_mjhmc import (
    energy_spec_for,
    pallas_mjhmc_mm_run,
)
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.ops import _build
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

#: label -> (model, its arguments); the chunked shapes and the mode each
#: takes: X and G on chip (the two logistic regressions) or off (sparse
#: coding)
SHAPES = {"logreg 4x20000": ("LogisticRegression", dict(ndims=4, nobs=20000), False),
          "logreg 124x32561": ("LogisticRegression", dict(ndims=124, nobs=32561), False),
          "sparse_coding 4096x1024": ("SparseCoding",
                                      dict(npixels=1024, nbasis=4096, phi_source="gabor"), True)}
BODIES = ("mjhmc", "control", "malt")


def _spec(label, precision=None):
    name, kw, _ = SHAPES[label]
    spec = cm.energy_spec_for(getattr(tmodels, name)(**kw))
    return spec if precision is None else dataclasses.replace(spec, precision=precision)


@pytest.mark.parametrize("precision", cm.PRECISIONS)
@pytest.mark.parametrize("label", list(SHAPES))
def test_chunked_tiles_at_the_slice_shapes(label, precision):
    """Every body's tile is chunked (the parameter matrix off chip, a chunk
    of whole k-tiles and whole rows for each of a column's owners), X and G
    off chip only at sparse coding, the layout within a block's 227 KB (NUTS
    at max_depth 12), the 8-column tile where X and G are off chip; with X
    and G on chip at the bf16 precisions a ring of 2-4 stages and chunks of
    whole rounds of the warps' m-tiles (16 rows a warp); at "highest" and
    with X and G off chip none."""
    spec = _spec(label, precision)
    xg = SHAPES[label][2]
    ring = precision != "highest" and not xg
    for body in BODIES:
        rule = cm.mm_tile_rule(spec, body)
        g = cm.mm_geometry(spec, body, True, rule.chains, rule.threads, rule.off, rule.chunk,
                           rule.xg_off, rule.stages)
        assert rule.off and rule.chunk > 0 and rule.xg_off == xg, rule
        assert rule.chunk % 16 == 0 and rule.chunk % g.row_owners == 0 and g.kp == rule.chunk
        assert (cm.MIN_STAGES <= rule.stages <= cm.MAX_STAGES) if ring else rule.stages == 0
        assert not ring or rule.chunk % (16 * (rule.threads // 32)) == 0
        assert rule.chunk <= cm.CHUNK_MAX and rule.threads <= cm.MAX_THREADS
        assert g.columns % 8 == 0 and g.dp >= cm.mm_shape(spec)[0]
        assert cm.mm_smem_bytes(spec, body, True) <= cm.SMEM_BLOCK
        assert rule.minb * rule.threads <= max(cm.MAX_THREADS, rule.threads)
        if xg:
            assert g.columns == 8 and g.slice == g.dp * (g.ld + g.columns + 2)
    rule = cm.nuts_mm_tile_rule(spec)
    assert rule.off and rule.chunk > 0 and rule.xg_off == xg and rule.chunk % 16 == 0
    assert (cm.MIN_STAGES <= rule.stages <= cm.MAX_STAGES) if ring else rule.stages == 0
    at12 = cm.nuts_mm_smem_bytes(spec, cm.NUTS_MM_TILE_DEPTH)
    assert at12 <= cm.SMEM_BLOCK and cm.nuts_mm_smem_bytes(spec, 31) == at12
    if xg:
        assert rule.chains == 8 and not rule.onchip


def test_a9a_and_sparse_coding_tiles():
    """The slice's two configurations at their JAX default precisions: a9a's
    mm_kernel tiles are the ring's wide ones, 32 columns (MJHMC 16 chains,
    control and MALT 32) on 256 threads, one block an SM, chunks of 512 rows
    beside a ring of four 16 KB stages (8 warps × 4 k-tiles × 512 bytes);
    its NUTS keeps 8 chains and the tree state on chip on 256 threads beside
    three stages and chunks of 256 rows (a split tile's partials too);
    sparse coding's, X and G in device memory, keep the parent's 8-column
    tiles on 1,024 threads a block and chunks of 512 rows, with no ring."""
    a9a, sc = _spec("logreg 124x32561"), _spec("sparse_coding 4096x1024")
    assert (a9a.precision, sc.precision) == ("default", "bf16x3")
    for body, chains in (("mjhmc", 16), ("control", 32), ("malt", 32)):
        assert cm.mm_tile_rule(a9a, body) == cm.TileRule(chains, 256, 1, True, False, 512,
                                                          False, 4)
    assert cm.nuts_mm_tile_rule(a9a) == cm.TileRule(8, 256, 1, True, True, 256, False, 3)
    assert cm.stage_k(256, "default") == 4
    assert cm.mm_tile_rule(sc, "mjhmc") == cm.TileRule(4, 1024, 1, True, False, 512, True, 0)
    assert cm.nuts_mm_tile_rule(sc) == cm.TileRule(8, 1024, 1, True, False, 512, True, 0)
    assert cm.mm_splits(cm.mm_tile_rule(a9a, "mjhmc"))
    assert cm.nuts_splits(cm.nuts_mm_tile_rule(a9a))
    assert not cm.mm_splits(cm.mm_tile_rule(sc, "mjhmc"))
    assert not cm.nuts_splits(cm.nuts_mm_tile_rule(sc))


@pytest.mark.parametrize("label", list(SHAPES))
def test_ring_only_where_x_and_g_are_on_chip(label):
    """At the spec's JAX default precision, a chunked tile with X and G on
    chip is the ring's wide one (RING_COLUMNS columns, at least
    RING_THREADS threads) with its stages, their two barriers each, ZB, XB
    and a split tile's partials in shared memory, and no f32 Z; a tile with
    X and G in device memory (the 8-column tile, its slice X, G and the
    mass) has no ring."""
    spec = _spec(label)
    d = cm.mm_shape(spec)[0]
    for body in BODIES:
        rule = cm.mm_tile_rule(spec, body)
        g = cm.mm_geometry(spec, body, True, rule.chains, rule.threads, True, rule.chunk,
                           rule.xg_off, rule.stages)
        if rule.xg_off:
            assert rule.stages == 0 and not cm.mm_splits(rule)
            assert g.columns == 8 and g.slice == g.dp * (g.ld + g.columns + 2)
            continue
        assert g.columns == cm.RING_COLUMNS and rule.threads >= cm.RING_THREADS
        assert cm.MIN_STAGES <= rule.stages <= cm.MAX_STAGES and cm.mm_splits(rule)
        words = rule.threads // 32 * cm.stage_k(rule.threads, spec.precision) * 128 * (
            cm.frag_copies(spec.precision))
        assert cm.ring_floats(rule.threads, spec.precision, rule.stages) == (
            rule.stages * (words + 4))
        plain = cm.mm_geometry(spec, body, True, rule.chains, rule.threads, True, rule.chunk)
        z = 0 if isinstance(spec, cm.SparseCodingSpec) else g.kp * g.ld
        assert g.floats - plain.floats == (
            cm.ring_floats(rule.threads, spec.precision, rule.stages)
            + cm.b_floats(rule.chunk, g.columns, spec.precision)
            + cm.b_floats(d, g.columns, spec.precision)
            + cm.split_floats(g.dp, g.columns, rule.threads) - z)


#: clusters of 2, 4, 8 and 16 CTAs an H100's 132 SMs might hold at once, one
#: tile an SM and three
HELD_ONE, HELD_THREE = (66, 32, 16, 7), (198, 99, 48, 24)


@pytest.mark.parametrize("n, held, body, label, want", [
    (8, HELD_ONE, "nuts", "logreg 124x32561", (16, True, 16)),
    (64, HELD_ONE, "nuts", "logreg 124x32561", (8, True, 64)),
    (2048, HELD_ONE, "nuts", "logreg 124x32561", (1, False, 256)),
    (8, HELD_ONE, "mjhmc", "logreg 124x32561", (16, True, 16)),
    (64, HELD_ONE, "mjhmc", "logreg 124x32561", (16, True, 64)),
    (2048, HELD_ONE, "mjhmc", "logreg 124x32561", (1, False, 128)),
    (2048, HELD_ONE, "control", "logreg 124x32561", (2, True, 128)),
    (2048, HELD_THREE, "control", "logreg 124x32561", (4, True, 256)),
    (8, HELD_ONE, "mjhmc", "sparse_coding 4096x1024", (1, False, 2)),
    (64, HELD_ONE, "nuts", "sparse_coding 4096x1024", (1, False, 8)),
    (2048, (10, 5, 0, 0), "control", "logreg 124x32561", (1, False, 64)),
])
def test_cluster_plan_by_chain_count(n, held, body, label, want):
    """The mode and C by the chain count: a tile that may split (a ring's
    tile; NUTS's with its tree state on chip) takes a cluster of its own, of
    the largest C the card holds one of a tile, while the card holds a
    cluster of two for every tile; else a CTA a tile (sparse coding's tiles
    have no ring), within the blocks the device buffer is sized for."""
    spec = _spec(label)
    rule = cm.nuts_mm_tile_rule(spec) if body == "nuts" else cm.mm_tile_rule(spec, body)
    splits = cm.nuts_splits(rule) if body == "nuts" else cm.mm_splits(rule)
    tiles = -(-n // rule.chains)
    plan = cm.cluster_plan(tiles, held, splits)
    assert plan == want
    c, split, grid = plan
    assert grid == tiles * c and split == (c > 1)
    assert grid <= cm.launched_blocks(rule, n, splits)


@pytest.mark.parametrize("label", list(SHAPES))
def test_scratch_sizes_follow_the_geometry(label):
    """The device buffer: the parameter matrix (Params::kFloats), then the
    NUTS tree state where it is off chip, then (X and G off chip) one slice
    a block, 16-byte aligned; the allocation is the only limit."""
    spec = _spec(label)
    params = cm.param_floats(spec)
    for body in BODIES:
        rule = cm.mm_tile_rule(spec, body)
        g = cm.mm_geometry(spec, body, True, rule.chains, rule.threads, True, rule.chunk,
                           rule.xg_off, rule.stages)
        for n in (1, rule.chains, 1000, 2048):
            blocks = cm.launched_blocks(rule, n, cm.mm_splits(rule))
            want = params + (blocks * g.slice if rule.xg_off else 0)
            assert cm.mm_scratch_floats(spec, body, n) == want
            assert cm.mm_scratch(spec, body, n, "meta").shape == (want,)
    rule, geom = cm.nuts_mm_tile_rule(spec), cm.nuts_mm_geometry_of(spec)
    for depth, n in ((1, 8), (4, 1000), (12, 2048)):
        tree = 0 if rule.onchip else cm.nuts_scratch_rows(depth) * geom.dp * n
        want = params + tree
        if rule.xg_off:
            want = -(-want // 4) * 4 + cm.launched_blocks(rule, n, False) * geom.slice
        assert cm.nuts_scratch_floats(spec, depth, n) == want
        assert cm.nuts_scratch(spec, depth, n, "meta").shape == (want,)


@pytest.mark.parametrize("label", list(SHAPES))
def test_launch_holds_the_buffer_to_the_instance(label):
    """The launch sizes the device buffer from the mirror and holds it to
    the instance's own report (its tile entry's floats of a block's slice,
    of the parameter matrix and of NUTS's tree state a chain): the same
    numbers pass; a slice one float larger, or a chain count that drifted,
    is refused before any launch."""
    spec = _spec(label)
    params = cm.param_floats(spec)

    kept = []  # the callbacks stay alive, so that no two share an address

    def entries(report):
        """C-callable tile entries that write ``report``, as a library's do."""
        def tile(*args):
            out = args[-1]
            for i, v in enumerate(report):
                out[i] = v
            return 0
        out = ctypes.POINTER(ctypes.c_int)
        kept.append(cm.MmEntries(
            None, ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_int] * 4, out)(tile),
            ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_int] * 3, out)(tile)))
        return kept[-1]

    n = 1000
    for body in (*BODIES, "nuts"):
        depth = 4 if body == "nuts" else 10
        if body == "nuts":
            rule, geom = cm.nuts_mm_tile_rule(spec), cm.nuts_mm_geometry_of(spec)
            tree = 0 if rule.onchip else cm.nuts_scratch_rows(depth) * geom.dp
            buf = cm.nuts_scratch(spec, depth, n, "meta")
        else:
            rule = cm.mm_tile_rule(spec, body)
            geom = cm.mm_geometry(spec, body, True, rule.chains, rule.threads, True, rule.chunk,
                                  rule.xg_off, rule.stages)
            tree = 0
            buf = cm.mm_scratch(spec, body, n, "meta")
        splits = cm.nuts_splits(rule) if body == "nuts" else cm.mm_splits(rule)
        report = (rule.chains, rule.threads, 0, 1, geom.slice, params, tree, 0, rule.stages,
                  int(splits), *HELD_ONE)
        cm._check_buffer(entries(report), spec, body, True, depth, n, buf)
        for bad in ((report[0] * 2, *report[1:]), (*report[:4], report[4] + 1, *report[5:]),
                    (*report[:5], params + 4, *report[6:])):
            if bad[4] == 0 and bad[0] != report[0]:
                continue  # the chains size nothing where no slice is
            with pytest.raises(RuntimeError, match="indexes a device buffer"):
                cm._check_buffer(entries(bad), spec, body, True, depth, n, buf)


def test_on_demand_key_names_the_chunk(monkeypatch):
    """A chunked instance's key carries its chunk and X/G mode (checked
    against the rule when it compiles); an unchunked one's does not."""
    loads = []

    class Lib:
        def __getattr__(self, name):
            return name

    monkeypatch.setattr(_build, "load_instance", lambda inst: loads.append(inst) or Lib())
    for label in SHAPES:
        spec = _spec(label)
        for body in (*BODIES, "nuts"):
            loads.clear()
            cm.mm_library(body, spec, *cm.mm_shape(spec))
            rule = cm.nuts_mm_tile_rule(spec) if body == "nuts" else cm.mm_tile_rule(spec, body)
            (inst,) = loads
            assert inst.macros[-2:] == (f"-DMJHMC_MM_OD_CHUNK={rule.chunk}",
                                        f"-DMJHMC_MM_OD_XG={int(rule.xg_off)}")
            assert f"_kc{rule.chunk}" in inst.stem and inst.stem.endswith(
                "_xg" if rule.xg_off else f"_kc{rule.chunk}")
    assert len(_build.mm_instance(0, 1, 288, 144, 1, True).macros) == 6


@pytest.mark.parametrize("n", (8, 64, 2048))
def test_split_scratch_and_deep_rows(n):
    """a9a's NUTS tile past the tile depth (13) in the split plan and a CTA
    a tile: the device buffer is the parameter matrix, the tree's rows
    past 12 a chain (rank 0 of a split tile alone writes them), then, after
    16-byte alignment, each launched block's span slots past 12 for as many
    blocks as any plan launches (16 CTAs a tile where it may split); the
    last block of each plan's grid ends within it, and the shared memory
    holds the split partials (G's [DP][NC] and two energy partials a
    thread)."""
    spec = _spec("logreg 124x32561")
    rule, geom = cm.nuts_mm_tile_rule(spec), cm.nuts_mm_geometry_of(spec)
    assert cm.nuts_splits(rule) and rule.onchip
    depth, deep = 13, cm.nuts_deep_rows(13)
    head = -(-(cm.param_floats(spec) + deep * geom.dp * n) // 4) * 4
    tiles = -(-n // rule.chains)
    blocks = cm.launched_blocks(rule, n, True)
    assert blocks == 16 * tiles
    assert cm.nuts_scratch_floats(spec, depth, n) == head + blocks * deep * rule.threads
    for held in (HELD_ONE, (66, 32, 16, 0), (66, 32, 0, 0)):
        c, split, grid = cm.cluster_plan(tiles, held, True)
        assert head + grid * deep * rule.threads <= cm.nuts_scratch_floats(spec, depth, n)
    no_split = cm.nuts_mm_geometry(spec, rule.chains, rule.threads, True, False, rule.chunk,
                                   False, rule.stages)
    assert geom.tree - no_split.tree == cm.split_floats(geom.dp, rule.chains, rule.threads)


@pytest.mark.parametrize("body", (*BODIES, "nuts"))
def test_on_demand_key_unchanged_by_the_cluster(body, monkeypatch):
    """The cluster's size and mode are launch attributes chosen from the
    chain count and the card: an instance's key (its -D macros and name) is
    the same whatever the plan, so one build serves every chain count."""
    loads = []

    class Lib:
        def __getattr__(self, name):
            return name

    monkeypatch.setattr(_build, "load_instance", lambda inst: loads.append(inst) or Lib())
    spec = _spec("logreg 124x32561")
    rule = cm.nuts_mm_tile_rule(spec) if body == "nuts" else cm.mm_tile_rule(spec, body)
    splits = cm.nuts_splits(rule) if body == "nuts" else cm.mm_splits(rule)
    plans = {cm.cluster_plan(-(-n // rule.chains), HELD_ONE, splits) for n in (8, 64, 2048)}
    assert len(plans) > 1  # the plans differ by chain count
    for _ in plans:
        cm.mm_library(body, spec, *cm.mm_shape(spec))
    assert len({(inst.stem, inst.macros) for inst in loads}) == 1
    assert not any("CLUSTER" in m for m in loads[0].macros)


def _jax_state(jd, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((jd.ndims, n))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, n)).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = np.zeros(n, np.float32)
    return x, v, g, u, z, z.copy()


def _close(a, b, what, rtol=1e-4):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64).reshape(a.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(), err_msg=what)


@pytest.mark.parametrize("body", BODIES)
def test_plain_version_matches_interpret_kernel_past_one_block(body):
    """The plain version against ``pallas_mjhmc_mm_run`` in interpret mode
    at logistic regression 4 × 20,000 (128 chains, 2 iterations of M 3,
    ε 0.01, fixed uniforms, "highest")."""
    kw = SHAPES["logreg 4x20000"][1]
    jd, td = jmodels.LogisticRegression(**kw), tmodels.LogisticRegression(**kw)
    jspec = dataclasses.replace(energy_spec_for(jd), precision="highest")
    tspec = dataclasses.replace(cm.energy_spec_for(td), precision="highest")
    n, eps, beta = 128, 0.01, {"mjhmc": 0.1, "control": 0.2, "malt": 1.0}[body]
    st = _jax_state(jd, n)
    jx = tuple(jnp.asarray(a) for a in st[:3]) + tuple(jnp.asarray(a)[None] for a in st[3:])
    tx = tuple(torch.as_tensor(a) for a in st)
    scal = (jnp.int32(7), jnp.float32(eps), jnp.float32(beta))
    out_j = pallas_mjhmc_mm_run(jspec, *jx, *scal, 2, 3, interpret=pltpu.InterpretParams(),
                                variant=body)
    out_t = cm.run_reference(tspec, *tx, 7, eps, beta, 2, 3, fixed_uniform=True, variant=body)
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel(), body)
    np.testing.assert_array_equal(out_t.back_valid.numpy(), np.asarray(out_j.back_valid).ravel())
    if body == "mjhmc":
        _close(out_t.w.double().sum(), np.asarray(out_j.w, np.float64).sum(), "Σw")
    else:
        np.testing.assert_array_equal(out_t.w.numpy(), np.asarray(out_j.w).ravel(), body)
    for f in ("x", "v", "grad", "u", "h_back"):
        _close(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)), f"{body} {f}")
