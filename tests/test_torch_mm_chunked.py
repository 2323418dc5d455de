"""The matmul engine past one block's shared memory: the chunked tiles.

Where even the 8-column tile's k-row intermediates (Y, Z) pass the 227 KB a
block may hold, the tile rule (``cuda_mjhmc.mm_tile_rule``,
``nuts_mm_tile_rule``, mirroring ``TileRule`` in
``csrc/mjhmc_mm_engine.cuh``) runs the K rows in chunks with the parameter
matrix in the device buffer, and where even 8 columns of X and G do not fit
beside a chunk, X, G and the mass move to each block's slice of that
buffer. Here, without nvcc: the rule's tiles at logistic regression 4 ×
20,000 and at LIBSVM a9a's shape (124 × 32,561), and at sparse coding on
32 × 32 patches with a 4× overcomplete dictionary (1,024 × 4,096); the
device buffer's size against the geometry; no refusal below it; the
on-demand key naming the chunk; and the plain version (the kernels'
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
    at max_depth 12), the 8-column tile where X and G are off chip."""
    spec = _spec(label, precision)
    xg = SHAPES[label][2]
    for body in BODIES:
        rule = cm.mm_tile_rule(spec, body)
        g = cm.mm_geometry(spec, body, True, rule.chains, rule.threads, rule.off, rule.chunk,
                           rule.xg_off)
        assert rule.off and rule.chunk > 0 and rule.xg_off == xg, rule
        assert rule.chunk % 16 == 0 and rule.chunk % g.row_owners == 0 and g.kp == rule.chunk
        assert rule.chunk <= cm.CHUNK_MAX and rule.threads <= cm.MAX_THREADS
        assert g.columns % 8 == 0 and g.dp >= cm.mm_shape(spec)[0]
        assert cm.mm_smem_bytes(spec, body, True) <= cm.SMEM_BLOCK
        assert rule.minb * rule.threads <= max(cm.MAX_THREADS, rule.threads)
        if xg:
            assert g.columns == 8 and g.slice == g.dp * (g.ld + g.columns + 2)
    rule = cm.nuts_mm_tile_rule(spec)
    assert rule.off and rule.chunk > 0 and rule.xg_off == xg and rule.chunk % 16 == 0
    at12 = cm.nuts_mm_smem_bytes(spec, cm.NUTS_MM_TILE_DEPTH)
    assert at12 <= cm.SMEM_BLOCK and cm.nuts_mm_smem_bytes(spec, 31) == at12
    if xg:
        assert rule.chains == 8 and not rule.onchip


def test_a9a_and_sparse_coding_tiles():
    """The slice's two configurations at their JAX default precisions: a9a's
    tiles keep the base threads (an owner holds few dims) and chunks of 512
    rows; sparse coding's grow to 1,024 threads a block."""
    a9a, sc = _spec("logreg 124x32561"), _spec("sparse_coding 4096x1024")
    assert (a9a.precision, sc.precision) == ("default", "bf16x3")
    assert cm.mm_tile_rule(a9a, "mjhmc")[:2] == (4, 128)
    assert cm.mm_tile_rule(a9a, "control")[:2] == (8, 128)
    assert cm.nuts_mm_tile_rule(a9a).chunk == 512 and cm.nuts_mm_tile_rule(a9a).onchip
    assert cm.mm_tile_rule(sc, "mjhmc")[:2] == (4, 1024)
    assert cm.nuts_mm_tile_rule(sc)[:2] == (8, 1024)


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
                           rule.xg_off)
        for n in (1, rule.chains, 1000, 2048):
            want = params + (-(-n // rule.chains) * g.slice if rule.xg_off else 0)
            assert cm.mm_scratch_floats(spec, body, n) == want
            assert cm.mm_scratch(spec, body, n, "meta").shape == (want,)
    rule, geom = cm.nuts_mm_tile_rule(spec), cm.nuts_mm_geometry_of(spec)
    for depth, n in ((1, 8), (4, 1000), (12, 2048)):
        tree = 0 if rule.onchip else cm.nuts_scratch_rows(depth) * geom.dp * n
        want = params + tree
        if rule.xg_off:
            want = -(-want // 4) * 4 + -(-n // rule.chains) * geom.slice
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
                                  rule.xg_off)
            tree = 0
            buf = cm.mm_scratch(spec, body, n, "meta")
        report = (rule.chains, rule.threads, 0, 1, geom.slice, params, tree)
        cm._check_buffer(entries(report), spec, body, True, depth, n, buf)
        for bad in ((report[0] * 2, *report[1:]), (*report[:4], report[4] + 1, *report[5:]),
                    (*report[:5], params + 4, tree)):
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
