"""The matmul engine at every (d, k) and dot precision the JAX engine takes.

The library (``csrc/mjhmc_mm_engine.cu`` and its instance sources) is
compiled ahead at the presets' shapes and precisions
(``cuda_mjhmc.MM_KERNEL_SHAPES``, ``MM_KERNEL_PRECISIONS``); any other
(body, energy, d, k, precision) runs on an instance compiled at its first
use from ``csrc/ondemand/mm_instance.cu`` (``_build.mm_instance``), its tile
and parameter-matrix mode from the tile rule (``cuda_mjhmc.mm_tile_rule``,
``nuts_mm_tile_rule``). Here, without nvcc, at the shapes
``chip_smoke.py`` phase 43 holds on the card (``chip_smoke.ANY_MM_SHAPES``):
the port's specs against JAX's ``MatmulEnergySpec`` forms (as
``tests/test_pallas_engine.py:44-83`` holds them); the plain version, the
kernels' stand-in here, against the TPU kernels in Pallas interpret mode at
four of the shapes (fixed uniforms, as
``test_interpret_mode_counters_exact_matmul_layout`` runs them): counters and
cache flags exact, control's and MALT's weights exact, MJHMC's Σw and every
state within rtol 1e-4 (atol 1e-4 of the field's largest value), at
``precision="highest"``, where both compute full f32; the tile rule's
mirror; the dispatch and the on-demand build's keys (a fake compiler); the
engines' entry points on the CPU.
"""

import dataclasses
import shutil
import stat

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
    pallas_mjhmc_mm_stream_run,
)
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.ops import _build
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

SHAPES = list(chip_smoke.ANY_MM_SHAPES)
IP = pltpu.InterpretParams()
N = 128
#: the shapes held against the interpret-mode kernels: JAX's own two, one
#: with no dim or row a multiple of 4, a logreg with padded observation rows
KERNEL_SHAPES = ("sparse_coding 96x64", "logreg 16x64", "product_of_t 10x13", "logreg 7x100")
#: the presets' tiles before the tile rule: mm_kernel's (chains, threads) by
#: energy and body, NUTS's (chains, threads, tree state in shared memory)
PRESET_MM_TILES = {("ProductOfT", "mjhmc"): (8, 96), ("ProductOfT", "control"): (8, 96),
                   ("ProductOfT", "malt"): (8, 96), ("SparseCoding", "mjhmc"): (16, 256),
                   ("SparseCoding", "control"): (16, 256), ("SparseCoding", "malt"): (16, 256),
                   ("LogisticRegression", "mjhmc"): (4, 128),
                   ("LogisticRegression", "control"): (8, 128),
                   ("LogisticRegression", "malt"): (8, 128)}
PRESET_NUTS_TILES = {"ProductOfT": (8, 96, True), "SparseCoding": (16, 256, False),
                     "LogisticRegression": (8, 128, True)}


def _pair(label):
    name, kw, eps, m = chip_smoke.ANY_MM_SHAPES[label]
    return (chip_smoke.any_mm_model(jmodels, name, kw), chip_smoke.any_mm_model(tmodels, name, kw),
            eps, m)


def _specs(label, precision=None):
    jd, td, eps, m = _pair(label)
    jspec, tspec = energy_spec_for(jd), cm.energy_spec_for(td)
    if precision is not None:
        jspec = dataclasses.replace(jspec, precision=precision)
        tspec = dataclasses.replace(tspec, precision=precision)
    return jd, td, jspec, tspec, eps, m


def _close(a, b, what, rtol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64).reshape(a.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(), err_msg=what)


def _state(jd, n, seed=0):
    """(d, n) / (n,) NumPy state at the model's init scale, v ~ N(0, I)."""
    scale = {"ProductOfT": 2.0, "SparseCoding": 0.1}.get(type(jd).__name__, 1.0)
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((jd.ndims, n))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, n)).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = np.zeros(n, np.float32)
    return x, v, g, u, z, z.copy()


# ---- the specs against JAX's ---------------------------------------------------
@pytest.mark.parametrize("precision", ["highest", "bf16x3", "bf16x2"])
@pytest.mark.parametrize("label", SHAPES)
def test_spec_matches_jax_matmul_spec(label, precision):
    """u_sum and du of the port's spec against JAX's MatmulEnergySpec on the
    same x: rtol 1e-4 at "highest" (full f32 on both sides), 5e-3 at the
    split-float precisions (both split by hand; σ⁻² = 100 amplifies sparse
    coding's split residual, as tests/test_pallas_engine.py:44-83 bounds it)."""
    jd, td, jspec, tspec, _, _ = _specs(label, precision)
    x = _state(jd, 64, seed=1)[0]
    jp = [jnp.asarray(p) for p in jspec.param_arrays()]
    tp = cm._param_tensors(tspec, td.ndims, "cpu")
    tol = 1e-4 if precision == "highest" else 5e-3
    _close(tspec.u_sum(torch.as_tensor(x), *tp).numpy(),
           np.asarray(jspec.u_sum(jnp.asarray(x), *jp))[0], f"{label} u_sum", tol)
    _close(tspec.du(torch.as_tensor(x), *tp).numpy(), np.asarray(jspec.du(jnp.asarray(x), *jp)),
           f"{label} du", tol)
    assert cm.mm_shape(tspec) == (td.ndims, tspec.aux_rows()) == (jd.ndims, jspec.aux_rows())


# ---- the kernels' stand-in against the interpret-mode TPU kernels --------------
@pytest.mark.parametrize("body", ["mjhmc", "control", "malt"])
@pytest.mark.parametrize("label", KERNEL_SHAPES)
def test_plain_version_matches_interpret_kernel(label, body):
    """The plain version (what the CPU runs in the kernel's place) against
    ``pallas_mjhmc_mm_run`` in interpret mode at 128 chains, 3 iterations,
    fixed uniforms, both at "highest"; MJHMC's stream against
    ``pallas_mjhmc_mm_stream_run``."""
    jd, _, jspec, tspec, eps, _ = _specs(label, "highest")
    st = _state(jd, N)
    beta = chip_smoke.ANY_MM_BETA[body]
    jx = tuple(jnp.asarray(a) for a in st[:3]) + tuple(jnp.asarray(a)[None] for a in st[3:])
    tx = tuple(torch.as_tensor(a) for a in st)
    scal = (jnp.int32(7), jnp.float32(eps), jnp.float32(beta))
    out_j = pallas_mjhmc_mm_run(jspec, *jx, *scal, 3, 5, interpret=IP, variant=body)
    out_t = cm.run_reference(tspec, *tx, 7, eps, beta, 3, 5, fixed_uniform=True, variant=body)
    what = f"{label} {body}"
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel(), what)
    np.testing.assert_array_equal(out_t.back_valid.numpy(),
                                  np.asarray(out_j.back_valid).ravel(), what)
    if body == "mjhmc":
        _close(out_t.w.double().sum(), np.asarray(out_j.w, np.float64).sum(), f"{what} Σw", 1e-4)
    else:
        np.testing.assert_array_equal(out_t.w.numpy(), np.asarray(out_j.w).ravel(), what)
    for f in ("x", "v", "grad", "u", "h_back"):
        _close(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)), f"{what} {f}", 1e-4)
    if body == "mjhmc" and label in ("product_of_t 10x13", "logreg 7x100"):
        xs_j, ws_j, es_j, _ = pallas_mjhmc_mm_stream_run(jspec, *jx, *scal, 2, 1, 5,
                                                         interpret=IP)
        xs_t, ws_t, es_t, _ = cm.stream_reference(tspec, *tx, 7, eps, beta, 2, 1, 5,
                                                  fixed_uniform=True)
        np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(es_t.shape))
        _close(xs_t.numpy(), np.asarray(xs_j), f"{what} xs", 1e-4)
        _close(ws_t.double().sum(1).numpy(), np.asarray(ws_j, np.float64).reshape(2, N).sum(1),
               f"{what} Σws", 1e-4)


# ---- the tile rule -------------------------------------------------------------
def _all_specs():
    """Every (label, spec) of the tests: the presets and the any-(d, k)
    shapes, at each dot precision."""
    out = [(type(d).__name__, cm.energy_spec_for(d)) for d in (
        tmodels.ProductOfT(), tmodels.SparseCoding(), tmodels.LogisticRegression())]
    out += [(label, cm.energy_spec_for(_pair(label)[1])) for label in SHAPES]
    return [(label, dataclasses.replace(spec, precision=p)) for label, spec in out
            for p in cm.PRECISIONS]


def test_tile_rule_gives_the_presets_their_tiles():
    """At the presets' shapes the rule gives the tiles the per-energy
    constants gave, at every precision, on chip."""
    for name in ("ProductOfT", "SparseCoding", "LogisticRegression"):
        for p in cm.PRECISIONS:
            spec = dataclasses.replace(cm.energy_spec_for(getattr(tmodels, name)()), precision=p)
            for body in ("mjhmc", "control", "malt"):
                rule = cm.mm_tile_rule(spec, body)
                assert (rule.chains, rule.threads) == PRESET_MM_TILES[(name, body)]
                assert not rule.off
            rule = cm.nuts_mm_tile_rule(spec)
            assert (rule.chains, rule.threads, rule.onchip) == PRESET_NUTS_TILES[name]
            assert not rule.off


@pytest.mark.parametrize("label", ["ProductOfT", "SparseCoding", "LogisticRegression", *SHAPES])
def test_tile_rule_fits_and_goes_off_chip_only_where_it_must(label):
    """Every body's layout at every precision fits the 227 KB a block may
    hold (mm_kernel's with the branches, NUTS's at max_depth 12); a chain's
    threads own whole groups and rows of the padded tile, which covers the
    shape; the parameter matrix leaves shared memory only at (288, 144),
    where even the smallest tile cannot hold it (at "highest" and at the
    spec's default "bf16x3"), and there the smaller tile is not needed."""
    for lab, spec in _all_specs():
        if lab != label:
            continue
        d, k = cm.mm_shape(spec)
        for body in ("mjhmc", "control", "malt"):
            rule = cm.mm_tile_rule(spec, body)
            assert cm.mm_smem_bytes(spec, body, True) <= cm.SMEM_BLOCK
            g = cm.mm_geometry(spec, body, True, rule.chains, rule.threads, rule.off)
            assert rule.threads % rule.chains == 0 and rule.threads % 32 == 0
            assert g.columns % 8 == 0 and g.dim_owners <= g.row_owners
            assert g.dp == 4 * g.dim_owners * g.groups >= d and g.kp == g.row_owners * g.rows >= k
            assert rule.off == (label == "sparse_coding 288x144"
                                and spec.precision in ("highest", "bf16x3"))
        rule = cm.nuts_mm_tile_rule(spec)
        at12 = cm.nuts_mm_smem_bytes(spec, cm.NUTS_MM_TILE_DEPTH)
        assert at12 <= cm.SMEM_BLOCK and cm.nuts_mm_smem_bytes(spec, 31) == at12
        assert rule.off == (label == "sparse_coding 288x144"
                            and spec.precision in ("highest", "bf16x3"))
    if label == "sparse_coding 200x100":  # on chip only with a smaller tile
        spec = cm.energy_spec_for(_pair(label)[1])
        assert cm.mm_tile_rule(spec, "mjhmc")[:2] == (8, 128)
        assert cm.nuts_mm_tile_rule(spec)[:2] == (8, 128)


def test_scratch_holds_the_parameter_matrix_off_chip():
    """The wrapper's device buffer: none on chip; off chip the parameter
    matrix (and NUTS's tree state after it, in the padded dims)."""
    spec = cm.energy_spec_for(_pair("sparse_coding 288x144")[1])
    params = cm.param_floats(spec)
    assert params == 2 * 2 * (144 * 288 // 2)  # bf16x3: hi and lo of both contractions
    assert cm.mm_scratch(spec, "mjhmc", 100, "meta").shape == (params,)
    geom = cm.nuts_mm_geometry_of(spec)
    assert cm.nuts_scratch(spec, 8, 100, "meta").shape == (
        params + cm.nuts_scratch_rows(8) * geom.dp * 100,)
    small = cm.energy_spec_for(_pair("product_of_t 10x13")[1])
    assert cm.mm_scratch(small, "control", 100, "meta") is None
    assert cm.nuts_scratch(small, 8, 100, "meta") is None


def test_a_shape_no_tile_holds_is_refused():
    """No shape is refused by the tile rule any more: where no tile holds
    the 8-column layout even with the parameter matrix off chip (logreg 4 ×
    20,000 and 124 × 32,561), the rule chunks the k rows, and where even X
    and G pass a block beside a chunk (sparse coding 1,024 × 4,096), they
    move to the device buffer; the wrappers' buffers are the geometry's,
    so the allocation is the only limit. The launch then refuses only what
    is not a cuda tensor."""
    cases = ((tmodels.LogisticRegression(ndims=4, nobs=20000), False),
             (tmodels.LogisticRegression(ndims=124, nobs=32561), False),
             (tmodels.SparseCoding(npixels=1024, nbasis=4096, phi_source="gabor"), True))
    for dist, xg in cases:
        spec = cm.energy_spec_for(dist)
        for rule in [cm.mm_tile_rule(spec, b) for b in ("mjhmc", "control", "malt")] + [
                cm.nuts_mm_tile_rule(spec)]:
            assert rule.off and rule.chunk > 0 and rule.xg_off == xg, rule
        for body in ("mjhmc", "control", "malt"):
            rule = cm.mm_tile_rule(spec, body)
            g = cm.mm_geometry(spec, body, True, rule.chains, rule.threads, True, rule.chunk,
                               rule.xg_off)
            assert cm.mm_scratch(spec, body, 4096, "meta").numel() == (
                cm.param_floats(spec) + (4096 // rule.chains) * g.slice)
        geom = cm.nuts_mm_geometry_of(spec)
        tree = 0 if cm.nuts_mm_tile_rule(spec).onchip else cm.nuts_scratch_rows(8) * geom.dp * 64
        assert cm.nuts_scratch(spec, 8, 64, "meta").numel() == (
            -(-(cm.param_floats(spec) + tree) // 4) * 4 + 8 * geom.slice if xg
            else cm.param_floats(spec) + tree)
    spec = cm.energy_spec_for(cases[0][0])
    x = torch.zeros((4, 8), device="meta")
    z = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="takes cuda tensors"):
        cm.cuda_mjhmc_mm_run(spec, x, x, x, z, z, z, 5, 0.1, 0.2, 2, 3, variant="control")


# ---- dispatch and the on-demand build --------------------------------------------
def test_presets_take_the_library_and_other_keys_an_instance(monkeypatch):
    """The presets' compiled-ahead pairs take the library's entries (the
    sweep's precisions for the MJHMC run only); every other key the
    on-demand instance of (body, energy, d, k, precision, the tile rule's
    mode); a spec at other dims than the state's is refused."""
    loads = []

    class Lib:
        def __getattr__(self, name):
            return name

    monkeypatch.setattr(_build, "load", lambda: loads.append("library") or Lib())
    monkeypatch.setattr(_build, "load_instance", lambda inst: loads.append(inst) or Lib())
    library = ("mjhmc_mm_engine_launch", "mjhmc_mm_tile", "mjhmc_mm_nuts_tile")
    ondemand = ("mjhmc_mm_od_launch", "mjhmc_mm_od_tile", "mjhmc_mm_od_nuts_tile")
    for dist in (tmodels.ProductOfT(), tmodels.SparseCoding(), tmodels.LogisticRegression()):
        spec0 = cm.energy_spec_for(dist)
        for p, have in cm.MM_KERNEL_PRECISIONS[type(spec0)].items():
            spec = dataclasses.replace(spec0, precision=p)
            for body in ("mjhmc", "control", "malt", "nuts"):
                for sweep_run in (False, True):
                    loads.clear()
                    e = cm.mm_library(body, spec, *cm.mm_shape(spec), sweep_run)
                    ahead = have == cm.ALL_BODIES or (sweep_run and have == cm.SWEEP_RUN)
                    assert tuple(e) == (library if ahead else ondemand)
                    assert (loads == ["library"]) == ahead
    for label in SHAPES:
        spec = cm.energy_spec_for(_pair(label)[1])
        for body in ("mjhmc", "control", "malt", "nuts"):
            loads.clear()
            e = cm.mm_library(body, spec, *cm.mm_shape(spec), True)
            rule = cm.nuts_mm_tile_rule(spec) if body == "nuts" else cm.mm_tile_rule(spec, body)
            assert tuple(e) == ondemand and loads == [_build.mm_instance(
                cm.KERNEL_VARIANTS[body], spec.energy_id, *cm.mm_shape(spec),
                cm.PRECISIONS.index(spec.precision), rule.off)]
    spec = cm.energy_spec_for(_pair("logreg 7x100")[1])
    with pytest.raises(ValueError, match="built for"):
        cm.mm_library("mjhmc", spec, 8, 100)
    with pytest.raises(ValueError, match="built for 7 dims"):
        cm.check_mm_dims(spec, 8)
    with pytest.raises(ValueError, match="built for 7 dims"):
        cm.check_mm_dims(spec, 0)


def test_mm_instance_command_and_names_follow_the_key(monkeypatch, tmp_path):
    """One nvcc with the library's flags and the instance's six macros into
    a shared library that refuses undefined symbols, reading only under
    ``csrc/`` and writing only under ``build/``; its name carries the key
    and a hash of the source, the headers, the flags and the macros: every
    field of the key, and an edit of the source or a header, names another
    library."""
    monkeypatch.setattr(_build, "_nvcc", lambda: "/toolkit/bin/nvcc")
    inst = _build.mm_instance(0, 1, 288, 144, 1, True)
    assert inst.macros == ("-DMJHMC_MM_OD_VARIANT=0", "-DMJHMC_MM_OD_ENERGY=1",
                           "-DMJHMC_MM_OD_DIMS=288", "-DMJHMC_MM_OD_KROWS=144",
                           "-DMJHMC_MM_OD_PRECISION=1", "-DMJHMC_MM_OD_OFFCHIP=1")
    out = _build.instance_path(inst)
    cmd = _build.instance_command(inst, out)
    assert cmd[0] == "/toolkit/bin/nvcc" and all(m in cmd for m in inst.macros)
    assert tuple(cmd[1:1 + len(_build.NVCC_FLAGS)]) == _build.NVCC_FLAGS
    assert {"-shared", "--no-undefined"} <= set(cmd)
    assert [a for a in cmd[1:] if "/" in a and not a.startswith("-")] == [
        str(out), str(_build.MM_SOURCE)]
    assert out.parent == _build.BUILD_DIR and _build.MM_SOURCE.parent.parent == _build.CSRC
    assert _build.MM_SOURCE.name not in _build.KERNEL_SOURCES
    assert out.name.startswith("libmjhmc_mm_mjhmc_sparse_coding_d288_k144_bf16x3_off_")
    assert dict(inst.entries).keys() == {"mjhmc_mm_od_launch", "mjhmc_mm_od_tile",
                                         "mjhmc_mm_od_nuts_tile"}
    assert list(dict(inst.entries)["mjhmc_mm_od_launch"]) == _build.MM_LAUNCH_ARGTYPES
    keys = [(0, 1, 288, 144, 1, True), (2, 1, 288, 144, 1, True), (0, 2, 288, 144, 1, True),
            (0, 1, 289, 144, 1, True), (0, 1, 288, 145, 1, True), (0, 1, 288, 144, 3, True),
            (0, 1, 288, 144, 1, False)]
    names = {_build.instance_path(_build.mm_instance(*k)).name for k in keys}
    assert len(names) == len(keys)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "MM_SOURCE", csrc / "ondemand" / "mm_instance.cu")
    seen = {_build.instance_path(_build.mm_instance(*keys[0])).name}
    for edited in (csrc / "ondemand" / "mm_instance.cu", csrc / "mjhmc_mm_engine.cuh",
                   csrc / "mma_bf16.cuh"):
        edited.write_text(edited.read_text() + "\n// edited\n")
        name = _build.instance_path(_build.mm_instance(*keys[0])).name
        assert name not in seen
        seen.add(name)


def test_failed_mm_build_raises(monkeypatch, tmp_path):
    """A failing compiler makes the on-demand matmul instance's load raise
    ``RuntimeError`` with its report and leaves no library; nothing falls
    back."""
    path = tmp_path / "fake_nvcc"
    path.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 2\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(path))
    inst = _build.mm_instance(1, 2, 7, 100, 3, False)
    _build.load_instance.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="(?s)exit code 2.*no card here"):
            _build.load_instance(inst)
        assert not _build.instance_path(inst).exists()
        assert "no card here" in _build.instance_log(inst)
    finally:
        _build.load_instance.cache_clear()


# ---- the engines on the CPU ----------------------------------------------------------
@pytest.mark.parametrize("label", SHAPES)
def test_engines_take_every_shape_on_the_cpu(label):
    """CudaMJHMC, CudaControlHMC, CudaMALT and CudaNUTS at ``device="cpu"``
    run every shape (the plain version; no launch counted): finite states,
    exact counters for control and MALT, a stream of the right shape; their
    default device stays the card."""
    _, td, eps, m = _pair(label)
    before = {k: getattr(cm.cuda_mjhmc_mm_run, k) for k in cm.COUNTS}
    for cls, kw in ((cm.CudaMJHMC, {}), (cm.CudaControlHMC, {}), (cm.CudaMALT, {}),
                    (cm.CudaNUTS, dict(num_leapfrog_steps=3))):
        assert next(f.default for f in dataclasses.fields(cls) if f.name == "device") == "cuda"
        eng = cls(td, epsilon=eps, nbatch=16, seed=1, device="cpu",
                  **({"num_leapfrog_steps": 3} | kw))
        out = eng.run(2)
        xs, ws = eng.sample(2)
        assert xs.shape == (2, td.ndims, 16) and ws.shape == (2, 16)
        assert bool(torch.isfinite(out.x).all()) and bool(torch.isfinite(out.u).all())
        if cls in (cm.CudaControlHMC, cm.CudaMALT):
            assert bool((out.evals == 2 * 3).all()) and bool((out.w == 2).all())
    assert {k: getattr(cm.cuda_mjhmc_mm_run, k) for k in cm.COUNTS} == before


# ---- chip_smoke.py's process beside phase 39 ------------------------------------------
def test_side_process_waits_for_phase_39(tmp_path):
    """``chip_smoke.py --plain-rows40`` (phase 40's plain rows and the
    statistics of phases 42-43, begun at phase 2's end) imports, then waits
    for phase 39's line; where its input closes first it exits 3 and writes
    no result."""
    import subprocess
    import sys
    import time

    (tmp_path / "plain_nuts_d8.json").write_text('{"var": [1.0], "leaves": 1.0, "what": ""}')
    proc = subprocess.run([sys.executable, chip_smoke.__file__, "--plain-rows40",
                           repr(time.time()), str(tmp_path)], stdin=subprocess.DEVNULL,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert not (tmp_path / "rows40.json").exists()


def test_stop_children_spares_the_side_process():
    """``stop_children`` leaves a child in ``SPARED`` running (phase 21's and
    43's pools stop their children while phase 40's process waits) and stops
    it once it leaves the set."""
    import subprocess

    child = subprocess.Popen(["sleep", "60"])
    chip_smoke.SPARED.add(child.pid)
    try:
        assert "sleep 60" not in chip_smoke.stop_children()
        assert child.poll() is None
    finally:
        chip_smoke.SPARED.discard(child.pid)
    assert "sleep 60" in chip_smoke.stop_children()
    assert child.wait(timeout=30) is not None
