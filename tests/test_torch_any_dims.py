"""The elementwise engine at every D the JAX engine takes.

The library (``csrc/mjhmc_engine.cu`` and its instance sources) is compiled
ahead at the presets' D (``cuda_mjhmc.KERNEL_DIMS``); any other (body,
energy, D), and a mixture of more components than the library holds, runs
on an instance compiled at its first use from
``csrc/ondemand/ew_instance.cu`` (``_build.load_instance`` of an
``_build.ew_instance``). Here, without
nvcc: the dispatch between the two, the on-demand build's command, key and
failures (a fake compiler); the plain versions of every body at the JAX
package's TPU-gated shapes (tests/test_pallas_engine.py:455-889: Gaussian
D 4, 8 and 16, the funnel at D 8), at a banana of D 10, a mixture of 10
components and the funnel at D 12 and 30 (control's whole mode with the
Metropolis uniform in a block of its own, MALT on 8 lanes), against the TPU kernels in Pallas interpret mode as
``test_torch_zoo_engine._compare`` holds them (fixed uniforms, its
tolerances and nudge allowance); the lane mirror at those D; the engines'
entry points on the CPU at them. ``chip_smoke.py`` phase 42 holds the
compiled instances to these plain versions on the card, at the same shapes
(``chip_smoke.ANY_D_SHAPES``) and at Gaussian D 3 and 128.
"""

import shutil
import stat

import numpy as np
import pytest
import torch

import chip_smoke
from mjhmc_tpu import models as jmodels
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
from mjhmc_tpu_torch.ops import _build
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

from test_torch_zoo_engine import NUTS_DEPTH, _compare

torch.set_num_threads(1)

BODIES = ("mjhmc", "control", "malt", "nuts")
SHAPES = list(chip_smoke.ANY_D_SHAPES)


def _pair(label):
    name, kw, eps, m = chip_smoke.ANY_D_SHAPES[label]
    return getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw), eps, m


def _many_components():
    return tmodels.GaussianMixture(means=tuple((float(k),) for k in range(9)),
                                   scales=(1.0,) * 9, weights=(1.0 / 9,) * 9)


# ---- dispatch and the on-demand build ----------------------------------------
def test_presets_take_the_library_and_other_shapes_an_instance(monkeypatch):
    """Every (body, preset spec, D) of ``KERNEL_DIMS`` takes the library's
    entries; every any-D shape, and a mixture of 9 components at the
    preset's D, the on-demand instance keyed by (body id, energy id, D,
    component cap)."""
    loads = []

    class Lib:
        def __getattr__(self, name):
            return name

    monkeypatch.setattr(_build, "load", lambda: loads.append("library") or Lib())
    monkeypatch.setattr(_build, "load_instance", lambda *key: loads.append(key) or Lib())
    presets = [BENCHMARK_CONFIGS[c].make_distribution() for c in (
        "rough_well", "gauss2d", "gauss50d", "funnel", "banana", "mog", "eight_schools")]
    presets.append(tmodels.EightSchools(parameterization="noncentered"))
    presets.append(tmodels.RoughWell(ndims=50))
    for dist in presets:
        spec = cm.energy_spec_for(dist)
        assert cm.compiled_ahead(spec, dist.ndims)
        for body in BODIES:
            loads.clear()
            e = cm.ew_library(body, spec, dist.ndims)
            assert loads == ["library"]
            assert (e.launch, e.ew_tile, e.nuts_tile) == (
                "mjhmc_engine_launch", "mjhmc_ew_tile", "mjhmc_nuts_tile")
    others = [d for d, _, _ in chip_smoke.any_d_dists().values()] + [_many_components()]
    for dist in others:
        spec = cm.energy_spec_for(dist)
        assert not cm.compiled_ahead(spec, dist.ndims)
        for body in BODIES:
            loads.clear()
            e = cm.ew_library(body, spec, dist.ndims)
            cap = max(8, len(getattr(dist, "scales", ())))
            assert loads == [(_build.ew_instance(cm.KERNEL_VARIANTS[body], spec.energy_id,
                                                 dist.ndims, cap),)]
            assert (e.launch, e.ew_tile, e.nuts_tile) == (
                "mjhmc_od_launch", "mjhmc_od_ew_tile", "mjhmc_od_nuts_tile")
    assert cm.mog_cap(cm.energy_spec_for(_many_components())) == 9


def test_instance_command_reads_csrc_and_writes_build(monkeypatch):
    """One nvcc with the library's flags (sm_90a, no fast-math), the
    instance's macros, a shared library that refuses undefined symbols; the
    only file it reads is under ``mjhmc_tpu_torch/csrc/``, the only one it
    writes under ``build/``. The source sits outside the library's glob."""
    monkeypatch.setattr(_build, "_nvcc", lambda: "/toolkit/bin/nvcc")
    inst = _build.ew_instance(2, 1, 16, 8)
    out = _build.instance_path(inst)
    cmd = _build.instance_command(inst, out)
    assert cmd[0] == "/toolkit/bin/nvcc"
    assert tuple(cmd[1:1 + len(_build.NVCC_FLAGS)]) == _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cmd and "--use_fast_math" not in cmd
    assert inst.macros == (
        "-DMJHMC_OD_VARIANT=2", "-DMJHMC_OD_ENERGY=1", "-DMJHMC_OD_DIMS=16",
        "-DMJHMC_MOG_MAX_COMPONENTS=8")
    assert all(m in cmd for m in inst.macros)
    assert {"-shared", "--no-undefined"} <= set(cmd)
    files = [a for a in cmd[1:] if "/" in a and not a.startswith("-")]
    assert files == [str(out), str(_build.EW_SOURCE)]
    assert out.parent == _build.BUILD_DIR and out.parent.parent.name == "build"
    assert _build.EW_SOURCE.parent.parent == _build.CSRC
    assert _build.EW_SOURCE.exists()
    assert _build.EW_SOURCE.name not in _build.KERNEL_SOURCES
    assert out.name.startswith("libmjhmc_ew_control_gaussian_d16_k8_") and out.suffix == ".so"


def test_instance_name_follows_macros_and_sources(monkeypatch, tmp_path):
    """The library's name is keyed by the body, energy, D and cap, and by
    the bytes of the instance's source and of every header: an edit of
    either names another library; the same key names the same one."""
    keys = [(0, 1, 16, 8), (1, 1, 16, 8), (0, 2, 16, 8), (0, 1, 17, 8), (0, 1, 16, 9)]
    names = {_build.instance_path(_build.ew_instance(*k)).name for k in keys}
    assert len(names) == len(keys)
    assert (_build.instance_path(_build.ew_instance(*keys[0]))
            == _build.instance_path(_build.ew_instance(*keys[0])))
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "EW_SOURCE", csrc / "ondemand" / "ew_instance.cu")
    seen = {_build.instance_path(_build.ew_instance(*keys[0])).name}
    for edited in (csrc / "ondemand" / "ew_instance.cu", csrc / "mjhmc_engine.cuh",
                   csrc / "philox.cuh"):
        edited.write_text(edited.read_text() + "\n// edited\n")
        name = _build.instance_path(_build.ew_instance(*keys[0])).name
        assert name not in seen
        seen.add(name)


def _fake_compiler(tmp_path, body):
    path = tmp_path / "fake_nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_failed_build_or_load_raises(monkeypatch, tmp_path):
    """A compiler that fails makes ``load_instance`` raise ``RuntimeError``
    with its report, leaving no library and the report in the ``.log``; one
    that writes no loadable library makes the load raise ``RuntimeError``.
    Nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_compiler(
        tmp_path, "echo 'ptxas fatal: no card here' >&2\nexit 3\n"))
    _build.load_instance.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="(?s)exit code 3.*no card here"):
            _build.load_instance(_build.ew_instance(0, 1, 16, 8))
        path = _build.instance_path(_build.ew_instance(0, 1, 16, 8))
        assert not path.exists() and "no card here" in _build.instance_log(
            _build.ew_instance(0, 1, 16, 8))
        assert [p.name for p in path.parent.iterdir()] == [path.with_suffix(".log").name]
        monkeypatch.setattr(_build, "_nvcc", lambda: _fake_compiler(
            tmp_path, 'while [ $# -gt 0 ]; do [ "$1" = -o ] && echo junk > "$2"; shift; '
                      'done\n'))
        with pytest.raises(RuntimeError, match="loading the on-demand instance"):
            _build.load_instance(_build.ew_instance(0, 1, 16, 8))
    finally:
        _build.load_instance.cache_clear()


def test_check_kernel_dims_refuses_only_what_jax_refuses():
    """Any D of every elementwise energy and any number of mixture
    components pass; a state of other dims than the spec's, or none, is
    refused."""
    for dist, _, _ in chip_smoke.any_d_dists().values():
        cm.check_kernel_dims(cm.energy_spec_for(dist), dist.ndims)
    for dist in (tmodels.Funnel(ndims=37), tmodels.Banana(ndims=3), tmodels.RoughWell(ndims=7),
                 tmodels.EightSchools(y=(1.0,) * 3, sigma=(1.0,) * 3), _many_components()):
        cm.check_kernel_dims(cm.energy_spec_for(dist), dist.ndims)
    with pytest.raises(ValueError, match="built for 8 dims"):
        cm.check_kernel_dims(cm.energy_spec_for(tmodels.Gaussian(ndims=8)), 9)
    with pytest.raises(ValueError):
        cm.check_kernel_dims(cm.energy_spec_for(tmodels.RoughWell()), 0)


# ---- the plain versions against the JAX package at the gated shapes ----------
@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("label", SHAPES)
def test_plain_version_matches_interpret_kernel(label, body):
    """Every body at every any-D shape, run and stream, against the JAX
    kernels in interpret mode at 1,024 chains (NUTS at max_depth 5, 3
    iterations; the others the shape's ε and M, 5)."""
    jd, td, eps, m = _pair(label)
    nuts = body == "nuts"
    out = _compare(jd, td, body, 3 if nuts else 5, NUTS_DEPTH if nuts else m, eps, {}, seed=3)
    assert int(out.evals.min()) >= (3 if nuts else 5 * m)


@pytest.mark.parametrize("label,body,integrator,mass", [
    ("gaussian d16", "mjhmc", "leapfrog", True),
    ("gaussian d8", "mjhmc", "two_stage", False),
    ("funnel d8", "control", "two_stage", True),
    ("banana d10", "malt", "leapfrog", True),
    ("gaussian d8", "nuts", "leapfrog", True),
    ("mog d2 k10", "control", "leapfrog", True),
])
def test_branches_match_interpret_kernel(label, body, integrator, mass):
    """A diagonal inverse mass (0.5 to 1.5 over the dims) and the two-stage
    integrator at the any-D shapes."""
    jd, td, eps, m = _pair(label)
    br = dict(integrator=integrator)
    if mass:
        br["inv_mass"] = np.linspace(0.5, 1.5, jd.ndims).astype(np.float32)
    nuts = body == "nuts"
    _compare(jd, td, body, 3 if nuts else 5, NUTS_DEPTH if nuts else m, eps, br, seed=5)


# ---- the lane, tile and scratch mirrors ---------------------------------------
#: lanes a chain of (MJHMC, control, MALT) at every preset D: unchanged
PRESET_LANES = {("RoughWellSpec", 2): (1, 1, 2), ("GaussianSpec", 2): (1, 1, 2),
                ("RoughWellSpec", 50): (8, 8, 8), ("GaussianSpec", 50): (8, 8, 8),
                ("FunnelSpec", 10): (2, 8, 4), ("EightSchoolsSpec", 10): (2, 8, 4),
                ("BananaSpec", 2): (1, 1, 1), ("MogSpec", 1): (1, 1, 1)}


def _tested():
    """(spec, D) of every preset and any-D shape."""
    out = {}
    dists = [tmodels.RoughWell(), tmodels.RoughWell(ndims=50), tmodels.Gaussian(),
             tmodels.Gaussian(ndims=50), tmodels.Funnel(), tmodels.Banana(),
             tmodels.GaussianMixture(), tmodels.EightSchools()]
    dists += [d for d, _, _ in chip_smoke.any_d_dists().values()]
    for dist in dists:
        spec = cm.energy_spec_for(dist)
        out[(type(spec), dist.ndims)] = spec
    assert set(out) == set(chip_smoke.tested_dims(cm))
    return out


def test_lane_rule_at_every_tested_dim():
    """Every preset keeps its lanes; at the any-D shapes a separable
    chain's dims go to the fewest lanes holding at most 7 each (MALT 2 at
    least), the funnel's MALT dims likewise with 4 lanes at least from D 10,
    the banana's and the mixture's MALT on one lane, a coupled energy's
    MJHMC on 2 lanes and control's whole mode on 8 from D 10; every group
    divides a warp, and the threads a block a multiple of it."""
    for (cls, d), spec in _tested().items():
        lanes = tuple(cm.ew_lanes(b, spec, d) for b in ("mjhmc", "control", "malt"))
        assert all(32 % g == 0 for g in lanes)
        for g in lanes:
            for n in (1024, 4096, 10_240):
                t = cm.ew_threads(g, n, 132)
                assert t % g == 0 and t <= max(cm.EW_THREADS, g)
        key = (cls.__name__, d)
        if key in PRESET_LANES:
            assert lanes == PRESET_LANES[key], key
            continue
        separable = cls in (cm.RoughWellSpec, cm.GaussianSpec)
        if separable:
            k = cm.lanes_for(d, cm.LANE_DIMS)
            assert -(-d // k) <= cm.LANE_DIMS and (k == 1 or -(-d // (k // 2)) > cm.LANE_DIMS)
            assert lanes == (k, k, max(k, 2 if d >= 2 else 1)), key
        else:
            assert lanes[:2] == ((2, 8) if d >= 10 else (1, 1)), key
            grouped = cls in (cm.FunnelSpec, cm.EightSchoolsSpec)
            assert lanes[2] == (max(4, cm.lanes_for(d, 7)) if grouped and d >= 10 else 1), key
    assert {d: cm.ew_lanes("mjhmc", cm.GaussianSpec((1.0,) * d), d)
            for d in (3, 4, 8, 16, 49, 128)} == {3: 1, 4: 1, 8: 2, 16: 4, 49: 8, 128: 32}
    # the funnel shapes that reach the control whole mode's own uniform
    # block (D 12: 6 pairs, an even count, on 8 lanes) and MALT on 8 lanes
    f12, f30 = (cm.energy_spec_for(tmodels.Funnel(ndims=d)) for d in (12, 30))
    assert cm.ew_lanes("control", f12, 12) == 8 and (12 + 1) // 2 % 2 == 0
    assert cm.ew_lanes("malt", f30, 30) == 8 and cm.ew_lanes("malt", f12, 12) == 4


@pytest.mark.parametrize("depth", [1, 8, 12])
def test_nuts_tiles_and_scratch_at_every_tested_dim(depth):
    """NUTS at every tested D: tree rows in shared memory up to 10 dims
    (one warp of them under a block's 227 KB at max_depth 12), in a (rows,
    d, n) device scratch past that, one warp a block there."""
    for (_, d), _ in _tested().items():
        t = cm.nuts_threads(d, 4096, 132)
        scratch = cm.nuts_tree_scratch(d, depth, 64, "meta")
        if d <= cm.NUTS_ON_CHIP_DIMS:
            assert cm.nuts_smem_bytes(d, 32, depth) == cm.nuts_tree_rows(depth) * d * 128
            assert cm.nuts_smem_bytes(d, 32, depth) < 232448 and scratch is None
            assert t == 8
        else:
            assert t == cm.NUTS_THREADS and cm.nuts_smem_bytes(d, t, depth) == 0
            assert scratch.shape == (cm.nuts_tree_rows(depth), d, 64)


# ---- the entry points on the CPU at any D --------------------------------------
@pytest.mark.parametrize("ecls,beta,kw", [
    (cm.CudaMJHMC, 0.1, {}), (cm.CudaControlHMC, 0.25, {}), (cm.CudaMALT, 1.5, {}),
    (cm.CudaNUTS, 0.0, dict(num_leapfrog_steps=5)),
    (cm.CudaMJHMC, 0.1, dict(integrator="two_stage", inv_mass=tuple(np.linspace(0.5, 1, 8)))),
])
def test_engines_take_any_dims_on_the_cpu(ecls, beta, kw):
    """The engines at D 8 (a Gaussian and the funnel), a 9-component
    mixture and the 10-component mixture at D 2: the plain version on the
    CPU runs and streams, with exact counters, from the contiguous (d, n)
    state the kernels take (a mixture's draws at D 2 come transposed); the
    card is their default device."""
    assert ecls.__dataclass_fields__["device"].default == "cuda"
    for dist in (tmodels.Gaussian(ndims=8), tmodels.Funnel(ndims=8), _many_components(),
                 chip_smoke.any_d_dists()["mog d2 k10"][0]):
        if "inv_mass" in kw and dist.ndims != 8:
            continue
        eng = ecls(dist, epsilon=0.1, beta=beta, nbatch=64, seed=1, device="cpu", **kw)
        assert all(t.is_contiguous() for t in (eng.x, eng.v, eng.g, eng.u))
        out = eng.run(3)
        xs, ws, es = eng.sample(2, return_evals=True)
        assert xs.shape == (2, dist.ndims, 64) and bool(torch.isfinite(out.u).all())
        assert torch.equal(es[-1], eng.last_out.evals)
        if ecls in (cm.CudaControlHMC, cm.CudaMALT):
            assert bool((out.evals == 3 * eng.num_leapfrog_steps).all())


def test_autocorrelation_and_sharded_run_take_any_dims():
    """``calculate_autocorrelation(Gaussian(16), engine="cuda")`` and
    ``sharded_cuda_mjhmc_run`` at D 16 on the CPU (their plain versions)."""
    from mjhmc_tpu_torch.experiments.autocorr_experiment import calculate_autocorrelation

    class RankOne:  # a chain mesh's rank 1, as the sharded run reads it
        def axis_index(self, name):
            return 1

    res = calculate_autocorrelation(tmodels.Gaussian(ndims=16), num_steps=40, nbatch=32,
                                    nlags=5, burn_steps=5, engine="cuda", device="cpu",
                                    epsilon=0.3)
    assert np.isfinite(res.rho).all() and res.total_grad_evals > 0
    dist = tmodels.Gaussian(ndims=16)
    spec = cm.energy_spec_for(dist)
    x = dist.init_x(torch.Generator().manual_seed(0), 32)
    u, g = dist.potential_and_grad(x)
    z = torch.zeros(32)
    out = cm.sharded_cuda_mjhmc_run(RankOne(), spec, x, torch.zeros_like(x), g, u, z, z, 3, 0.2,
                                    0.1, 2, 5)
    ref = cm.cuda_mjhmc_run(spec, x, torch.zeros_like(x), g, u, z, z,
                            cm.rank_seed(3, 1), 0.2, 0.1, 2, 5)
    assert torch.equal(out.x, ref.x) and torch.equal(out.evals, ref.evals)
