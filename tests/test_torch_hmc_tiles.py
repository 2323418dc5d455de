"""The elementwise MJHMC, control and MALT kernels' launch rule and the
control and MALT draws.

The kernels (``csrc/mjhmc_engine.cuh``) spread a chain over a group of
lanes and size their blocks to the chain count; ``ew_lanes`` and
``ew_threads`` mirror that rule, and ``chip_smoke.py`` phase 2 holds the
mirror to the built library on the card (phase 42 to the on-demand
instances). Here the mirror is checked at the presets' dims and chain
counts and at the any-D shapes' dims (``chip_smoke.tested_dims``) on a card
of 132 SMs.

MALT's and control's elementwise kernels draw both Box-Muller branches of a
pair of uniforms (tags 7 and 8, ``csrc/philox.cuh``). The plain versions'
draws (``malt_pair_draws``, ``control_pair_draws``) are pinned word for word
against a NumPy Philox4x32-10 in those layouts, control's also against the
kernel's per-lane word selection at every lane count (a pair may straddle
two lanes' dims), and their fixed-uniform normals (and so the JAX interpret
kernel's, which ``test_torch_malt.py`` and ``test_torch_control.py`` hold)
against the cosine-branch constant ``_box_muller(FIXED_UNIFORM)``.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

SMS = 132  # an H100 SXM


@pytest.mark.parametrize("config,n,lanes,threads", [
    # (config, chains) -> ({body: lanes a chain}, {body: threads a block})
    ("rough_well", 10_000, dict(mjhmc=1, malt=2, control=1),
     dict(mjhmc=32, malt=64, control=32)),
    ("rough_well", 102_400, dict(mjhmc=1, malt=2, control=1),
     dict(mjhmc=64, malt=64, control=64)),
    ("gauss2d", 10_240, dict(mjhmc=1, malt=2, control=1), dict(mjhmc=32, malt=64, control=32)),
    ("gauss50d", 4096, dict(mjhmc=8, malt=8, control=8), dict(mjhmc=64, malt=64, control=64)),
    ("funnel", 1024, dict(mjhmc=2, malt=4, control=8), dict(mjhmc=4, malt=8, control=16)),
    ("eight_schools", 1024, dict(mjhmc=2, malt=4, control=8),
     dict(mjhmc=4, malt=8, control=16)),
    ("banana", 2048, dict(mjhmc=1, malt=1, control=1), dict(mjhmc=4, malt=4, control=4)),
    ("mog", 1024, dict(mjhmc=1, malt=1, control=1), dict(mjhmc=2, malt=2, control=2)),
])
def test_ew_lanes_and_threads_at_the_presets(config, n, lanes, threads):
    """Lanes a chain: 8 at D 50, MJHMC's coupled energies 2, MALT 4 and
    control 8 at D 10, MALT's separable energies 2 at D 2, else one; threads
    a block: the
    fewest (a power of two, a multiple of the group, at most 64) that keep
    the blocks within the SMs' sub-partitions, so that the zoo's 1,024-2,048
    chains reach every SM."""
    dist = BENCHMARK_CONFIGS[config].make_distribution()
    spec, d = cm.energy_spec_for(dist), dist.ndims
    for body in lanes:
        g = cm.ew_lanes(body, spec, d)
        t = cm.ew_threads(g, n, SMS)
        assert (g, t) == (lanes[body], threads[body]), body
        assert t % g == 0 and t & (t - 1) == 0 and t <= cm.EW_THREADS
        blocks = -(-n * g // t)
        assert blocks <= cm.SM_SUBPARTITIONS * SMS or t == cm.EW_THREADS
        assert t == g or -(-n * g // (t // 2)) > cm.SM_SUBPARTITIONS * SMS


def test_ew_lanes_of_every_kernel_dim():
    """Every (energy, D) held (the library's and the on-demand instances'
    at the any-D shapes, chip_smoke.tested_dims): the group divides a warp;
    MALT's lanes own at most 7 dims (D 50 over 8 lanes), 3 at D 10; MJHMC's
    coupled energies take a trajectory a lane from D 10, its separable ones
    one lane a chain at D 2 and 8 lanes at D 50; control takes 8 lanes from
    D 10 on a coupled energy (each holds every dim, the draw's pairs split)
    and at D 50 (7 a lane), one at D 2; a separable chain's lanes at the
    other D hold at most 7 dims each (tests/test_torch_any_dims.py holds
    the rule there)."""
    cases = [tmodels.RoughWell(ndims=2), tmodels.Gaussian(ndims=2), tmodels.Funnel(ndims=10),
             tmodels.Banana(), BENCHMARK_CONFIGS["mog"].make_distribution(),
             tmodels.EightSchools(), tmodels.EightSchools(parameterization="noncentered")]
    specs = {type(s): s for s in map(cm.energy_spec_for, cases)}
    dists = {(type(s), d.ndims): d for d, s in
             ((d, cm.energy_spec_for(d)) for d, _, _ in chip_smoke.any_d_dists().values())}
    for spec_cls, d in chip_smoke.tested_dims(cm):
        dist = dists.get((spec_cls, d))
        spec = cm.energy_spec_for(dist) if dist is not None else specs[spec_cls]
        preset = d in cm.KERNEL_DIMS[spec_cls]
        separable = spec_cls in (cm.RoughWellSpec, cm.GaussianSpec)
        for body in ("mjhmc", "malt", "control"):
            g = cm.ew_lanes(body, spec, d)
            assert 32 % g == 0
            if not preset:
                assert not separable or -(-d // g) <= 7
            elif body == "control":
                assert g == (8 if d >= 10 else 1) and (d < 50 or -(-d // g) == 7)
            elif body == "mjhmc" and d == 10:
                assert g == 2  # the forward and the backward trajectory
            elif body == "mjhmc" and d < 50:
                assert g == 1
            else:
                assert -(-d // g) == {1: 1, 2: 1, 10: 3, 50: 7}[d] or (d, g) == (2, 1)


# ---- MALT's draws: both Box-Muller branches of a pair (tag 7) ----------------
_MASK = np.uint64(0xFFFFFFFF)


def _np_philox(counter, seed):
    """Philox4x32-10 in NumPy (uint64 arrays holding 32-bit words)."""
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) for c in counter)
    k0, k1 = np.uint64(seed & 0xFFFFFFFF), np.uint64(0)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & _MASK
            k1 = (k1 + np.uint64(0xBB67AE85)) & _MASK
        p0 = np.uint64(0xD2511F53) * c0
        p1 = np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = (p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & _MASK, \
            (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & _MASK
    return c0, c1, c2, c3


def _np_uniform(word):
    return (word >> np.uint64(8)).astype(np.float32) * np.float32(2.0**-24) + np.float32(2.0**-25)


def _expected_draws(seed, t, n, d, m):
    """(v0, O-step normals, Metropolis uniform) of the layout derived word by
    word: dim i's pair p from words 2(p % 2), 2(p % 2) + 1 of slot i·B + p // 2
    (B = ceil((m + 1) / 2)) of counter (chain, t, slot, 7); step k's O-steps
    the cosine then the sine branch of pair k, the refresh pair m's cosine,
    the Metropolis uniform word 0 of slot d·B."""
    nb = -(-(m + 1) // 2)
    chains = np.arange(n, dtype=np.uint64)

    def words(slot):
        return _np_philox((chains, np.full(n, t), np.full(n, slot), np.full(n, 7)), seed)

    def pair(i, p):
        w = words(i * nb + p // 2)
        u1, u2 = (torch.from_numpy(_np_uniform(w[2 * (p % 2) + h])) for h in (0, 1))
        rad = torch.sqrt(-2.0 * torch.log(u1))
        ang = (2.0 * math.pi) * u2
        return rad * torch.cos(ang), rad * torch.sin(ang)

    v0 = torch.stack([pair(i, m)[0] for i in range(d)])
    steps = []
    for k in range(m):
        zc, zs = zip(*(pair(i, k) for i in range(d)))
        steps += [torch.stack(zc), torch.stack(zs)]
    o = torch.stack(steps) if steps else torch.empty((0, d, n))
    return v0, o, torch.from_numpy(_np_uniform(words(d * nb)[0]))


@pytest.mark.parametrize("d,m,t", [(2, 10, 0), (2, 3, 5), (1, 10, 2), (10, 8, 1), (50, 2, 3),
                                   (2, 0, 4)])
def test_malt_pair_draws_match_numpy_philox(d, m, t):
    n, seed = 37, 0x9E3779B97
    v0, o, mh = cm.malt_pair_draws(seed, t, n, d, m, "cpu")
    ev0, eo, emh = _expected_draws(seed, t, n, d, m)
    assert torch.equal(v0, ev0)
    assert o.shape == (2 * m, d, n) and torch.equal(o, eo)
    assert torch.equal(mh, emh)


def test_malt_pair_draws_are_standard_normals():
    """Both branches of a pair are independent N(0, 1): means, variances and
    the cosine-sine correlation over 4,096 chains × 10 dims × 11 pairs."""
    v0, o, mh = cm.malt_pair_draws(11, 0, 4096, 10, 10, "cpu")
    zc, zs = o[0::2].double(), o[1::2].double()
    for z in (zc, zs, v0.double()):
        assert abs(float(z.mean())) < 0.02 and abs(float(z.var()) - 1.0) < 0.03
    assert abs(float((zc * zs).mean())) < 0.02
    assert 0.45 < float(mh.double().mean()) < 0.55


# ---- control's draws: both Box-Muller branches of a pair (tag 8) -------------
def _control_words(seed, t, n, slot):
    chains = np.arange(n, dtype=np.uint64)
    return _np_philox((chains, np.full(n, t), np.full(n, slot), np.full(n, 8)), seed)


def _np_pair(w1, w2):
    """Both Box-Muller branches of the pair of words (u1, u2)."""
    u1, u2 = (torch.from_numpy(_np_uniform(w)) for w in (w1, w2))
    rad = torch.sqrt(-2.0 * torch.log(u1))
    ang = (2.0 * math.pi) * u2
    return rad * torch.cos(ang), rad * torch.sin(ang)


def _expected_control_draws(seed, t, n, d):
    """(ξ, Metropolis uniform) of the layout derived word by word: word k is
    output k % 4 of slot k // 4 of counter (chain, t, slot, 8); dim i is
    branch i % 2 (cosine, sine) of pair i // 2, whose words are 2p and
    2p + 1; the uniform is word 2·ceil(d/2)."""
    def word(k):
        return _control_words(seed, t, n, k // 4)[k % 4]

    xi = [_np_pair(word(2 * (i // 2)), word(2 * (i // 2) + 1))[i % 2] for i in range(d)]
    return torch.stack(xi), torch.from_numpy(_np_uniform(word(2 * (-(-d // 2)))))


def _lane_draws(seed, t, n, d, lanes):
    """The kernel's word selection (``control_draw``), lane by lane: lane r
    owns dims r·K .. r·K + K − 1 (K = ceil(d / lanes)), draws the blocks
    from the slot of its first dim's pair on, takes each pair's words by
    the parity of that pair and each dim's branch by the parity of its first
    dim; the lane of dim d − 1 draws the Metropolis uniform."""
    k = -(-d // lanes)
    mh_word = 2 * ((d + 1) // 2)
    nq = k // 2 + 1
    span = (nq + 2) // 2
    xi, mh = torch.full((d, n), float("nan")), None
    for r in range(lanes):
        i0 = r * k
        p0, o = i0 // 2, i0 % 2
        s0, po = p0 // 2, p0 % 2
        w = [wd for b in range(span) for wd in _control_words(seed, t, n, s0 + b)]
        zs = [_np_pair(w[2 * q + 2 * po], w[2 * q + 1 + 2 * po]) for q in range(nq)]
        for j in range(k):
            if i0 + j < d:
                xi[i0 + j] = zs[(j + o) // 2][(j + o) % 2]
        if i0 <= d - 1 < i0 + k:
            assert mh_word % 4 and 0 <= mh_word - 4 * s0 < 4 * span
            mh = torch.from_numpy(_np_uniform(w[mh_word - 4 * s0]))
    return xi, mh


def _whole_lane_draws(seed, t, n, d, lanes):
    """The kernel's whole mode (``control_draw_whole``), lane by lane: every
    lane holds every dim, lane r draws pairs r, r + lanes, ... from their
    own blocks, a dim takes its pair's lane's branch, and the lane of the
    last pair reads the Metropolis uniform, word 2 of that pair's block."""
    pairs = (d + 1) // 2
    assert pairs % 2 == 1
    xi, mh = torch.full((d, n), float("nan")), None
    for r in range(lanes):
        for p in range(r, pairs, lanes):
            w = _control_words(seed, t, n, p // 2)
            z = _np_pair(w[2 * (p % 2)], w[2 * (p % 2) + 1])
            for i in (2 * p, 2 * p + 1):
                if i < d:
                    xi[i] = z[i % 2]
            if p == pairs - 1:
                mh = torch.from_numpy(_np_uniform(w[2]))
    return xi, mh


@pytest.mark.parametrize("d,t", [(1, 0), (2, 3), (10, 1), (50, 7)])
def test_control_pair_draws_match_numpy_philox(d, t):
    n, seed = 37, 0x9E3779B97
    xi, mh = cm.control_pair_draws(seed, t, n, d, "cpu")
    exi, emh = _expected_control_draws(seed, t, n, d)
    assert xi.shape == (d, n) and torch.equal(xi, exi)
    assert torch.equal(mh, emh)


@pytest.mark.parametrize("d,lanes,whole", [
    (50, 8, False), (50, 4, False), (50, 2, False), (10, 4, False), (10, 8, False),
    (2, 2, False), (10, 8, True), (10, 4, True), (10, 2, True), (10, 1, True), (2, 2, True),
    (2, 1, True), (1, 1, True), (1, 8, True)])
def test_control_straddling_pairs_draw_alike_at_any_lane_count(d, lanes, whole):
    """A pair whose dims two lanes own (7 dims a lane at D 50: pairs 3, 10,
    17, 24; 3 at D 10) is drawn by both, each taking its own branch, and in
    whole mode each pair by one lane for all, so the lanes' draws are the
    plain version's at any grouping."""
    n, seed = 29, 12345
    xi, mh = (_whole_lane_draws if whole else _lane_draws)(seed, 4, n, d, lanes)
    pxi, pmh = cm.control_pair_draws(seed, 4, n, d, "cpu")
    assert torch.equal(xi, pxi) and torch.equal(mh, pmh)


def test_control_pair_draws_are_standard_normals():
    """Both branches of a pair are independent N(0, 1): means, variances and
    the cosine-sine correlation over 4,096 chains × 50 dims; the Metropolis
    uniform's mean."""
    xi, mh = cm.control_pair_draws(11, 0, 4096, 50, "cpu")
    zc, zs = xi[0::2].double(), xi[1::2].double()
    for z in (zc, zs):
        assert abs(float(z.mean())) < 0.02 and abs(float(z.var()) - 1.0) < 0.03
    assert abs(float((zc * zs).mean())) < 0.02
    assert 0.45 < float(mh.double().mean()) < 0.55


@pytest.mark.parametrize("d", [2, 50])
def test_control_corruption_draws(d):
    """The plain control body's momentum after one iteration with β = 1 (ξ
    replaces v) and M = 0 (the trajectory stays, ΔH = 0 accepts) is its
    corruption draw times √M: in fixed-uniform mode the cosine-branch
    constant ``_box_muller(FIXED_UNIFORM)`` (the JAX interpret kernel's),
    in Philox mode ``control_pair_draws``."""
    spec = cm.energy_spec_for(tmodels.RoughWell(ndims=d))
    n = 64
    x = torch.linspace(-3.0, 3.0, d * n).reshape(d, n)
    u, z = spec.u_sum(x, *cm._param_tensors(spec, d, "cpu")), torch.zeros(n)
    mass = tuple(float(m) for m in torch.linspace(0.5, 2.0, d))
    sm = torch.rsqrt(torch.tensor(mass))[:, None]
    const = cm._box_muller(torch.full((2, 1), cm.FIXED_UNIFORM), 1)
    for fixed, want in ((True, const.expand(d, n)),
                        (False, cm.control_pair_draws(5, 0, n, d, "cpu")[0])):
        for im, scale in ((None, 1.0), (mass, sm)):
            out = cm.run_reference(spec, x, x * 0, x * 0, u, z, z, 5, 0.1, 1.0, 1, 0, fixed,
                                   variant="control", inv_mass=im)
            assert torch.equal(out.x, x) and bool((out.evals == 0).all())
            assert torch.equal(out.v, want * scale)


def _last_o_step_v(fixed, m, mass=None):
    """The plain MALT body's momentum after one iteration with η = 0 (γε/2 =
    5e4): every O-step replaces v by its normal (times √M), the trajectory
    does not move (ε = 1e-30), Δ = 0 accepts, so v is the last O-step's
    normal, or v0 at M = 0."""
    spec = cm.energy_spec_for(tmodels.Gaussian(ndims=2, log_conditioning=2.0))
    n = 64
    x = torch.linspace(-1.0, 1.0, 2 * n).reshape(2, n)
    u, g = spec.u_sum(x, *cm._param_tensors(spec, 2, "cpu")), x * 0
    z = torch.zeros(n)
    out = cm.run_reference(spec, x, x * 0, g, u, z, z, 5, 1e-30, 1e35, 1, m, fixed,
                           variant="malt", inv_mass=mass)
    assert torch.equal(out.x, x) and bool((out.evals == m).all())
    return out.v


@pytest.mark.parametrize("m", [0, 1, 4])
def test_malt_fixed_uniform_normals_are_the_cosine_branch_constant(m):
    """Fixed-uniform mode: every normal, refresh and both O-steps, is the
    cosine branch of u1 = u2 = 2⁻²⁵ (the JAX interpret kernel's), times √M."""
    const = cm._box_muller(torch.full((2, 1), cm.FIXED_UNIFORM), 1)
    assert torch.equal(_last_o_step_v(True, m), const.expand(2, 64))
    mass = (0.5, 2.0)
    sm = torch.rsqrt(torch.tensor(mass))[:, None]
    assert torch.equal(_last_o_step_v(True, m, mass), const * sm.expand(2, 64))


@pytest.mark.parametrize("m", [0, 3])
def test_malt_last_o_step_is_the_sine_branch(m):
    """Philox mode: the momentum after an iteration of η = 0 is the sine
    branch of pair M − 1 (the last O-step), or the refresh's cosine at M = 0."""
    v = _last_o_step_v(False, m)
    v0, o, _ = _expected_draws(5, 0, 64, 2, m)
    assert torch.equal(v, o[-1] if m else v0)


@pytest.mark.parametrize("body,enum", [("mjhmc", "MjhmcPhase"), ("malt", "MaltPhase"),
                                       ("control", "ControlPhase")])
def test_prof_phases_match_the_kernel(body, enum):
    """EW_PROF_PHASES names one column a phase or counter of the PROF
    instances' records (``ewprof`` in ``csrc/mjhmc_engine.cuh``): as many as
    the enum has before its count, "other" where the kernel's is, and
    MJHMC's two trajectories one phase, as the main path interleaves them."""
    import pathlib
    import re

    src = (pathlib.Path(cm.__file__).parents[1] / "csrc" / "mjhmc_engine.cuh").read_text()
    body_src = re.search(r"enum " + enum + r" \{([^}]*)\}", src).group(1)
    names = [nm.split("=")[0].strip() for nm in body_src.split(",") if nm.strip()]
    prefix = {"mjhmc": "kMj", "malt": "kMa", "control": "kCo"}[body]
    assert names[-1] == f"{prefix}Phases"
    phases = cm.EW_PROF_PHASES[body]
    assert len(phases) == len(names) - 1
    assert phases.index("other") == names.index(f"{prefix}Other")
    if body == "mjhmc":
        assert phases[0] == "trajectories" and names[0] == "kMjTrajectories"


def test_hold_counts_fields_and_decisions():
    """bench_mm_ab's hold diagnostic: which fields of which chains lie
    outside rtol 1e-4 (atol 1e-4 of the field's largest value), and which
    chains moved, each iteration (MJHMC emits the pre-transition x)."""
    from types import SimpleNamespace

    from mjhmc_tpu_torch import bench_mm_ab as ab

    r = SimpleNamespace(x=torch.ones(2, 3), v=torch.ones(2, 3), grad=torch.ones(2, 3),
                        u=torch.ones(3))
    k = SimpleNamespace(x=r.x.clone(), v=r.v.clone(), grad=r.grad.clone(), u=r.u.clone())
    k.x[1, 0] += 1e-3  # chain 0's x
    k.u[2] = float("nan")  # chain 2's u
    xs_r = torch.ones(4, 2, 3)
    xs_k = xs_r.clone()
    xs_k[3, 0, 1] = 2.0  # chain 1's last emission
    out = ab.outside_fields(k, r, xs_k, xs_r)
    assert {f: out[f].tolist() for f in out} == {
        "x": [True, False, False], "v": [False] * 3, "grad": [False] * 3,
        "u": [False, False, True], "xs": [False, True, False]}
    x0 = torch.zeros(1, 2)
    xs = torch.tensor([[[0.0, 1.0]], [[0.0, 1.0]], [[2.0, 1.0]]])
    assert ab.moved("malt", xs, x0, None).tolist() == [[False, True], [False, False],
                                                       [True, False]]
    assert ab.moved("mjhmc", xs, None, torch.tensor([[2.0, 3.0]])).tolist() == [
        [False, False], [True, False], [False, True]]


def test_hold_on_the_cpu_runs_the_plain_version():
    """On CPU tensors the wrappers take the plain version, so the hold
    diagnostic finds no chain outside and no decision differing; its nudge
    rows count what one ulp of x does to the plain version alone."""
    from mjhmc_tpu_torch import bench_mm_ab as ab

    res = ab.run_hold(iters=(2,), n=16, device="cpu")
    assert set(res) == {f"hold/rough_well_d50/{b}/{k}/2" for b, _, m in ab.HOLD_ROWS
                        for k in (("mass",) if m else ("plain",))}
    for rec in res.values():
        assert rec["decisions_differ"] == 0 and not any(rec["kernel"].values())
        assert set(rec["nudge"]) == {"x", "v", "grad", "u", "xs"}
