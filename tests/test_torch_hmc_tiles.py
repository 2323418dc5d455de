"""The elementwise MJHMC and MALT kernels' launch rule and MALT's draws.

The kernels (``csrc/mjhmc_engine.cuh``) spread a chain over a group of
lanes and size their blocks to the chain count; ``ew_lanes`` and
``ew_threads`` mirror that rule, and ``chip_smoke.py`` phase 2 holds the
mirror to the built library on the card. Here the mirror is checked at the
presets' dims and chain counts on a card of 132 SMs.

MALT's elementwise kernel draws both Box-Muller branches of a pair of
uniforms (tag 7, ``csrc/philox.cuh``). The plain version's draws
(``malt_pair_draws``) are pinned word for word against a NumPy Philox4x32-10
in that layout, and its fixed-uniform normals (and so the JAX interpret
kernel's, which ``test_torch_malt.py`` holds) against the cosine-branch
constant ``_box_muller(FIXED_UNIFORM)``.
"""

import math

import numpy as np
import pytest
import torch

from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

SMS = 132  # an H100 SXM


@pytest.mark.parametrize("config,n,lanes,threads", [
    # (config, chains) -> ({body: lanes a chain}, {body: threads a block})
    ("rough_well", 10_000, dict(mjhmc=1, malt=2), dict(mjhmc=32, malt=64)),
    ("rough_well", 102_400, dict(mjhmc=1, malt=2), dict(mjhmc=64, malt=64)),
    ("gauss2d", 10_240, dict(mjhmc=1, malt=2), dict(mjhmc=32, malt=64)),
    ("gauss50d", 4096, dict(mjhmc=8, malt=8), dict(mjhmc=64, malt=64)),
    ("funnel", 1024, dict(mjhmc=2, malt=4), dict(mjhmc=4, malt=8)),
    ("eight_schools", 1024, dict(mjhmc=2, malt=4), dict(mjhmc=4, malt=8)),
    ("banana", 2048, dict(mjhmc=1, malt=1), dict(mjhmc=4, malt=4)),
    ("mog", 1024, dict(mjhmc=1, malt=1), dict(mjhmc=2, malt=2)),
])
def test_ew_lanes_and_threads_at_the_presets(config, n, lanes, threads):
    """Lanes a chain: 8 at D 50, 4 at D 10, MALT's separable energies 2 at
    D 2, else one; threads a block: the fewest (a power of two, a multiple
    of the group, at most 64) that keep the blocks within the SMs'
    sub-partitions, so that the zoo's 1,024-2,048 chains reach every SM."""
    dist = BENCHMARK_CONFIGS[config].make_distribution()
    spec, d = cm.energy_spec_for(dist), dist.ndims
    for body in ("mjhmc", "malt"):
        g = cm.ew_lanes(body, spec, d)
        t = cm.ew_threads(g, n, SMS)
        assert (g, t) == (lanes[body], threads[body]), body
        assert t % g == 0 and t & (t - 1) == 0 and t <= cm.EW_THREADS
        blocks = -(-n * g // t)
        assert blocks <= cm.SM_SUBPARTITIONS * SMS or t == cm.EW_THREADS
        assert t == g or -(-n * g // (t // 2)) > cm.SM_SUBPARTITIONS * SMS


def test_ew_lanes_of_every_kernel_dim():
    """Every (energy, D) the kernel has: the group divides a warp; MALT's
    lanes own at most 7 dims (D 50 over 8 lanes), 3 at D 10; MJHMC's
    coupled energies take a trajectory a lane at D 10, its separable ones
    one lane a chain below D 50."""
    cases = [tmodels.RoughWell(ndims=2), tmodels.Gaussian(ndims=2), tmodels.Funnel(ndims=10),
             tmodels.Banana(), BENCHMARK_CONFIGS["mog"].make_distribution(),
             tmodels.EightSchools(), tmodels.EightSchools(parameterization="noncentered")]
    for dist in cases:
        spec = cm.energy_spec_for(dist)
        for d in cm.KERNEL_DIMS[type(spec)]:
            for body in ("mjhmc", "malt"):
                g = cm.ew_lanes(body, spec, d)
                assert 32 % g == 0
                if body == "mjhmc" and d == 10:
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


@pytest.mark.parametrize("body,enum", [("mjhmc", "MjhmcPhase"), ("malt", "MaltPhase")])
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
    assert names[-1] in ("kMjPhases", "kMaPhases")
    phases = cm.EW_PROF_PHASES[body]
    assert len(phases) == len(names) - 1
    assert phases.index("other") == names.index("kMjOther" if body == "mjhmc" else "kMaOther")
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
