"""The elementwise NUTS kernel's launch geometry and depth cap on the CPU.

The kernel runs one leaf per step of its loop, each lane at its own
position, a warp's lanes opening each round together, in blocks sized to
the chains, and keeps its tree rows (the sample, the proposal, the
endpoints, v0, the Kahan pairs and the U-turn stack) in shared memory up
to 10 dims, else in a scratch buffer in device memory. The wrappers mirror
its tile (``nuts_threads``, ``nuts_smem_bytes``, ``nuts_tree_scratch``);
phase 2 of ``chip_smoke.py`` holds the mirror to the library's own report
on the card. Here: the mirror's rules, the depth caps of both NUTS
kernels, the leaf-slot shares ``chip_smoke.py`` prints
(``leaf_slot_share`` for lanes in step round by round, ``lane_leaf_share``
for lanes that would run on at once), its count of the rounds trees began
and its check that deep trees entered their last round, and
``bench_mm_ab``'s breakdown of a PROF record, on synthetic counts; and the
plain version against the JAX kernel in Pallas interpret mode at max_depth
11, deeper than the matmul kernel's cap, with trees that reach round 11
(the arguments of ``test_nuts_run_matches_interpret_kernel`` at ε 0.003, 2
steps). Interpret mode returns zero PRNG bits, so every uniform is 2⁻²⁵
(``fixed_uniform=True``). Leaf counts must be exact, x, v, g, u within rtol
1e-5 (atol 1e-5 of the field's largest value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from mjhmc_tpu import models as jmodels
from mjhmc_tpu.ops.pallas_mjhmc import energy_spec_for, pallas_mjhmc_run
from mjhmc_tpu_torch import bench_mm_ab
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

#: the shared memory an H100's SM has and a block may take, and the 1 KB
#: it reserves for each resident block
SMEM_SM, SMEM_BLOCK, SMEM_RESERVED = 233472, 232448, 1024
#: every elementwise NUTS instance held: (spec, dims), the library's and the
#: on-demand instances' at the any-D shapes (the list chip_smoke.py holds)
INSTANCES = chip_smoke.tested_dims(cm)
#: the H100's SMs, and the presets' chains (mjhmc_tpu_torch/config.py; the
#: rough well's NUTS checks run 4,096)
SMS, PRESET_CHAINS = 132, (1024, 2048, 4096, 10_240, 102_400)


@pytest.mark.parametrize("spec,d", INSTANCES, ids=[f"{s.__name__}-{d}" for s, d in INSTANCES])
def test_tree_rows_fit_shared_memory_or_scratch(spec, d):
    """Up to 10 dims the tree rows of a one-warp block stay under a block's
    227 KB at every depth up to the cap (31: 96,000 bytes at D 10), four
    blocks fit an SM up to max_depth 12, the bytes grow with the depth, and
    no scratch is allocated; past 10 dims (16, 50, 128) they take no shared
    memory and a (rows, d, n) scratch buffer in device memory instead."""
    assert cm.NUTS_THREADS == 32
    rows = [cm.nuts_tree_rows(depth) for depth in range(1, cm.NUTS_MAX_DEPTH + 1)]
    assert rows[0] == 15 and all(b - a == 2 for a, b in zip(rows, rows[1:]))
    assert rows[-1] == 75 and cm.NUTS_MAX_DEPTH == 31
    for depth in range(1, cm.NUTS_MAX_DEPTH + 1):
        full = cm.nuts_smem_bytes(d, cm.NUTS_THREADS, depth)
        scratch = cm.nuts_tree_scratch(d, depth, 100, "meta")
        if d <= cm.NUTS_ON_CHIP_DIMS:
            assert full == cm.nuts_tree_rows(depth) * d * cm.NUTS_THREADS * 4 < SMEM_BLOCK
            assert depth > 12 or 4 * (full + SMEM_RESERVED) <= SMEM_SM
            assert cm.nuts_smem_bytes(d, 1, depth) * cm.NUTS_THREADS == full
            assert scratch is None
        else:
            assert full == 0
            assert scratch.shape == (cm.nuts_tree_rows(depth), d, 100)
            assert scratch.dtype == torch.float32
    if d <= cm.NUTS_ON_CHIP_DIMS:
        assert cm.nuts_smem_bytes(d, 32, 1) < cm.nuts_smem_bytes(d, 32, 8) < cm.nuts_smem_bytes(
            d, 32, cm.NUTS_MAX_DEPTH)


@pytest.mark.parametrize("n", PRESET_CHAINS)
def test_blocks_follow_the_schedule(n):
    """Up to 10 dims (tree rows on chip) an instance runs the fewest
    threads a block, a power of two up to one warp, that put at most one
    block on each SM sub-partition (so the presets' 1,024 chains take
    2-thread blocks on every SM, and 10,240 one warp), and more chains, or
    fewer SMs, never take fewer threads; past 10 dims (rows in the device
    scratch) one warp, whatever the chains."""
    for d in sorted({d for _, d in INSTANCES}):
        t = cm.nuts_threads(d, n, SMS)
        if d > cm.NUTS_ON_CHIP_DIMS:
            assert t == cm.NUTS_THREADS
            continue
        assert 1 <= t <= cm.NUTS_THREADS and t & (t - 1) == 0
        assert -(-n // t) <= cm.SM_SUBPARTITIONS * SMS or t == cm.NUTS_THREADS
        assert t == 1 or -(-n // (t // 2)) > cm.SM_SUBPARTITIONS * SMS
        assert cm.nuts_threads(d, 2 * n, SMS) >= t >= cm.nuts_threads(d, n, 2 * SMS)
        assert t == {1024: 2, 2048: 4, 4096: 8, 10_240: 32, 102_400: 32}[n]


def test_depth_caps_per_kernel():
    """Both kernels take trees to max_depth 31 (2^31 − 1 leaves, whose
    counts fit an int32) and refuse 32, each with its own message naming the
    int32 edge."""
    assert (cm.NUTS_MAX_DEPTH, cm.NUTS_MM_MAX_DEPTH) == (31, 31)
    g = tmodels.Gaussian(ndims=2, log_conditioning=1.0)
    spec = cm.energy_spec_for(g)
    x = torch.zeros((2, 64), device="meta")
    z = torch.zeros(64, device="meta")
    st = (x, x, x, z, z, z)
    for depth in (11, 12, 13, 31):  # past the cap check, then refused for the device
        with pytest.raises(ValueError, match="cuda tensors"):
            cm.cuda_mjhmc_run(spec, *st, 5, 0.1, 0.0, 2, depth, variant="nuts")
        with pytest.raises(ValueError, match="cuda tensors"):
            cm.cuda_mjhmc_stream_run(spec, *st, 5, 0.1, 0.0, 2, 1, depth, variant="nuts")
    edge = r"max_depth 1..31 \(2\^max_depth − 1 leaves fit an int32\), not 32"
    with pytest.raises(NotImplementedError, match="elementwise NUTS kernel .* " + edge):
        cm.cuda_mjhmc_run(spec, *st, 5, 0.1, 0.0, 2, 32, variant="nuts")
    with pytest.raises(NotImplementedError, match=edge):
        cm.cuda_mjhmc_stream_run(spec, *st, 5, 0.1, 0.0, 2, 1, 32, variant="nuts")
    with pytest.raises(NotImplementedError, match="max_depth 1..31"):
        cm.cuda_mjhmc_stream_run(spec, *st, 5, 0.1, 0.0, 2, 1, 0, variant="nuts")
    for mspec in (cm.energy_spec_for(tmodels.ProductOfT()),
                  cm.energy_spec_for(tmodels.SparseCoding())):
        xm = torch.zeros((mspec.dist.ndims, 64), device="meta")
        for depth in (11, 12, 13, 31):
            with pytest.raises(ValueError, match="cuda tensors"):
                cm.cuda_mjhmc_mm_run(mspec, xm, xm, xm, z, z, z, 5, 0.12, 0.0, 2, depth,
                                     variant="nuts")
            with pytest.raises(ValueError, match="cuda tensors"):
                cm.cuda_mjhmc_mm_stream_run(mspec, xm, xm, xm, z, z, z, 5, 0.12, 0.0, 2, 1,
                                            depth, variant="nuts")
        with pytest.raises(NotImplementedError, match="matmul NUTS kernel .* " + edge):
            cm.cuda_mjhmc_mm_run(mspec, xm, xm, xm, z, z, z, 5, 0.12, 0.0, 2, 32, variant="nuts")
        with pytest.raises(NotImplementedError, match=edge):
            cm.cuda_mjhmc_mm_stream_run(mspec, xm, xm, xm, z, z, z, 5, 0.12, 0.0, 2, 1, 32,
                                        variant="nuts")


def _es(rng, iters, n, depth):
    """A synthetic NUTS stream's cumulative leaf counts: every chain's tree
    grows a random number of rounds, the last of them cut short at random."""
    rounds = rng.integers(1, depth + 1, size=(iters, n))
    cut = rng.integers(1, 2 ** (rounds - 1) + 1)
    nl = 2 ** (rounds - 1) - 1 + cut
    return torch.as_tensor(np.cumsum(nl, axis=0), dtype=torch.int32)


def test_lane_leaf_share_counts_each_warps_longest_lane():
    """The share lanes that ran on at once would keep: a warp runs its
    longest lane's leaves,
    every lane each step, the last warp only its live lanes; it is never
    below the share of round-synchronous warps of the same lanes (a sum of
    the rounds' maxima is no less than the largest lane's sum), and equal to
    it where every lane builds the same trees."""
    leaves = torch.tensor([1, 2, 3, 4, 5])
    assert chip_smoke.lane_leaf_share(leaves, 2) == pytest.approx(15 / (2 * 2 + 4 * 2 + 5))
    assert chip_smoke.lane_leaf_share(torch.full((64,), 7), 32) == 1.0
    rng = np.random.default_rng(0)
    for lanes in (1, 8, 32):
        es = _es(rng, 20, 96, 6)
        per_lane = chip_smoke.lane_leaf_share(es[-1], lanes)
        assert chip_smoke.leaf_slot_share(es, 6, lanes) <= per_lane + 1e-12 <= 1 + 1e-12
        assert (per_lane == 1.0) == (lanes == 1)
    same = torch.tensor(np.cumsum(np.full((5, 64), 11), axis=0), dtype=torch.int32)
    assert chip_smoke.leaf_slot_share(same, 4, 32) == chip_smoke.lane_leaf_share(same[-1], 32) == 1


def test_rounds_begun_and_the_last_round_check():
    """A tree of nl leaves in an iteration began floor(log2 nl) + 1 rounds
    (one leaf: round 1; 2^(r−1) up to 2^r − 1: round r), read from a
    stream's cumulative counts; the deep-tree check passes where enough
    trees began the last round and fails where none did or too few."""
    es = torch.tensor([[1, 2, 3, 4], [8, 9, 10, 11], [2056, 2057, 2058, 2059]],
                      dtype=torch.int32)
    assert chip_smoke.rounds_begun(es).tolist() == [[1, 2, 2, 3], [3, 3, 3, 3], [12, 12, 12, 12]]
    assert chip_smoke.check_last_round("x", chip_smoke.rounds_begun(es), 12) == 4 / 12
    rng = np.random.default_rng(1)
    full = _es(rng, 4, 64, 12)
    assert int(chip_smoke.rounds_begun(full).max()) <= 12
    with pytest.raises(AssertionError, match="round 12"):
        chip_smoke.check_last_round("x", chip_smoke.rounds_begun(es[:2]), 12)
    with pytest.raises(AssertionError, match="round 3"):
        chip_smoke.check_last_round("x", chip_smoke.rounds_begun(es[:1]), 3, least=0.5)


def test_ew_breakdown_of_a_prof_record():
    """``bench_mm_ab.ew_breakdown`` turns a PROF record (each chain's cycles
    by phase, its leaves and its warp's leaf slots) into the phases' shares
    and cycles a leaf, the measured share of live slots and the share lanes
    that ran on at once would keep."""
    names = cm.NUTS_EW_PROF_PHASES
    rec = torch.zeros((3, len(names)), dtype=torch.int64)
    rec[:, names.index("kick_drift_gradient")] = torch.tensor([100, 200, 300])
    rec[:, names.index("idle")] = torch.tensor([300, 200, 100])
    rec[:, names.index("leaves")] = torch.tensor([2, 4, 6])
    rec[0, names.index("leaf_slots")] = 16  # lanes 0-1 ran 8 steps, lane 2 its 6 alone
    rec[2, names.index("leaf_slots")] = 6
    out = bench_mm_ab.ew_breakdown(rec, names, 2)
    assert out["chains"] == 3 and out["leaves_per_chain"] == 4
    assert out["cycles_per_leaf"] == 1200 / 12
    assert out["share"]["kick_drift_gradient"] == 0.5 and out["share"]["idle"] == 0.5
    assert out["cycles_per_leaf_by_phase"]["idle"] == 50
    assert out["leaf_slot_share"] == 12 / 22
    assert out["lane_schedule_share"] == 12 / (4 * 2 + 6)
    assert out["chain_cycles_max"] == out["chain_cycles_mean"] == 400


N, S = 1024, 8
L = N // S


def test_plain_version_matches_interpret_kernel_at_max_depth_11():
    """Gaussian(2, 1.0) at ε 0.003: every tree completes ten rounds (1,023
    leaves) and most go on into round 11; leaf counts exact, states within
    rtol 1e-5."""
    kw = dict(ndims=2, log_conditioning=1.0)
    jd, td = jmodels.Gaussian(**kw), tmodels.Gaussian(**kw)
    x = np.array(jd.init_x(jax.random.key(0), N))
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = np.zeros(N, np.float32)
    ts = tuple(torch.as_tensor(a) for a in (x, np.zeros_like(x), g, u, z, z.copy()))
    d, eps, steps, depth = jd.ndims, 0.003, 2, 11
    js = (jnp.asarray(x).reshape(d, S, L), jnp.zeros((d, S, L)), jnp.asarray(g).reshape(d, S, L),
          jnp.asarray(u).reshape(S, L), jnp.zeros((S, L)), jnp.zeros((S, L)))
    out_j = pallas_mjhmc_run(energy_spec_for(jd), *js, jnp.int32(7), jnp.float32(eps),
                             jnp.float32(0.0), steps, depth, interpret=pltpu.InterpretParams(),
                             variant="nuts")
    out_t = cm.run_reference(cm.energy_spec_for(td), *ts, 7, eps, 0.0, steps, depth,
                             fixed_uniform=True, variant="nuts")
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel())
    per_iter = out_t.evals.double() / steps
    assert float(per_iter.min()) >= 2**10 - 1 and float((per_iter >= 2**10).double().mean()) > 0.5
    assert int(out_t.evals.max()) <= steps * (2**depth - 1)
    for f in ("x", "v", "grad", "u"):
        b = np.asarray(getattr(out_j, f), np.float64).reshape(getattr(out_t, f).shape)
        np.testing.assert_allclose(getattr(out_t, f).double().numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=f)
