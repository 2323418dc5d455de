"""Roofline dossier of the CUDA port: each fused engine's achieved FLOP/s
against ceilings measured on the card (counterpart of the root
``bench_mfu.py``).

The ceilings come from the hand-written probes of ``ops/ceilings.py``
(``csrc/ceilings.cu``), not from a data sheet:

- ``tc``: the bf16 ``mma.sync`` chain b <- (W·b)·(1/depth), one bf16 pass
  with f32 accumulation, at depth 128 (``tc_bf16_mma_sync_flops_per_s``)
  and over the depths {36, 72, 80, 128} (``tc_depth_occupancy_flops_per_s``,
  FLOPs counted at the unpadded depth as the JAX probe counts them). This
  is the ``mma.sync`` rate, not the card's ``wgmma`` peak.
- ``fp32``: the chained FMA x <- x·a + b (``fp32_fma_flops_per_s``) and the
  chain x <- sinf(x)·a + b with precise ``sinf`` (``fp32_sinf_chain_flops_per_s``
  and ``sinf_per_s``).

Each probe is timed at two iteration counts with CUDA events, best of 3,
and the rate is (t_hi − t_lo)/(iters_hi − iters_lo); the counts are chosen
from one calibration call so that the high point lasts about 60 ms, and are
recorded. The engine rows run the fused engines at the JAX dossier's shapes
and settings and turn measured iterations/s into FLOP/s with the JAX op
counts. Every row names the ceiling of the unit its kernel uses and
``mfu`` is achieved/ceiling: the FP32 FMA ceiling for the rough well and
NUTS; the measured bf16 ``mma.sync`` ceiling for product of t and sparse
coding, which run at the presets' JAX default precisions as the JAX
dossier's rows do (product of t one bf16 pass, ``precision`` "default";
sparse coding ``[bf16x3]``, with useful FLOPs and executed FLOPs, 3×, the
passes the tensor cores run; ``mfu`` on the executed ones).

Left out against the JAX dossier: the product-of-t ``pair=off`` row (a TPU
systolic-occupancy A/B; the CUDA kernel computes both trajectory halves as
one product by construction) and the tunnel warm-up.

    python -m mjhmc_tpu_torch.bench_mfu [--steps 20000] [--json-out FILE]

Prints one JSON line per section and writes a file only with ``--json-out``.
Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np
import torch

#: the depths of the tensor-core occupancy sweep (the JAX dossier's)
TC_DEPTHS = (36, 72, 80, 128)
#: how long the high point of a two-point probe measurement should last
TARGET_S = 0.06
#: the JAX dossier's op counts per jump iteration (per NUTS leaf)
ROUGH_WELL_FLOPS = 10 * 2 * 2 * 10  # M · 2 halves · d · 10 FLOPs
ROUGH_WELL_SINS = 10 * 2 * 2  # M · 2 halves · d
PRODUCT_OF_T_MM_FLOPS = 10 * 8 * 36 * 36  # M · 2 contractions · 2dk · 2 halves
SPARSE_CODING_MM_FLOPS = 10 * 2 * (2 * 2 * 64 * 128)  # M · 2 halves · 2 · 2pb
NUTS_FLOPS_PER_LEAF = 10 * 2 + 40  # leapfrog (10·d) + tree bookkeeping
#: bf16 passes per contraction at each dot precision
PASSES = {"bf16x3": 3, "bf16x2": 2, "default": 1}
#: each row's ``ceiling`` -> the measured ceiling its ``mfu`` divides by
CEILING_KEYS = {"fp32_fma": "fp32_fma_flops_per_s", "tc_mma_sync": "tc_bf16_mma_sync_flops_per_s"}


def _events_s(fn) -> float:
    """Device seconds of ``fn()`` by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _best_s(fn, reps: int = 3) -> float:
    fn()  # warm
    return min(_events_s(fn) for _ in range(reps))


def _two_point(call, iters_lo: int, iters_hi: int, reps: int = 3) -> float:
    """Seconds per iteration from (t_hi − t_lo)/(iters_hi − iters_lo): the
    fixed cost of a launch cancels."""
    t_lo = _best_s(lambda: call(iters_lo), reps)
    t_hi = _best_s(lambda: call(iters_hi), reps)
    return (t_hi - t_lo) / (iters_hi - iters_lo)


def _iteration_counts(call, probe_iters: int) -> tuple:
    """(iters_lo, iters_hi): the high point lasts about ``TARGET_S`` by one
    calibration call at ``probe_iters``, the low point a quarter of it."""
    per_iter = _best_s(lambda: call(probe_iters), reps=1) / probe_iters
    hi = max(probe_iters, math.ceil(TARGET_S / per_iter))
    return hi // 4, hi


# --------------------------------------------------------------------------
# measured ceilings
# --------------------------------------------------------------------------
def measure_fp32_ceiling(transcendental: bool = False, rows: int = 256,
                         lanes: int = 1024) -> dict:
    """The FP32 chain x <- x·a + b (2 FLOPs per element and iteration), or
    x <- sinf(x)·a + b (one sinf and 2 FLOPs), four chains per element."""
    from mjhmc_tpu_torch.ops.ceilings import CHAINS, fma_chain

    rng = np.random.default_rng(1)
    a = torch.as_tensor(0.5 + 0.01 * rng.random((rows, lanes)), dtype=torch.float32).cuda()
    b = torch.as_tensor(0.1 * rng.random((rows, lanes)), dtype=torch.float32).cuda()

    def call(iters):
        fma_chain(a, b, iters, transcendental)

    lo, hi = _iteration_counts(call, 2_500 if transcendental else 20_000)
    s = _two_point(call, lo, hi)
    rec = {"flops_per_s": 2.0 * rows * lanes * CHAINS / s, "s_per_iter": s,
           "iters": [lo, hi], "elements": rows * lanes}
    if transcendental:
        rec["sinf_per_s"] = rows * lanes * CHAINS / s
    return rec


def measure_tc_ceiling(depth: int = 128, lanes: int | None = None) -> dict:
    """The bf16 ``mma.sync`` chain at one contraction depth; ``lanes``
    defaults to the count that fills the card with resident blocks."""
    from mjhmc_tpu_torch.ops.ceilings import tc_chain, tc_chain_lanes, tc_flops_per_iteration

    lanes = lanes or tc_chain_lanes(depth)
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.normal(size=(depth, depth)) / np.sqrt(depth),
                        dtype=torch.float32).cuda()
    b = torch.as_tensor(rng.normal(size=(depth, lanes)), dtype=torch.float32).cuda()

    def call(iters):
        tc_chain(w, b, iters)

    lo, hi = _iteration_counts(call, 200)
    s = _two_point(call, lo, hi)
    return {"flops_per_s": tc_flops_per_iteration(depth, lanes) / s, "s_per_iter": s,
            "iters": [lo, hi], "lanes": lanes, "padded_depth": -(-depth // 16) * 16}


def measure_ceilings() -> dict:
    probes = {f"tc_depth_{d}": measure_tc_ceiling(d) for d in TC_DEPTHS}
    probes["fp32_fma"] = measure_fp32_ceiling()
    probes["fp32_sinf"] = measure_fp32_ceiling(transcendental=True)
    return {
        "tc_bf16_mma_sync_flops_per_s": probes["tc_depth_128"]["flops_per_s"],
        "tc_depth_occupancy_flops_per_s": {str(d): probes[f"tc_depth_{d}"]["flops_per_s"]
                                           for d in TC_DEPTHS},
        "fp32_fma_flops_per_s": probes["fp32_fma"]["flops_per_s"],
        "fp32_sinf_chain_flops_per_s": probes["fp32_sinf"]["flops_per_s"],
        "sinf_per_s": probes["fp32_sinf"]["sinf_per_s"],
        "probes": probes,
    }


# --------------------------------------------------------------------------
# engine rows
# --------------------------------------------------------------------------
def _iterations_per_s(eng, steps: int) -> float:
    """Jump iterations × chains per second, two-point (steps vs 5·steps)."""
    eng.run(200)  # warm: build, load, first launch
    s = _two_point(eng.run, steps, 5 * steps)
    return eng.nbatch / s


def warp_leaf_utilization(eng, iters: int = 200) -> float:
    """Σ leaves / Σ (32 × the deepest tree of each warp), per iteration:
    the share of a warp's leaf slots that integrate a live chain (1 when
    every chain of a warp builds the same tree)."""
    _, _, es = eng.sample(iters, return_evals=True)
    leaves = torch.diff(es.long(), dim=0, prepend=torch.zeros_like(es[:1]).long())
    warps = leaves[:, : leaves.shape[1] // 32 * 32].reshape(iters, -1, 32)
    return float(warps.sum() / (32 * warps.max(dim=2).values.sum()))


def engine_rows(steps: int = 20_000) -> list:
    from mjhmc_tpu_torch.models import Gaussian, ProductOfT, RoughWell, SparseCoding
    from mjhmc_tpu_torch.ops.cuda_mjhmc import CudaMJHMC, CudaNUTS

    rows = []
    m = 10

    # rough well (elementwise kernel): per executed step and dim 10 FLOPs
    # and one sinf, both trajectory halves
    eng = CudaMJHMC(RoughWell(ndims=2), epsilon=1.0, beta=0.1, num_leapfrog_steps=m,
                    nbatch=102_400, seed=0)
    ips = _iterations_per_s(eng, steps)
    rows.append(dict(
        engine="mjhmc_roughwell_elementwise",
        iterations_per_s=ips,
        credited_leapfrog_steps_per_s=ips * m,
        flops_per_iteration=ROUGH_WELL_FLOPS,
        transcendentals_per_iteration=ROUGH_WELL_SINS,
        achieved_flops_per_s=ips * ROUGH_WELL_FLOPS,
        achieved_transcendentals_per_s=ips * ROUGH_WELL_SINS,
        ceiling="fp32_fma",
        op_count_source="pallas_mjhmc.py::_make_step leapfrog_pair + RoughWellSpec.du",
    ))

    # product of t (matmul kernel, the preset's one bf16 pass on the tensor
    # cores): full, and the stub_dots ablation whose wall is the kernel's
    # non-matmul floor (no contraction, so no precision)
    dist = ProductOfT(ndims=36, nbasis=36)
    pot_ips = {}
    for stub in (False, True):
        eng = CudaMJHMC(dist, epsilon=0.12, beta=0.1, num_leapfrog_steps=m,
                        nbatch=4096, seed=0)
        eng.spec = dataclasses.replace(eng.spec, stub_dots=stub)
        ips = _iterations_per_s(eng, steps)
        mm_flops = 0 if stub else PRODUCT_OF_T_MM_FLOPS * PASSES[eng.spec.precision]
        tag = "dots=stubbed" if stub else "full"
        pot_ips[tag] = ips
        rows.append(dict(
            engine=f"mjhmc_product_of_t[{tag}]",
            **({} if stub else {"precision": eng.spec.precision}),
            iterations_per_s=ips,
            credited_leapfrog_steps_per_s=ips * m,
            matmul_flops_per_iteration=mm_flops,
            achieved_matmul_flops_per_s=ips * mm_flops,
            ceiling="fp32_fma (ablation floor)" if stub else "tc_mma_sync",
            op_count_source="ProductOfTSpec.du: 2 contractions × 2dk × 2 halves × M"
            if not stub else
            "stub_dots: 1e-3·row 0 broadcast, no multiply-adds",
        ))
    rows.append(dict(
        engine="mjhmc_product_of_t[ablation_verdict]",
        nonmatmul_floor_fraction_of_full_wall=pot_ips["full"] / pot_ips["dots=stubbed"],
        interpretation=(
            "stubbed-iterations/s ÷ full-iterations/s; a fraction near 1 "
            "means the contractions are nearly free, near 0 that they take "
            "the time"
        ),
    ))

    # sparse coding (matmul kernel) at the preset's bf16x3: useful FLOPs
    # exclude the 3× passes, executed count them (what occupies the tensor
    # cores)
    eng = CudaMJHMC(SparseCoding(npixels=64, nbasis=128), epsilon=0.02, beta=0.1,
                    num_leapfrog_steps=m, nbatch=4096, seed=0)
    ips = _iterations_per_s(eng, steps)
    executed = SPARSE_CODING_MM_FLOPS * PASSES[eng.spec.precision]
    rows.append(dict(
        engine=f"mjhmc_sparse_coding[{eng.spec.precision}]",
        precision=eng.spec.precision,
        iterations_per_s=ips,
        credited_leapfrog_steps_per_s=ips * m,
        matmul_flops_per_iteration_useful=SPARSE_CODING_MM_FLOPS,
        matmul_flops_per_iteration_executed=executed,
        achieved_matmul_flops_per_s_useful=ips * SPARSE_CODING_MM_FLOPS,
        achieved_matmul_flops_per_s_executed=ips * executed,
        ceiling="tc_mma_sync",
        op_count_source="SparseCodingSpec.du/_resid (+ the bf16x3 split's 3 passes): "
                        "2 contractions × 2pb × 2 halves × M",
    ))

    # NUTS (elementwise kernel): leaves/s, each leaf one leapfrog step plus
    # the tree bookkeeping
    eng = CudaNUTS(Gaussian(ndims=2, log_conditioning=2.0), epsilon=0.3,
                   num_leapfrog_steps=7, nbatch=10_240, seed=0)
    eng.run(100)
    n_iters = max(steps // 5, 1)  # 4,000 at the default, as the JAX row
    best = 0.0
    for _ in range(3):
        seconds = _events_s(lambda: eng.run(n_iters))
        best = max(best, float(eng.last_out.evals.double().sum()) / seconds)
    rows.append(dict(
        engine="nuts_gauss2d_elementwise",
        tree_leaves_per_s=best,
        iterations_timed=n_iters,
        flops_per_leaf=NUTS_FLOPS_PER_LEAF,
        achieved_flops_per_s=best * NUTS_FLOPS_PER_LEAF,
        warp_leaf_utilization=warp_leaf_utilization(eng),
        ceiling="fp32_fma",
        op_count_source="_make_step_nuts leaf_body (leapfrog1 + stack rows)",
    ))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json-out", default=None, help="write the whole record here")
    ap.add_argument("--steps", type=int, default=20_000,
                    help="engine rows time steps and 5·steps jump iterations")
    a = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("# the roofline dossier needs a CUDA device", file=sys.stderr)
        return 1
    from mjhmc_tpu_torch.bench import gpu_name_and_power_limit

    name, limit = gpu_name_and_power_limit()
    device = {"name": name, "power_limit": limit, "steps": a.steps}
    ceilings = measure_ceilings()
    print(json.dumps({"ceilings": ceilings, "device": device}), flush=True)

    rows = engine_rows(a.steps)
    for r in rows:
        ach = (r.get("achieved_matmul_flops_per_s")
               or r.get("achieved_matmul_flops_per_s_executed")
               or r.get("achieved_flops_per_s"))
        if ach:  # the verdict and ablation rows carry no FLOP counts
            r["mfu"] = ach / ceilings[CEILING_KEYS[r["ceiling"]]]
        if "achieved_transcendentals_per_s" in r:
            r["sinf_share"] = r["achieved_transcendentals_per_s"] / ceilings["sinf_per_s"]
        print(json.dumps(r), flush=True)

    if a.json_out:
        with open(a.json_out, "w") as f:
            json.dump({"ceilings": ceilings, "device": device, "engines": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
