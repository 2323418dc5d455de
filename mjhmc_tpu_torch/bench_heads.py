"""Wall-clock receipts of the SMC and VI heads on the card (counterpart of
``tools/bench_heads.py``).

- SMC: log-evidence error against wall on the analytic Gaussian oracle
  (the gauss50d target, 4,096 particles): a sweep over 6, 12, 24 and 48
  stages, each point repeated over ``--repeats`` seeds (median wall,
  median |log Z error|, stages/s); then config 5's full anneal (sparse
  coding, 8,192 particles, 150 stages, initial ε 0.05): stages/s and wall
  to λ = 1.
- VI: ELBO convergence against wall (2,000 steps, n_mc 64) on gauss50d
  (mean-field is the target's family, so the gap to the analytic log Z̃
  is KL(q‖p)) and sparse coding (mean-field and rank 16): the converged
  plateau and the wall to within 1 and 0.1 nats of it.
- The sharded path: ``smc_run`` with its particles split over a chain mesh
  of 8 gloo ranks on the CPU (8 processes; 2,048 particles on gauss50d, 32
  stages), one untimed call and one timed: a receipt that the distributed
  resample runs inside the annealing loop. Its wall is the CPU's, not the
  card's.

Every call is timed on the host clock around work that ends in a device
synchronise, the best of the timed calls after a short untimed warm one
(the same call at 2 stages or 10 steps); every row carries the card's name
and power limit. One JSON line per row; the whole
receipt goes to ``--json-out`` when asked.

    python -m mjhmc_tpu_torch.bench_heads [--repeats 3] [--json-out FILE]

``--device cpu`` runs the card's rows on the CPU (the sizes above are the
module's constants); the sharded path runs on the CPU either way.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mjhmc_tpu_torch.bench_ess import device_record, timed
from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
from mjhmc_tpu_torch.inference.smc import smc_run
from mjhmc_tpu_torch.inference.vi import advi_fit

SWEEP_PARTICLES, SWEEP_STAGES = 4096, (6, 12, 24, 48)
ANNEAL_PARTICLES, ANNEAL_STAGES = 8192, 150  # config 5's anneal
VI_STEPS = 2000
#: the untimed warm call's stages (SMC) and steps (VI): eager PyTorch has no
#: compile to absorb, only first-use costs (kernel loads, allocations)
WARM_STAGES, WARM_STEPS = 2, 10


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def smc_gaussian_sweep(device, repeats=3) -> dict:
    particles = SWEEP_PARTICLES
    dist = BENCHMARK_CONFIGS["gauss50d"].make_distribution()
    prior_scale = 3.0
    var = dist.analytic_var().numpy().astype(np.float64)
    log_z_exact = 0.5 * np.sum(np.log(var)) - 0.5 * len(var) * np.log(prior_scale**2)
    rows = []
    for stages in SWEEP_STAGES:
        errs, walls, lams = [], [], []
        for r in range(repeats):
            def run(r=r, stages=stages):
                state, _ = smc_run(dist, _generator(device, 100 + r), particles,
                                   num_stages=stages, prior_scale=prior_scale,
                                   num_mutation_steps=5, num_leapfrog_steps=5, device=device)
                float(state.log_z)  # the host reads the result
                return state
            wall, state = timed(run, 2, device, warm=lambda: run(stages=WARM_STAGES))
            errs.append(abs(float(state.log_z) - log_z_exact))
            walls.append(wall)
            lams.append(float(state.lam))
        rows.append(dict(
            target="gauss50d", num_stages=stages, particles=particles,
            wall_s=float(np.median(walls)),
            stages_per_s=stages / float(np.median(walls)),
            logz_abs_err_nats=float(np.median(errs)),
            logz_err_values=[round(e, 4) for e in errs],
            reached_lambda1=all(lam == 1.0 for lam in lams),
            **device_record(device),
        ))
        print(json.dumps(rows[-1]), flush=True)
    return dict(oracle_log_z=float(log_z_exact), sweep=rows)


def smc_config5_anneal(device, repeats=3) -> dict:
    particles, stages = ANNEAL_PARTICLES, ANNEAL_STAGES
    dist = BENCHMARK_CONFIGS["sparse_coding"].make_distribution()
    walls, lams = [], []
    for r in range(repeats):
        def run(r=r, stages=stages):
            state, _ = smc_run(dist, _generator(device, 200 + r), particles, num_stages=stages,
                               num_mutation_steps=5, num_leapfrog_steps=5, init_eps=0.05,
                               device=device)
            float(state.log_z)
            return state
        wall, state = timed(run, 1, device, warm=lambda: run(stages=WARM_STAGES))
        walls.append(wall)
        lams.append(float(state.lam))
    row = dict(
        target="sparse_coding(128d)", num_stages=stages, particles=particles,
        wall_s=float(np.median(walls)),
        stages_per_s=stages / float(np.median(walls)),
        wall_values=[round(w, 3) for w in walls],
        reached_lambda1=all(lam == 1.0 for lam in lams),
        log_z=float(state.log_z),
        **device_record(device),
    )
    print(json.dumps(row), flush=True)
    return row


def vi_convergence(device, repeats=3) -> list:
    steps = VI_STEPS
    rows = []
    for config, rank in (("gauss50d", 0), ("sparse_coding", 0), ("sparse_coding", 16)):
        dist = BENCHMARK_CONFIGS[config].make_distribution()
        walls, finals, traces = [], [], []
        for r in range(repeats):
            def run(r=r, steps=steps):
                _, elbos = advi_fit(dist, _generator(device, 300 + r), num_steps=steps, n_mc=64,
                                    learning_rate=0.05, rank=rank, device=device)
                return elbos.cpu().numpy().astype(np.float64)
            wall, e = timed(run, 1, device, warm=lambda: run(steps=WARM_STEPS))
            walls.append(wall)
            finals.append(float(e[-100:].mean()))
            traces.append(e)
        wall = float(np.median(walls))
        e = traces[int(np.argsort(finals)[len(finals) // 2])]
        plateau = float(e[-100:].mean())
        sec_per_step = wall / steps  # every step is the same work

        def wall_to(delta):
            k = 25  # smooth the per-step Monte-Carlo noise before thresholding
            sm = np.convolve(e, np.ones(k) / k, mode="valid")
            hit = np.argmax(sm >= plateau - delta)
            if sm[hit] < plateau - delta:
                return None
            return round(float((hit + k) * sec_per_step), 4)

        row = dict(
            target=config + (f"(rank{rank})" if rank else "(mean-field)"),
            num_steps=steps, n_mc=64, wall_s=wall, steps_per_s=steps / wall,
            elbo_final=plateau, elbo_final_values=[round(f, 3) for f in finals],
            wall_to_within_1nat_s=wall_to(1.0), wall_to_within_0p1nat_s=wall_to(0.1),
            **device_record(device),
        )
        if config == "gauss50d":
            # mean-field is the target's family: ELBO* = log Z̃, the gap KL(q‖p)
            var = dist.analytic_var().numpy().astype(np.float64)
            row["analytic_log_z"] = float(0.5 * np.sum(np.log(2 * np.pi * var)))
            row["kl_gap_nats"] = row["analytic_log_z"] - plateau
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


SHARDED_RANKS, SHARDED_PARTICLES, SHARDED_STAGES = 8, 2048, 32


def _sharded_rank(rank: int, world: int, addr: str, particles: int, stages: int) -> None:
    """One rank of ``sharded_path_receipt``: joins the gloo group, runs
    ``smc_run`` over the chain mesh once untimed (seed 5) and once timed
    (seed 6, from a barrier to a barrier); rank 0 prints the receipt."""
    import torch.distributed as tdist

    from mjhmc_tpu_torch.parallel.mesh import make_chain_mesh
    from mjhmc_tpu_torch.parallel.multihost import initialize

    torch.set_num_threads(1)
    initialize(addr, world, rank, device="cpu")
    try:
        mesh = make_chain_mesh(device="cpu")
        dist = BENCHMARK_CONFIGS["gauss50d"].make_distribution()

        def fit(seed):
            state, _ = smc_run(dist, _generator("cpu", seed), particles, num_stages=stages,
                               num_mutation_steps=5, num_leapfrog_steps=5, mesh=mesh)
            float(state.log_z)
            return state

        fit(5)
        tdist.barrier()
        t0 = time.perf_counter()
        state = fit(6)
        tdist.barrier()
        wall = time.perf_counter() - t0
        if rank == 0:
            print(json.dumps(dict(
                backend=f"cpu-gloo-{world}rank", num_stages=stages, particles=particles,
                wall_s=round(wall, 3), stages_per_s=round(stages / wall, 3),
                reached_lambda1=float(state.lam) == 1.0)), flush=True)
    finally:
        tdist.destroy_process_group()


def sharded_path_receipt(ranks=None, particles=None, stages=None, timeout=900) -> dict:
    """``smc_run(mesh=...)`` on gauss50d over ``ranks`` gloo processes on the
    CPU (counterpart of JAX's forced 8-device CPU mesh): 5 mutation steps
    of 5 leapfrog steps a stage; ``ranks``, ``particles`` and ``stages``
    default to the module's ``SHARDED_*`` sizes. Returns {backend,
    num_stages, particles, wall_s, stages_per_s, reached_lambda1}; the wall
    is a CPU path receipt, not a card number. A rank that fails makes it
    raise."""
    from mjhmc_tpu_torch.parallel.multihost import free_port

    ranks = SHARDED_RANKS if ranks is None else ranks
    particles = SHARDED_PARTICLES if particles is None else particles
    stages = SHARDED_STAGES if stages is None else stages

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    addr = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, "-m", "mjhmc_tpu_torch.bench_heads",
                               "--sharded-rank", str(r), str(ranks), addr, str(particles),
                               str(stages)], env=env, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, err[-1000:]) for r, (p, (_, err)) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"sharded_path_receipt: ranks failed: {failed}")
    row = json.loads(outs[0][0].strip().splitlines()[-1])
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["--sharded-rank"]:  # one process of sharded_path_receipt
        rank, world, addr, particles, stages = argv[1:6]
        _sharded_rank(int(rank), int(world), addr, int(particles), int(stages))
        return 0
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json-out", default=None, help="write the whole receipt here too")
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("# bench_heads needs a CUDA device (or --device cpu)", file=sys.stderr)
        return 1
    receipt = {
        "smc_gaussian_logz_vs_wall": smc_gaussian_sweep(device, a.repeats),
        "smc_config5_anneal": smc_config5_anneal(device, a.repeats),
        "vi_elbo_vs_wall": vi_convergence(device, a.repeats),
        "smc_sharded_ring_resample_path": sharded_path_receipt(),
    }
    if a.json_out:
        with open(a.json_out, "w") as f:
            json.dump(receipt, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
