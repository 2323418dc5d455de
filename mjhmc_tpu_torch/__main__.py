"""Command-line entry points of the port.

    python -m mjhmc_tpu_torch sample --config rough_well --engine cuda --steps 1000
    python -m mjhmc_tpu_torch sample --config sparse_coding --engine cuda
    python -m mjhmc_tpu_torch sample --config gauss2d --engine cuda --sampler nuts
    python -m mjhmc_tpu_torch sample --config logreg --engine cuda --sampler nuts
    python -m mjhmc_tpu_torch sample --config rough_well --sampler control --integrator two_stage
    python -m mjhmc_tpu_torch sample --config product_of_t --sampler malt --gamma 1.0
    python -m mjhmc_tpu_torch sample --config funnel --engine cuda --sampler nuts
    python -m mjhmc_tpu_torch sample --config mog --engine torch
    python -m mjhmc_tpu_torch bench
    python -m mjhmc_tpu_torch diagnostics --file out.npz

``sample`` runs MJHMC, control HMC, MALT (``--gamma`` is MALT's friction,
carried in the engine's β slot; ``--integrator two_stage`` for MJHMC and
control) or NUTS at max_depth 8, and prints the JSON record of
``mjhmc_tpu``'s ``sample``. ``--engine cuda`` is the fused engine (its plain
version when ``--device cpu``), ``--engine torch`` the plain sampler. Every
preset runs: gauss2d, gauss50d, rough_well, rough_well_a3, funnel, banana,
mog and eight_schools on the elementwise kernel, product_of_t,
sparse_coding and logreg on the matmul kernel. ``--sampler`` picks the
sampler, whatever the preset names (mog's preset sampler, parallel
tempering, is not ported yet: ROADMAP.md, slice D). ``diagnostics`` reads a
``sample --save`` file and prints its autocorrelation, ESS, empirical
spectral gap and split-R̂, computed on ``--device``. The JAX package's other
subcommands are not ported yet (ROADMAP.md, slice H).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def cmd_sample(args):
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.diagnostics import effective_sample_size

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device (use --device cpu)")
    cfg = BENCHMARK_CONFIGS[args.config]
    dist = cfg.make_distribution()
    nbatch = args.nbatch or cfg.nbatch
    evals = None
    common = dict(epsilon=cfg.epsilon, nbatch=nbatch, seed=args.seed, device=device)

    if args.engine == "cuda":
        from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

        ecls = {"mjhmc": cm.CudaMJHMC, "control": cm.CudaControlHMC,
                "malt": cm.CudaMALT, "nuts": cm.CudaNUTS}[args.sampler]
        # MALT's friction rides in the β slot; the NUTS engine's
        # num_leapfrog slot is max_depth, not M
        beta = args.gamma if args.sampler == "malt" else cfg.beta
        nlf = 8 if args.sampler == "nuts" else cfg.num_leapfrog_steps
        try:
            eng = ecls(dist, beta=beta, num_leapfrog_steps=nlf,
                       integrator=args.integrator, **common)
        except NotImplementedError as e:
            raise SystemExit(f"--sampler {args.sampler}: {e}") from e
        eng.run(args.burn)
        xs_t, ws_t = eng.sample(args.steps)
        grad_evals, evals = eng.grad_evals, eng.evals.cpu().numpy()
    else:
        from mjhmc_tpu_torch import samplers

        m = cfg.num_leapfrog_steps
        if args.sampler == "nuts":
            s = samplers.NUTS(dist, **common)
        elif args.sampler == "malt":  # the plain MALT takes no integrator, as in JAX
            s = samplers.MALT(dist, gamma=args.gamma, num_leapfrog_steps=m, **common)
        else:
            cls = samplers.ControlHMC if args.sampler == "control" else samplers.MarkovJumpHMC
            s = cls(dist, beta=cfg.beta, num_leapfrog_steps=m, integrator=args.integrator,
                    **common)
        s.burn_in(args.burn)
        out = s.sample(args.steps)
        xs_t, ws_t = out["x"], out.get("dwell")
        grad_evals = s.grad_evals

    xs = xs_t.cpu().numpy()
    w = np.ones(xs[:, 0].shape, np.float32) if ws_t is None else ws_t.cpu().numpy()
    ww = w[:, None, :]
    mean = (ww * xs).sum(axis=(0, 2)) / ww.sum()
    var = (ww * xs**2).sum(axis=(0, 2)) / ww.sum() - mean**2
    ess = float(effective_sample_size(xs_t, ws_t))
    rec = {
        "config": args.config,
        "sampler": args.sampler,
        "engine": args.engine,
        "steps": args.steps,
        "chains": int(xs.shape[2]),
        "grad_evals": grad_evals,
        "mean": mean.tolist()[:8],
        "var": var.tolist()[:8],
        "ess": ess,
        "ess_per_grad_eval": ess / max(grad_evals, 1),
    }
    if args.save:
        extra = {} if evals is None else {"evals": evals}
        if ws_t is not None:
            extra["dwell"] = w
        np.savez(args.save, x=xs, **extra)
        rec["saved"] = args.save
    print(json.dumps(rec))


def cmd_bench(args):
    from mjhmc_tpu_torch import bench

    sys.exit(bench.main())


def cmd_diagnostics(args):
    """Autocorrelation / ESS / empirical spectral gap / split-R̂ of a saved
    sample file (``sample --save out.npz``), on ``--device``."""
    from mjhmc_tpu_torch.diagnostics import (
        effective_sample_size,
        empirical_spectral_gap,
        potential_scale_reduction,
        weighted_autocorrelation,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device (use --device cpu)")
    with np.load(args.file) as data:
        x = torch.as_tensor(data["x"], device=device)
        w = torch.as_tensor(data["dwell"], device=device) if "dwell" in data else None
    rho = weighted_autocorrelation(x, w, nlags=args.nlags).cpu().numpy()
    rhat = potential_scale_reduction(x, w).cpu().numpy()
    out = {
        "file": args.file,
        "shape": list(x.shape),
        "ess": float(effective_sample_size(x, w)),
        "spectral_gap": empirical_spectral_gap(x, w),
        "rhat_max": float(rhat.max()),
        "rhat": rhat[: min(8, len(rhat))].tolist(),
        "rho_first_lags": rho[: min(10, len(rho))].tolist(),
    }
    print(json.dumps(out))


def main(argv=None):
    p = argparse.ArgumentParser(prog="mjhmc_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("sample")
    sp.add_argument("--config", default="rough_well")
    sp.add_argument("--nbatch", type=int, default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--sampler", choices=["mjhmc", "control", "malt", "nuts"],
                    default="mjhmc")
    sp.add_argument("--gamma", type=float, default=1.0,
                    help="MALT friction (per unit time)")
    sp.add_argument("--integrator", choices=["leapfrog", "two_stage"], default="leapfrog",
                    help="two_stage: the BCSS minimal-error splitting, 2 gradients "
                         "per step (mjhmc and control)")
    sp.add_argument("--steps", type=int, default=1000)
    sp.add_argument("--burn", type=int, default=500)
    sp.add_argument("--save", default=None,
                    help="npz path for raw samples (and, with --engine cuda, "
                         "the per-chain eval counters)")
    sp.add_argument("--engine", choices=["torch", "cuda"], default="cuda",
                    help="cuda = the fused single-kernel engine; torch = the "
                         "plain sampler")
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the cuda engine runs "
                         "its plain version")
    sp.set_defaults(fn=cmd_sample)

    sp = sub.add_parser("bench", help="headline throughput of the CUDA engine")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("diagnostics", help="autocorrelation, ESS, spectral gap and "
                                            "split-R̂ of a saved sample file")
    sp.add_argument("--file", required=True, help="npz from `sample --save`")
    sp.add_argument("--nlags", type=int, default=200)
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_diagnostics)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
