"""Command-line entry points of the port.

    python -m mjhmc_tpu_torch sample --config rough_well --engine cuda --steps 1000
    python -m mjhmc_tpu_torch bench

``sample`` runs MJHMC and prints the JSON record of ``mjhmc_tpu``'s
``sample``; ``--engine cuda`` is the fused engine (its plain version when
``--device cpu``), ``--engine torch`` the plain sampler. The JAX package's
other subcommands are not ported yet (ROADMAP.md, slice H).
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

    if args.engine == "cuda":
        from mjhmc_tpu_torch.ops.cuda_mjhmc import CudaMJHMC

        eng = CudaMJHMC(
            dist, epsilon=cfg.epsilon, beta=cfg.beta,
            num_leapfrog_steps=cfg.num_leapfrog_steps, nbatch=nbatch,
            seed=args.seed, device=device,
        )
        eng.run(args.burn)
        xs_t, ws_t = eng.sample(args.steps)
        grad_evals, evals = eng.grad_evals, eng.evals.cpu().numpy()
    else:
        from mjhmc_tpu_torch.samplers import MarkovJumpHMC

        s = MarkovJumpHMC(
            dist, epsilon=cfg.epsilon, beta=cfg.beta,
            num_leapfrog_steps=cfg.num_leapfrog_steps, nbatch=nbatch,
            seed=args.seed, device=device,
        )
        s.burn_in(args.burn)
        out = s.sample(args.steps)
        xs_t, ws_t = out["x"], out["dwell"]
        grad_evals = s.grad_evals

    xs, w = xs_t.cpu().numpy(), ws_t.cpu().numpy()
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
        np.savez(args.save, x=xs, dwell=w, **extra)
        rec["saved"] = args.save
    print(json.dumps(rec))


def cmd_bench(args):
    from mjhmc_tpu_torch import bench

    sys.exit(bench.main())


def main(argv=None):
    p = argparse.ArgumentParser(prog="mjhmc_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("sample")
    sp.add_argument("--config", default="rough_well")
    sp.add_argument("--nbatch", type=int, default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--sampler", choices=["mjhmc"], default="mjhmc")
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

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
