"""Command-line entry points of the port.

    python -m mjhmc_tpu_torch sample --config rough_well --engine cuda --steps 1000
    python -m mjhmc_tpu_torch sample --config sparse_coding --engine cuda
    python -m mjhmc_tpu_torch sample --config gauss2d --engine cuda --sampler nuts
    python -m mjhmc_tpu_torch sample --config logreg --engine cuda --sampler nuts
    python -m mjhmc_tpu_torch sample --config rough_well --sampler control --integrator two_stage
    python -m mjhmc_tpu_torch sample --config product_of_t --sampler malt --gamma 1.0
    python -m mjhmc_tpu_torch sample --config funnel --engine cuda --sampler nuts
    python -m mjhmc_tpu_torch sample --config mog --sampler pt --engine torch --adapt-ladder
    python -m mjhmc_tpu_torch sample --config rough_well --sampler reduced_flip --engine torch
    python -m mjhmc_tpu_torch smc --config product_of_t
    python -m mjhmc_tpu_torch vi --config gauss50d [--rank 16]
    python -m mjhmc_tpu_torch bench [--profile DIR]
    python -m mjhmc_tpu_torch diagnostics --file out.npz
    python -m mjhmc_tpu_torch search --config gauss2d [--method bayes]
    python -m mjhmc_tpu_torch figures [--quick] [--out figures_out] [--only spectral]
    python -m mjhmc_tpu_torch efficiency [--quick] [--out figures/efficiency_claim]

``sample`` runs MJHMC, control HMC, MALT (``--gamma`` is MALT's friction,
carried in the engine's β slot; ``--integrator two_stage`` for MJHMC and
control) or NUTS at max_depth 8, and prints the JSON record of
``mjhmc_tpu``'s ``sample``. ``--engine cuda`` is the fused engine (its plain
version when ``--device cpu``), ``--engine torch`` the plain sampler; the
plain samplers add reduced-flip HMC and parallel tempering (``--sampler
reduced_flip|pt``; ``--num-temps``, ``--beta-min``, ``--adapt-ladder``),
which the fused engine refuses. Every preset runs: gauss2d, gauss50d,
rough_well, rough_well_a3, funnel, banana, mog and eight_schools on the
elementwise kernel, product_of_t, sparse_coding and logreg on the matmul
kernel. ``--sampler`` picks the sampler, whatever the preset names.
``smc`` anneals particles from a Gaussian prior (``inference.smc``) and
``vi`` fits ADVI (``inference.vi``), each printing the JAX package's
record. ``diagnostics`` reads a ``sample --save`` file and prints its
autocorrelation, ESS, empirical spectral gap and split-R̂, computed on
``--device``. ``search`` tunes (ε, β, M) by the grid sweep or the GP-EI
search (``search``) and prints ``{"best", "table"}``; ``figures`` writes
the paper's figures (``.npz``, then ``.png`` where matplotlib is
installed) and ``efficiency`` the efficiency-claim battery, each under
``--out`` only. ``bench --profile DIR`` writes a ``torch.profiler`` trace
of the headline benchmark to ``DIR/trace.json``. Every subcommand runs on
the card unless ``--device cpu`` is asked for (``bench`` needs the card).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


#: the samplers the fused engine (``--engine cuda``) runs
ENGINE_SAMPLERS = ("mjhmc", "control", "malt", "nuts")


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device (use --device cpu)")
    return device


def cmd_sample(args):
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.diagnostics import effective_sample_size

    if args.engine == "cuda" and args.sampler not in ENGINE_SAMPLERS:
        raise SystemExit(f"--engine cuda supports {'/'.join(ENGINE_SAMPLERS)}, not "
                         f"{args.sampler!r} (--engine torch runs it)")
    device = _device(args)
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
        elif args.sampler == "pt":
            s = samplers.ParallelTempering(dist, num_leapfrog_steps=m, num_temps=args.num_temps,
                                           beta_min=args.beta_min, **common)
        elif args.sampler == "reduced_flip":  # leapfrog only, as in JAX
            s = samplers.ReducedFlipHMC(dist, beta=cfg.beta, num_leapfrog_steps=m, **common)
        else:
            cls = samplers.ControlHMC if args.sampler == "control" else samplers.MarkovJumpHMC
            s = cls(dist, beta=cfg.beta, num_leapfrog_steps=m, integrator=args.integrator,
                    **common)
        if args.sampler == "pt" and args.adapt_ladder:
            s.adapt_ladder()
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
    if args.sampler == "pt":
        rec["betas"] = s.betas.cpu().numpy().tolist()
        rec["swap_rates"] = np.asarray(s.swap_rates).tolist()
        rec["round_trip_rate"] = s.round_trip_rate
    if args.save:
        extra = {} if evals is None else {"evals": evals}
        if ws_t is not None:
            extra["dwell"] = w
        np.savez(args.save, x=xs, **extra)
        rec["saved"] = args.save
    print(json.dumps(rec))


def cmd_bench(args):
    from mjhmc_tpu_torch import bench

    if args.profile:
        # a Chrome/Perfetto trace of the whole timed run
        from mjhmc_tpu_torch.utils.profiling import trace

        with trace(args.profile):
            rc = bench.main()
        print(f"# trace written to {args.profile}/trace.json", file=sys.stderr)
        sys.exit(rc)
    sys.exit(bench.main())


def cmd_figures(args):
    from mjhmc_tpu_torch.experiments import figures

    _device(args)
    argv = ["--out", args.out, "--device", args.device] + (["--quick"] if args.quick else [])
    if args.only:
        argv += ["--only", args.only]
    figures.main(argv)


def cmd_search(args):
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.search import bayes_search, grid_search

    device = _device(args)
    dist = BENCHMARK_CONFIGS[args.config].make_distribution()
    # as in the JAX package, --seed is parsed but the searches keep their
    # default seed (ROADMAP.md §3)
    kw = dict(sampler=args.sampler, num_steps=args.steps, nbatch=args.nbatch or 256,
              device=device)
    if args.method == "bayes":
        res = bayes_search(dist, num_iters=args.iters, **kw)
    else:
        res = grid_search(dist, **kw)
    print(json.dumps({"best": res.best, "table": res.table}))


def cmd_efficiency(args):
    from mjhmc_tpu_torch.experiments.efficiency_claim import main as claim_main

    _device(args)
    argv = ["--out", args.out, "--seed", str(args.seed), "--device", args.device]
    if args.quick:
        argv.append("--quick")
    claim_main(argv)


def cmd_diagnostics(args):
    """Autocorrelation / ESS / empirical spectral gap / split-R̂ of a saved
    sample file (``sample --save out.npz``), on ``--device``."""
    from mjhmc_tpu_torch.diagnostics import (
        effective_sample_size,
        empirical_spectral_gap,
        potential_scale_reduction,
        weighted_autocorrelation,
    )

    device = _device(args)
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


def cmd_smc(args):
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.inference import SMC

    head = SMC(BENCHMARK_CONFIGS[args.config].make_distribution(),
               num_particles=args.nbatch or 4096, num_stages=args.stages,
               prior_scale=args.prior_scale, seed=args.seed, device=_device(args))
    state, _ = head.run()
    x = state.x.cpu().numpy()
    print(json.dumps({
        "config": args.config,
        "log_evidence": float(state.log_z),
        "final_lambda": float(state.lam),
        "particles": int(x.shape[1]),
        "mean": x.mean(axis=1).tolist()[:8],
        "var": x.var(axis=1).tolist()[:8],
    }))


def cmd_vi(args):
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.inference import ADVI

    head = ADVI(BENCHMARK_CONFIGS[args.config].make_distribution(), seed=args.seed,
                rank=args.rank, device=_device(args))
    params, elbos = head.fit()
    rec = {
        "config": args.config,
        "rank": args.rank,
        "final_elbo": float(elbos[-50:].mean()),
        "mu": params.mu.cpu().numpy().tolist()[:8],
        "sigma": torch.exp(params.omega).cpu().numpy().tolist()[:8],
    }
    if args.rank > 0:
        rec["cov_diag"] = torch.diagonal(head.covariance()).cpu().numpy().tolist()[:8]
    print(json.dumps(rec))


def main(argv=None):
    p = argparse.ArgumentParser(prog="mjhmc_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", default="rough_well")
        sp.add_argument("--nbatch", type=int, default=None)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    sp = sub.add_parser("sample")
    common(sp)
    sp.add_argument("--sampler",
                    choices=["mjhmc", "control", "reduced_flip", "nuts", "malt", "pt"],
                    default="mjhmc")
    sp.add_argument("--gamma", type=float, default=1.0,
                    help="MALT friction (per unit time)")
    sp.add_argument("--integrator", choices=["leapfrog", "two_stage"], default="leapfrog",
                    help="two_stage: the BCSS minimal-error splitting, 2 gradients "
                         "per step (mjhmc and control)")
    sp.add_argument("--num-temps", type=int, default=6,
                    help="temperature-ladder size (only used with --sampler pt)")
    sp.add_argument("--beta-min", type=float, default=0.05,
                    help="coldest inverse temperature (only with --sampler pt)")
    sp.add_argument("--adapt-ladder", action="store_true",
                    help="tune the PT beta ladder to uniform swap rates first")
    sp.add_argument("--steps", type=int, default=1000)
    sp.add_argument("--burn", type=int, default=500)
    sp.add_argument("--save", default=None,
                    help="npz path for raw samples (and, with --engine cuda, "
                         "the per-chain eval counters)")
    sp.add_argument("--engine", choices=["torch", "cuda"], default="cuda",
                    help="cuda = the fused single-kernel engine (mjhmc/control/malt/nuts; "
                         "its plain version with --device cpu); torch = the plain sampler")
    sp.set_defaults(fn=cmd_sample)

    sp = sub.add_parser("bench", help="headline throughput of the CUDA engine")
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler (Chrome/Perfetto) trace of the run to "
                         "DIR/trace.json")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("figures", help="the paper's figures (.npz, and .png with matplotlib)")
    sp.add_argument("--out", default="figures_out")
    sp.add_argument("--quick", action="store_true")
    sp.add_argument("--only", default=None, help="one figure by name")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_figures)

    sp = sub.add_parser("search", help="tune (eps, beta, M): grid sweep or GP-EI")
    common(sp)
    sp.add_argument("--sampler", choices=["mjhmc", "control"], default="mjhmc")
    sp.add_argument("--steps", type=int, default=800)
    sp.add_argument("--method", choices=["grid", "bayes"], default="grid",
                    help="'bayes' = in-process GP-EI (the Spearmint analogue)")
    sp.add_argument("--iters", type=int, default=14,
                    help="BO iterations after the init design (bayes only)")
    sp.set_defaults(fn=cmd_search)

    sp = sub.add_parser("smc", help="tempered SMC from a Gaussian prior: log evidence and "
                                     "the final particles' moments")
    common(sp)
    sp.add_argument("--stages", type=int, default=20,
                    help="tempering stages (tight high-dim posteriors, e.g. "
                         "sparse_coding, need 60-150)")
    sp.add_argument("--prior-scale", type=float, default=3.0)
    sp.set_defaults(fn=cmd_smc)

    sp = sub.add_parser("vi", help="ADVI: the fitted mean and scales, and the final ELBO")
    common(sp)
    sp.add_argument("--rank", type=int, default=0,
                    help="covariance rank: 0 = mean-field, ndims = full-rank")
    sp.set_defaults(fn=cmd_vi)

    sp = sub.add_parser("diagnostics", help="autocorrelation, ESS, spectral gap and "
                                            "split-R̂ of a saved sample file")
    sp.add_argument("--file", required=True, help="npz from `sample --save`")
    sp.add_argument("--nlags", type=int, default=200)
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_diagnostics)

    sp = sub.add_parser("efficiency",
                        help="the paper's statistical-efficiency claim experiment (long)")
    sp.add_argument("--out", default="figures/efficiency_claim")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--quick", action="store_true")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_efficiency)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
