"""Every matmul-kernel body at the presets' widths, for comparing two
checkouts on one card.

    python -m mjhmc_tpu_torch.bench_mm_ab --tag change1 --out chiprun_out/ab
    python -m mjhmc_tpu_torch.bench_mm_ab --compare chiprun_out/ab/parent1.json ...

Run from a checkout's root, it runs MJHMC, control, MALT and NUTS on the
card on product of t, sparse coding and logreg at their presets' chains,
at ``highest`` and at the preset's JAX default dot precision, without and
with an inverse mass, and writes ``<out>/<tag>.json``: per case a SHA-256
of every output of a three-iteration run and stream (bit identity across
checkouts) and the run's and the stream's ms per
iteration (CUDA events; MJHMC and control 100 iterations, MALT 30, NUTS at
max_depth 8: 20 / 3 / 40), and under ``"profile"`` the per-phase
breakdown of mm_kernel's PROF instances (MJHMC and MALT on sparse coding at
``bf16x3``, MALT on logreg at ``default``; clock64() stamps, the
checkout's ``cuda_mjhmc.mm_profile``; a few seconds). ``--compare``
prints, case by case, how many distinct outputs the records hold and their
times. To compare a parent,
unpack it with ``git archive`` into a directory that ``.gitignore`` lists
and run each checkout's copy from its own root in one chip call, in
turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os

import torch

#: (body, β) of the cases; NUTS's ε and iterations per preset
BODIES = (("mjhmc", 0.1), ("control", 0.2), ("malt", 1.0), ("nuts", 0.0))
NUTS_EPS = {"product_of_t": 0.12, "sparse_coding": 0.02, "logreg": 0.15}
NUTS_ITERS = {"product_of_t": 20, "sparse_coding": 3, "logreg": 40}
ITERS = {"mjhmc": 100, "control": 100, "malt": 30}
NUTS_DEPTH = 8


def _ms(fn, iters):
    """ms per iteration of ``fn()`` by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run_cases() -> dict:
    """{case: dict(out=sha256 of the outputs, run_ms, stream_ms, iters)}."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    res = {}
    for cname in ("product_of_t", "sparse_coding", "logreg"):
        cfg = BENCHMARK_CONFIGS[cname]
        dist = cfg.make_distribution()
        spec0 = cm.energy_spec_for(dist)
        n, device = cfg.nbatch, "cuda"
        gen = torch.Generator().manual_seed(1)
        x = dist.init_x(gen, n, device)
        v = torch.randn(x.shape, generator=gen).to(device)
        u, g = dist.potential_and_grad(x)
        z = torch.zeros(n, device=device)
        mass = tuple(float(m) for m in torch.linspace(0.8, 1.25, dist.ndims))
        for body, beta in BODIES:
            nuts = body == "nuts"
            eps = NUTS_EPS[cname] if nuts else cfg.epsilon
            m = NUTS_DEPTH if nuts else cfg.num_leapfrog_steps
            iters = NUTS_ITERS[cname] if nuts else ITERS[body]
            for prec in ("highest", spec0.precision):
                spec = dataclasses.replace(spec0, precision=prec)
                for kw in ({}, dict(inv_mass=mass)):
                    args = (spec, x, v, g, u, z, z, 77, eps, beta)
                    opts = dict(variant=body, **kw)
                    out = cm.cuda_mjhmc_mm_run(*args, 3, m, **opts)
                    xs, ws, es, so = cm.cuda_mjhmc_mm_stream_run(*args, 3, 1, m, **opts)
                    digest = hashlib.sha256()
                    for t in (*out, xs, ws, es, *so):
                        digest.update(t.cpu().numpy().tobytes())
                    res[f"{cname}/{body}/{prec}/{'mass' if kw else 'plain'}"] = dict(
                        out=digest.hexdigest(), iters=iters,
                        run_ms=_ms(lambda: cm.cuda_mjhmc_mm_run(*args, iters, m, **opts), iters),
                        stream_ms=_ms(lambda: cm.cuda_mjhmc_mm_stream_run(*args, iters, 1, m,
                                                                          **opts), iters))
    return res


#: mm_kernel's PROF instances: (config, body, β)
PROFILES = (("sparse_coding", "mjhmc", 0.1), ("sparse_coding", "malt", 1.0),
            ("logreg", "malt", 1.0))


def breakdown(prof, names, iters: int) -> dict:
    """A PROF record ((blocks, 2, phases + 1) cycles of each phase by thread
    0 and by the last warp's first thread, then the block's count of
    gradients) as each phase's share of thread 0's cycles and its cycles per
    gradient (wall time: the SM's other resident blocks issue meanwhile),
    and the last warp's share of cycles at barriers."""
    blocks = prof.shape[0]
    p = prof.double().sum(dim=0)
    count = float(p[0, -1])
    cyc = p[:, :-1]
    total = cyc.sum(dim=1)
    bar = names.index("barrier_waits")
    return dict(blocks=blocks, gradients_per_block_iteration=count / (blocks * iters),
                cycles_per_gradient=float(total[0]) / count,
                share={nm: round(float(cyc[0, i] / total[0]), 5)
                       for i, nm in enumerate(names[:-1])},
                cycles_per_gradient_by_phase={nm: round(float(cyc[0, i]) / count, 1)
                                              for i, nm in enumerate(names[:-1])},
                last_warp_barrier_share=float(cyc[1, bar] / total[1]))


def run_profiles(iters: int = 10) -> dict:
    """{"config/body": breakdown(...) with the PROF run's and the plain
    instance's ms per iteration} of each of PROFILES at the preset's width
    and JAX default precision, from the state two iterations in."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    res = {}
    for cname, body, beta in PROFILES:
        cfg = BENCHMARK_CONFIGS[cname]
        dist = cfg.make_distribution()
        spec = cm.energy_spec_for(dist)
        n, m, eps = cfg.nbatch, cfg.num_leapfrog_steps, cfg.epsilon
        gen = torch.Generator().manual_seed(1)
        x = dist.init_x(gen, n, "cuda")
        v = torch.randn(x.shape, generator=gen).to("cuda")
        u, g = dist.potential_and_grad(x)
        z = torch.zeros(n, device="cuda")
        o = cm.cuda_mjhmc_mm_run(spec, x, v, g, u, z, z, 5, eps, beta, 2, m, variant=body)
        st = (o.x, o.v, o.grad, o.u)
        cm.mm_profile(spec, body, *st, 98, eps, beta, 1, m)  # the instance's first launch
        got = {}
        prof_ms = _ms(lambda: got.update(p=cm.mm_profile(spec, body, *st, 99, eps, beta, iters,
                                                         m)), iters)
        run_ms = _ms(lambda: cm.cuda_mjhmc_mm_run(spec, *st, z, z, 99, eps, beta, iters, m,
                                                  variant=body), iters)
        rec = breakdown(got["p"], cm.MM_PROF_PHASES, iters)
        res[f"{cname}/{body}/{spec.precision}"] = dict(rec, prof_ms=prof_ms, run_ms=run_ms,
                                                       iters=iters)
    return res


def compare(records: dict) -> list:
    """Lines "case <n> outputs tag:run/stream ..." for every case of any
    record, n the distinct output hashes among the records that hold it."""
    cases = list(dict.fromkeys(k for rec in records.values() for k in rec if k != "profile"))
    lines = []
    for case in cases:
        have = [t for t, rec in records.items() if case in rec]
        n = len({records[t][case]["out"] for t in have})
        times = " ".join(f"{t}:{records[t][case]['run_ms']:.6g}/{records[t][case]['stream_ms']:.6g}"
                         for t in have)
        lines.append(f"{case} {n} outputs {times}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", help="the record's name")
    ap.add_argument("--out", default="chiprun_out/ab", help="directory of the records")
    ap.add_argument("--compare", nargs="+", metavar="RECORD", help="compare records instead")
    args = ap.parse_args(argv)
    if args.compare:
        recs = {}
        for path in args.compare:
            with open(path) as f:
                recs[os.path.basename(path).removesuffix(".json")] = json.load(f)
        print("\n".join(compare(recs)))
        return 0
    if not args.tag:
        ap.error("--tag is needed to run the cases")
    if not torch.cuda.is_available():
        print("bench_mm_ab: no CUDA device")
        return 1
    res = run_cases()
    res["profile"] = run_profiles()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.tag}.json"), "w") as f:
        json.dump(res, f, indent=1)
    for case, rec in res.items():
        if case == "profile":
            for key, p in rec.items():
                print(args.tag, "profile", key, json.dumps(p))
        else:
            print(args.tag, case, f"run {rec['run_ms']:.6g} stream {rec['stream_ms']:.6g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
