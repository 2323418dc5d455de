"""Every matmul-kernel body and the elementwise NUTS kernel at the presets'
widths, for comparing two checkouts on one card.

    python -m mjhmc_tpu_torch.bench_mm_ab --tag change1 --out chiprun_out/ab
    python -m mjhmc_tpu_torch.bench_mm_ab --compare chiprun_out/ab/parent1.json ...

Run from a checkout's root, it runs MJHMC, control, MALT and NUTS on the
card on product of t, sparse coding and logreg at their presets' chains,
at ``highest`` and at the preset's JAX default dot precision, without and
with an inverse mass, and the elementwise kernel's NUTS (``ew/`` cases) on
gauss2d (10,240 chains, ε 0.3, max_depth 7), the rough well and gauss50d
(4,096 chains) and the zoo presets at their widths and ε (max_depth 8),
without and with a mass, and writes ``<out>/<tag>.json``: per case a SHA-256
of every output of a three-iteration run and stream (bit identity across
checkouts) and the run's and the stream's ms per
iteration (CUDA events; MJHMC and control 100 iterations, MALT 30, NUTS at
max_depth 8: 20 / 3 / 40; elementwise NUTS ``EW_NUTS_ITERS``), and under
``"profile"`` the per-phase breakdown of mm_kernel's PROF instances (MJHMC
and MALT on sparse coding at ``bf16x3``, MALT on logreg at ``default``;
clock64() stamps, the checkout's ``cuda_mjhmc.mm_profile``; a few seconds)
and of the elementwise NUTS run's on gauss2d and the funnel
(``cuda_mjhmc.nuts_profile``, skipped by a checkout that has none), at the
main path's blocks. ``--compare`` prints, case by case, how many distinct
outputs the records hold and their times. To compare a parent,
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
#: the elementwise NUTS cases: config -> (chains, ε or None for the
#: preset's, max_depth, timed iterations)
EW_NUTS = {"gauss2d": (10_240, 0.3, 7, 200), "rough_well": (4096, 1.0, 7, 200),
           "gauss50d": (4096, None, 8, 30), "funnel": (1024, None, 8, 60),
           "banana": (2048, None, 8, 100), "mog": (1024, None, 8, 200),
           "eight_schools": (1024, None, 8, 100), "eight_schools_nc": (1024, None, 8, 100)}


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


def ew_nuts_dist(cname):
    """(distribution, config) of an elementwise NUTS case: the preset's, and
    eight schools non-centered at the eight_schools preset's settings."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.models import EightSchools

    if cname == "eight_schools_nc":
        return EightSchools(parameterization="noncentered"), BENCHMARK_CONFIGS["eight_schools"]
    cfg = BENCHMARK_CONFIGS[cname]
    return cfg.make_distribution(), cfg


def ew_nuts_state(dist, n, seed=1):
    """(x, v, g, u, h_back, valid) of n chains from the distribution's
    inits on the card."""
    gen = torch.Generator().manual_seed(seed)
    x = dist.init_x(gen, n, "cuda")
    v = torch.randn(x.shape, generator=gen).to("cuda")
    u, g = dist.potential_and_grad(x)
    z = torch.zeros(n, device="cuda")
    return x, v, g, u, z, z.clone()


def run_ew_nuts_cases() -> dict:
    """{ew case: dict(out=sha256 of the outputs, run_ms, stream_ms, iters)}
    of the elementwise NUTS kernel (EW_NUTS), without and with a mass."""
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    res = {}
    for cname, (n, eps, depth, iters) in EW_NUTS.items():
        dist, cfg = ew_nuts_dist(cname)
        eps = cfg.epsilon if eps is None else eps
        spec = cm.energy_spec_for(dist)
        st = ew_nuts_state(dist, n)
        mass = tuple(float(m) for m in torch.linspace(0.8, 1.25, dist.ndims))
        for kw in ({}, dict(inv_mass=mass)):
            args = (spec, *st, 77, eps, 0.0)
            opts = dict(variant="nuts", **kw)
            out = cm.cuda_mjhmc_run(*args, 3, depth, **opts)
            xs, ws, es, so = cm.cuda_mjhmc_stream_run(*args, 3, 1, depth, **opts)
            digest = hashlib.sha256()
            for t in (*out, xs, ws, es, *so):
                digest.update(t.cpu().numpy().tobytes())
            res[f"ew/{cname}/nuts/{'mass' if kw else 'plain'}"] = dict(
                out=digest.hexdigest(), iters=iters,
                run_ms=_ms(lambda: cm.cuda_mjhmc_run(*args, iters, depth, **opts), iters),
                stream_ms=_ms(lambda: cm.cuda_mjhmc_stream_run(*args, iters, 1, depth, **opts),
                              iters))
    return res


#: the elementwise NUTS run's PROF instances: config -> (chains, ε,
#: max_depth, iterations)
EW_PROFILES = {"gauss2d": (10_240, 0.3, 7, 200), "funnel": (1024, None, 8, 60)}


def ew_breakdown(prof, names, lanes: int) -> dict:
    """An elementwise NUTS PROF record ((n, phases + 2) cycles of each
    phase of every chain, its leaves and the leaf slots its warp spent,
    counted by one lane a step) as each phase's share of all chains'
    cycles and its cycles per leaf (each chain's wall time, summed), the
    share of the warps' leaf slots that ran a live leaf, the share a warp
    would keep if it ran as many leaf steps as its lanes' largest count
    (``lanes`` a warp), and each chain's cycles, largest and mean."""
    p = prof.double()
    cyc = p[:, : len(names) - 2]
    leaves = p[:, names.index("leaves")]
    slots = float(p[:, names.index("leaf_slots")].sum())
    n = p.shape[0]
    per_warp = torch.nn.functional.pad(leaves, (0, (-n) % lanes)).reshape(-1, lanes)
    live = torch.nn.functional.pad(torch.ones(n, dtype=torch.float64, device=p.device),
                                   (0, (-n) % lanes)).reshape(-1, lanes).sum(dim=1)
    total = float(cyc.sum())
    lane_total = cyc.sum(dim=1)
    return dict(chains=n, leaves_per_chain=float(leaves.mean()),
                cycles_per_leaf=total / float(leaves.sum()),
                share={nm: round(float(cyc[:, i].sum()) / total, 5)
                       for i, nm in enumerate(names[:-2])},
                cycles_per_leaf_by_phase={nm: round(float(cyc[:, i].sum() / leaves.sum()), 1)
                                          for i, nm in enumerate(names[:-2])},
                leaf_slot_share=float(leaves.sum()) / slots,
                lane_schedule_share=float(leaves.sum()) / float(
                    (per_warp.amax(dim=1) * live).sum()),
                chain_cycles_max=float(lane_total.max()), chain_cycles_mean=float(lane_total.mean()))


def run_ew_profiles() -> dict:
    """{"ew/config/nuts": ew_breakdown(...) with the PROF run's and the
    plain instance's ms per iteration} of EW_PROFILES, from the state two
    iterations in; {} where the checkout has no ``nuts_profile``."""
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    if not hasattr(cm, "nuts_profile"):
        return {}
    res = {}
    for cname, (n, eps, depth, iters) in EW_PROFILES.items():
        dist, cfg = ew_nuts_dist(cname)
        eps = cfg.epsilon if eps is None else eps
        spec = cm.energy_spec_for(dist)
        x, v, g, u, z, _ = ew_nuts_state(dist, n)
        o = cm.cuda_mjhmc_run(spec, x, v, g, u, z, z, 5, eps, 0.0, 2, depth, variant="nuts")
        st = (o.x, o.v, o.grad, o.u)
        cm.nuts_profile(spec, *st, 98, eps, 1, depth)  # the instance's first launch
        got = {}
        prof_ms = _ms(lambda: got.update(p=cm.nuts_profile(spec, *st, 99, eps, iters, depth)),
                      iters)
        run_ms = _ms(lambda: cm.cuda_mjhmc_run(spec, *st, z, z, 99, eps, 0.0, iters, depth,
                                               variant="nuts"), iters)
        t = cm.nuts_tile(spec, dist.ndims, depth, n)[0]
        rec = ew_breakdown(got["p"], cm.NUTS_EW_PROF_PHASES, t)
        res[f"ew/{cname}/nuts"] = dict(
            rec, threads=t, prof_ms=prof_ms, run_ms=run_ms, iters=iters, max_depth=depth, eps=eps)
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
    res.update(run_ew_nuts_cases())
    res["profile"] = dict(run_profiles(), **run_ew_profiles())
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
