"""Every matmul-kernel body and the elementwise kernel's bodies at the
presets' widths, for comparing two checkouts on one card.

    python -m mjhmc_tpu_torch.bench_mm_ab --tag change1 --out chiprun_out/ab
    python -m mjhmc_tpu_torch.bench_mm_ab --tag change1 --only ew   # elementwise MJHMC/control/MALT
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
main path's blocks. The ``ew/`` MJHMC, control and MALT cases
(``EW_CASES``: the rough well at 10,000 and 102,400 chains, gauss50d at
4,096 and the zoo presets at theirs, with the branches; best of three
timings of ``EW_ITERS`` iterations from the distributions' inits) come
with the rough-well headline as ``python -m mjhmc_tpu_torch bench``
measures it, the PROF breakdowns of ``EW_BODY_PROFILES``
(``cuda_mjhmc.ew_profile``, skipped by a checkout that has none) and each
elementwise instance's ptxas registers and spill stores. ``--only hold``
holds the D=50 rough well's MJHMC, MALT and control against the plain
version after 3 and 5 iterations, field by field, beside what a one-ulp
nudge of x does to the plain version alone (``run_hold``, under
``"profile"``). ``--only deep`` times one launch of the matmul NUTS run
and stream at ``DEEP_DEPTHS`` (those the checkout's kernel takes) on
product of t at its preset's 4,096 chains and JAX default precision, ε
0.002, Philox (``mm_deep/`` cases: their outputs' hash, best of three
launches). ``--only past`` runs the matmul engine past one block's shared
memory (``past/`` cases, ``PAST_CASES``): every body at logistic regression
at LIBSVM a9a's shape (124 × 32,561, 2,048 chains) and sparse coding 1,024
× 4,096 (1,024 chains) at their JAX default precisions, NUTS at max_depth
4, their outputs' hash of a two-iteration run and stream and the ms of ten,
and a9a's one tile of NUTS (8 chains) at max_depth 13, one launch each;
beside each case the ms of the two contractions of one gradient at its
shape and precision as ``torch.matmul`` (``matmul_ms``, CUDA events), a
yardstick of the card's matmul rate that the port never calls. It uses only
calls an older checkout also has, and builds the cases' on-demand instances
first, all at once. ``--only`` runs one group. ``--compare`` prints, case by
case, how many distinct outputs the records hold and their times. To
compare a parent,
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


#: the matmul NUTS trees of ``--only deep``: max_depth 12 on the instance
#: every shallower tree runs, 13 and 14 past the tile depth
DEEP_DEPTHS = (12, 13, 14)


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


def run_deep_cases() -> dict:
    """{case: dict(out, run_ms, stream_ms, iters)} of the matmul NUTS at
    ``DEEP_DEPTHS``: one launch of one iteration each, best of three."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    cfg = BENCHMARK_CONFIGS["product_of_t"]
    dist = cfg.make_distribution()
    spec = cm.energy_spec_for(dist)
    n = cfg.nbatch
    gen = torch.Generator().manual_seed(3)
    x = dist.init_x(gen, n, "cuda")
    v = torch.randn(x.shape, generator=gen).to("cuda")
    u, g = dist.potential_and_grad(x)
    z = torch.zeros(n, device="cuda")
    res = {}
    for depth in (dd for dd in DEEP_DEPTHS if dd <= cm.NUTS_MM_MAX_DEPTH):
        args = (spec, x, v, g, u, z, z, 99, 0.002, 0.0)
        out = cm.cuda_mjhmc_mm_run(*args, 1, depth, variant="nuts")
        xs, ws, es, so = cm.cuda_mjhmc_mm_stream_run(*args, 1, 1, depth, variant="nuts")
        digest = hashlib.sha256()
        for t in (*out, xs, ws, es, *so):
            digest.update(t.cpu().numpy().tobytes())
        res[f"mm_deep/product_of_t/nuts/{spec.precision}/max_depth {depth}"] = dict(
            out=digest.hexdigest(), iters=1,
            leaves=float(out.evals.double().mean()),
            run_ms=min(_ms(lambda: cm.cuda_mjhmc_mm_run(*args, 1, depth, variant="nuts"), 1)
                       for _ in range(3)),
            stream_ms=min(_ms(lambda: cm.cuda_mjhmc_mm_stream_run(*args, 1, 1, depth,
                                                                  variant="nuts"), 1)
                          for _ in range(3)))
    return res


#: ``--only past``: label -> (model, its arguments, chains, ε or None for a
#: quarter of the smallest Laplace standard deviation, M); NUTS at
#: PAST_NUTS_DEPTH; iterations held (hashed) and timed; the one-tile NUTS
#: launch's chains, max_depth and ε
PAST_CASES = {
    "logreg 124x32561": ("LogisticRegression", dict(ndims=124, nobs=32561), 2048, None, 10),
    "sparse_coding 4096x1024": ("SparseCoding",
                                dict(npixels=1024, nbasis=4096, phi_source="gabor"), 1024,
                                0.006, 5),
}
PAST_NUTS_DEPTH = 4
PAST_ITERS = (2, 10)
PAST_TILE = (8, 13, 4e-5)


def past_state(dist, n, seed):
    """(x, v, g, u, h_back, valid) on the card: logreg from its MAP plus
    N(0, the Laplace variances), else from the model's init."""
    import numpy as np

    from mjhmc_tpu_torch.models import LogisticRegression

    gen = torch.Generator().manual_seed(seed)
    if isinstance(dist, LogisticRegression):
        rng = np.random.default_rng(seed)
        x = (dist.map_estimate()[:, None]
             + np.sqrt(dist.laplace_var())[:, None] * rng.standard_normal((dist.ndims, n)))
        x = torch.as_tensor(x, dtype=torch.float32, device="cuda").contiguous()
    else:
        x = dist.init_x(gen, n, "cuda").contiguous()
    v = torch.randn(x.shape, generator=gen).to("cuda")
    u, g = dist.potential_and_grad(x)
    z = torch.zeros(n, device="cuda")
    return x, v, g.contiguous(), u.contiguous(), z, z.clone()


def matmul_ms(cm, spec, columns: int, reps: int = 20) -> float:
    """ms of one gradient's two contractions of ``spec`` over ``columns``
    columns as torch.matmul: (k, d)·(d, columns) then (d, k)·(k, columns),
    bf16 operands with f32 accumulation once at one bf16 pass, three times
    (hi·hi, hi·lo, lo·hi) at bf16x3, f32 at "highest"; best of ``reps``."""
    d, k = cm.mm_shape(spec)
    gen = torch.Generator(device="cuda").manual_seed(0)
    a1 = torch.randn((k, d), device="cuda", generator=gen)
    a2 = a1.t().contiguous()
    b1 = torch.randn((d, columns), device="cuda", generator=gen)
    b2 = torch.randn((k, columns), device="cuda", generator=gen)
    if spec.precision == "highest":
        pairs = [(a1, b1), (a2, b2)]
    else:
        pairs = []
        for a, b in ((a1, b1), (a2, b2)):
            ah, bh = a.bfloat16(), b.bfloat16()
            pairs.append((ah, bh))
            if spec.precision == "bf16x3":
                al, bl = (a - ah.float()).bfloat16(), (b - bh.float()).bfloat16()
                pairs += [(ah, bl), (al, bh)]
    fn = lambda: [torch.matmul(a, b) for a, b in pairs]  # noqa: E731
    fn()
    return min(_ms(fn, 1) for _ in range(reps))


def run_past_cases() -> dict:
    """{case: dict(out, run_ms, stream_ms, iters, matmul_ms)} of ``--only
    past``, the on-demand instances built first, all at once."""
    import concurrent.futures
    import math

    from mjhmc_tpu_torch import models
    from mjhmc_tpu_torch.ops import _build
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    cases = []
    for label, (name, kw, n, eps, m) in PAST_CASES.items():
        dist = getattr(models, name)(**kw)
        if eps is None:
            eps = round(0.25 * math.sqrt(float(dist.laplace_var().min())), 4)
        cases.append((label, dist, cm.energy_spec_for(dist), n, eps, m))
    keys = set()
    for _, _, spec, _, _, _ in cases:
        for body, _ in BODIES:
            rule = cm.nuts_mm_tile_rule(spec) if body == "nuts" else cm.mm_tile_rule(spec, body)
            keys.add(_build.mm_instance(cm.KERNEL_VARIANTS[body], spec.energy_id,
                                        *cm.mm_shape(spec), cm.PRECISIONS.index(spec.precision),
                                        rule.off, rule.chunk, rule.xg_off))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(_build.build_instance, keys))
    res = {}
    for label, dist, spec, n, eps, m in cases:
        st = past_state(dist, n, seed=4)
        for body, beta in BODIES:
            nuts = body == "nuts"
            depth = PAST_NUTS_DEPTH if nuts else m
            args = (spec, *st, 77, eps, beta)
            out = cm.cuda_mjhmc_mm_run(*args, PAST_ITERS[0], depth, variant=body)
            xs, ws, es, so = cm.cuda_mjhmc_mm_stream_run(*args, PAST_ITERS[0], 1, depth,
                                                         variant=body)
            digest = hashlib.sha256()
            for t in (*out, xs, ws, es, *so):
                digest.update(t.cpu().numpy().tobytes())
            iters = PAST_ITERS[1]
            res[f"past/{label}/{body}/{spec.precision}"] = dict(
                out=digest.hexdigest(), iters=iters, chains=n,
                run_ms=_ms(lambda: cm.cuda_mjhmc_mm_run(*args, iters, depth, variant=body),
                           iters),
                stream_ms=_ms(lambda: cm.cuda_mjhmc_mm_stream_run(*args, iters, 1, depth,
                                                                  variant=body), iters),
                matmul_ms=matmul_ms(cm, spec, 2 * n if body == "mjhmc" else n))
    label, dist, spec = cases[0][:3]
    n, depth, eps = PAST_TILE
    st = past_state(dist, n, seed=5)
    args = (spec, *st, 11, eps, 0.0)
    got = {}
    run_ms = _ms(lambda: got.update(o=cm.cuda_mjhmc_mm_run(*args, 1, depth, variant="nuts")), 1)
    stream_ms = _ms(lambda: got.update(s=cm.cuda_mjhmc_mm_stream_run(*args, 1, 1, depth,
                                                                      variant="nuts")), 1)
    digest = hashlib.sha256()
    for t in (*got["o"], *got["s"][:3], *got["s"][3]):
        digest.update(t.cpu().numpy().tobytes())
    res[f"past/{label}/nuts/{spec.precision}/{n} chains max_depth {depth}"] = dict(
        out=digest.hexdigest(), iters=1, chains=n, run_ms=run_ms, stream_ms=stream_ms,
        leaves=float(got["o"].evals.double().mean()), matmul_ms=matmul_ms(cm, spec, n))
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


#: the elementwise MJHMC, control and MALT cases: (config, body, chains,
#: branches) with branches "plain", "mass" (an inverse mass: gauss50d's
#: variances, else linspace(0.8, 1.25, d)) or "two_stage"; β 0.1 / 0.2 / 1.0
#: as BODIES, the preset's ε and M, EW_ITERS iterations timed (gauss50d 50)
_ZOO = ("funnel", "banana", "mog", "eight_schools", "eight_schools_nc")
EW_CASES = (
    ("rough_well", "mjhmc", 10_000, "plain"), ("rough_well", "mjhmc", 102_400, "plain"),
    ("rough_well", "mjhmc", 10_000, "mass"), ("rough_well", "mjhmc", 10_000, "two_stage"),
    ("rough_well", "malt", 10_000, "plain"), ("rough_well", "control", 10_000, "plain"),
    ("gauss50d", "mjhmc", 4096, "mass"), ("gauss50d", "mjhmc", 4096, "plain"),
    ("gauss50d", "malt", 4096, "mass"), ("gauss50d", "control", 4096, "mass"),
    ("rough_well", "control", 102_400, "plain"), ("rough_well", "control", 10_000, "two_stage"),
    ("gauss50d", "control", 4096, "plain"),
    *((c, body, None, kind) for c in _ZOO
      for body, kind in (("mjhmc", "plain"), ("mjhmc", "mass"), ("malt", "plain"),
                         ("control", "plain"), ("control", "mass"))),
)
EW_ITERS = 1000
EW_BETA = {"mjhmc": 0.1, "control": 0.2, "malt": 1.0}


def ew_case_args(cname, body, n, kind):
    """(spec, state, ε, β, M, options, chains, iterations timed) of an
    EW_CASES case."""
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    dist, cfg = ew_nuts_dist(cname)
    n = n or cfg.nbatch
    d = dist.ndims
    kw = dict(variant=body)
    if kind == "mass":
        kw["inv_mass"] = (tuple(float(v) for v in dist.analytic_var()) if cname == "gauss50d"
                          else tuple(float(m) for m in torch.linspace(0.8, 1.25, d)))
    elif kind == "two_stage":
        kw["integrator"] = "two_stage"
    iters = EW_ITERS // 5 if d == 50 else EW_ITERS
    return (cm.energy_spec_for(dist), ew_nuts_state(dist, n), cfg.epsilon, EW_BETA[body],
            cfg.num_leapfrog_steps, kw, n, iters)


def run_ew_cases() -> dict:
    """{ew case: dict(out=sha256 of the outputs, run_ms, stream_ms, iters)}
    of the elementwise MJHMC, control and MALT kernels (EW_CASES)."""
    from mjhmc_tpu_torch.bench import bench_cuda
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    res = {}
    # the headline as `python -m mjhmc_tpu_torch bench` measures it: credited
    # steps/s after 10,000 warm iterations, and the ms per iteration it implies
    cfg = BENCHMARK_CONFIGS["rough_well"]
    for nb in (10_000, 102_400):
        rate = bench_cuda(cfg, nbatch=nb)
        ms = nb * cfg.num_leapfrog_steps / rate * 1e3
        res[f"ew/rough_well/headline/{nb}"] = dict(out="", iters=10_000, rate=rate, run_ms=ms,
                                                   stream_ms=ms)
    for cname, body, n, kind in EW_CASES:
        spec, st, eps, beta, m, kw, n, iters = ew_case_args(cname, body, n, kind)
        args = (spec, *st, 77, eps, beta)
        out = cm.cuda_mjhmc_run(*args, 3, m, **kw)
        xs, ws, es, so = cm.cuda_mjhmc_stream_run(*args, 3, 1, m, **kw)
        digest = hashlib.sha256()
        for t in (*out, xs, ws, es, *so):
            digest.update(t.cpu().numpy().tobytes())
        res[f"ew/{cname}/{body}/{kind}/{n}"] = dict(
            out=digest.hexdigest(), iters=iters,
            run_ms=min(_ms(lambda: cm.cuda_mjhmc_run(*args, iters, m, **kw), iters)
                       for _ in range(3)),
            stream_ms=min(_ms(lambda: cm.cuda_mjhmc_stream_run(*args, iters, 1, m, **kw), iters)
                          for _ in range(3)))
    return res


#: the elementwise MJHMC, control and MALT PROF instances: (config, body,
#: branches, chains, iterations)
EW_BODY_PROFILES = (("rough_well", "mjhmc", "plain", 10_000, 200),
                    ("rough_well", "malt", "plain", 10_000, 200),
                    ("rough_well", "control", "plain", 10_000, 200),
                    ("funnel", "mjhmc", "plain", None, 200),
                    ("funnel", "malt", "plain", None, 200),
                    ("funnel", "control", "plain", None, 200),
                    ("gauss50d", "mjhmc", "mass", 4096, 50),
                    ("gauss50d", "control", "mass", 4096, 50))


def ew_body_breakdown(prof, names) -> dict:
    """An elementwise MJHMC or MALT PROF record ((n, phases) cycles of each
    phase of every chain, then MJHMC's counters) as each phase's share of
    all chains' cycles and its cycles per chain-iteration, and (MJHMC) the
    share of chain-iterations that began with an invalid cache and of those
    whose warp held any; the slowest chain's phases, and the spread of the
    chains' cycles (largest, 90th percentile, median, mean)."""
    p = prof.double()
    ncyc = names.index("other") + 1
    cyc = p[:, :ncyc]
    total = float(cyc.sum())
    rec = dict(chains=p.shape[0],
               share={nm: round(float(cyc[:, i].sum()) / total, 5)
                      for i, nm in enumerate(names[:ncyc])},
               cycles_by_phase={nm: float(cyc[:, i].mean()) for i, nm in enumerate(names[:ncyc])},
               slowest_chain={nm: float(cyc[int(cyc.sum(dim=1).argmax()), i])
                              for i, nm in enumerate(names[:ncyc])},
               chain_cycles_max=float(cyc.sum(dim=1).max()),
               chain_cycles_p90=float(cyc.sum(dim=1).quantile(0.9)),
               chain_cycles_p50=float(cyc.sum(dim=1).median()),
               chain_cycles_mean=float(cyc.sum(dim=1).mean()))
    rec.update({nm: float(p[:, ncyc + i].sum()) for i, nm in enumerate(names[ncyc:])})
    return rec


def run_ew_body_profiles() -> dict:
    """{"ew/config/body/branches": ew_body_breakdown(...) per chain-iteration
    with the PROF run's and the plain instance's ms per iteration} of
    EW_BODY_PROFILES, from the state two iterations in; {} where the
    checkout has no ``ew_profile``."""
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    if not hasattr(cm, "ew_profile"):
        return {}
    res = {}
    for cname, body, kind, n, iters in EW_BODY_PROFILES:
        if body not in cm.EW_PROF_PHASES:  # a checkout without this body's PROF instance
            continue
        spec, st, eps, beta, m, kw, n, _ = ew_case_args(cname, body, n, kind)
        o = cm.cuda_mjhmc_run(spec, *st, 5, eps, beta, 2, m, **kw)
        st = (o.x, o.v, o.grad, o.u, o.h_back, o.back_valid)
        mass = kw.get("inv_mass")
        cm.ew_profile(spec, body, *st, 98, eps, beta, 1, m, mass)  # the instance's first launch
        got = {}
        prof_ms = _ms(lambda: got.update(p=cm.ew_profile(spec, body, *st, 99, eps, beta, iters,
                                                         m, mass)), iters)
        run_ms = _ms(lambda: cm.cuda_mjhmc_run(spec, *st, 99, eps, beta, iters, m, **kw), iters)
        rec = ew_body_breakdown(got["p"], cm.EW_PROF_PHASES[body])
        for part in ("cycles_by_phase", "slowest_chain"):
            rec[part] = {k: v / iters for k, v in rec[part].items()}
        for k in cm.EW_PROF_PHASES[body][cm.EW_PROF_PHASES[body].index("other") + 1:]:
            rec[k] /= n * iters  # a share of the chain-iterations
        res[f"ew/{cname}/{body}/{kind}"] = dict(rec, prof_ms=prof_ms, run_ms=run_ms,
                                                iters=iters, eps=eps, beta=beta)
    return res


def ew_ptxas() -> list:
    """[kernel, registers, spill bytes stored] of every elementwise MJHMC,
    control, MALT and NUTS instance in the build's ``-Xptxas -v`` report (names
    demangled by ``c++filt`` where the machine has it)."""
    import re
    import shutil
    import subprocess

    from mjhmc_tpu_torch.ops import _build

    rows, name, spill = [], None, 0
    for ln in _build.build_log().splitlines():
        if m := re.search(r"Function properties for (\S+)", ln):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores", ln):
            spill = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            if re.search(r"mjhmc_kernel|malt_kernel|control_kernel|nuts_kernel", name):
                rows.append([name, int(m.group(1)), spill])
            name = None
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, nm in zip(rows, names):
                r[0] = nm
    return sorted({tuple(r) for r in rows})


#: chip_smoke.py phase 15's D=50 rough-well rows (fixed-uniform, 4,096
#: chains from seed 1, the rough_well preset's ε and M): (body, β, with the
#: mass M⁻¹ = linspace(0.8, 1.25, 50)), held after HOLD_ITERS iterations
HOLD_ROWS = (("mjhmc", 0.1, False), ("mjhmc", 0.1, True), ("malt", 1.0, True),
             ("control", 0.2, False), ("control", 0.2, True))
HOLD_ITERS = (3, 5)


def outside_fields(k, r, xs_k, xs_r) -> dict:
    """{field: (n,) bool}: the chains whose x, v, grad or u (``k`` against
    ``r``, RunOuts) or any emitted x (``xs_k`` against ``xs_r``) lie outside
    rtol 1e-4, atol 1e-4 of the field's largest value (chip_smoke.py's
    chains_within and stream_within)."""
    out = {}
    for f in ("x", "v", "grad", "u"):
        a, b = getattr(k, f).double(), getattr(r, f).double()
        ok = (a - b).abs() <= 1e-4 * float(b.abs().max()) + 1e-4 * b.abs()
        out[f] = ~(ok.all(dim=0) if ok.dim() == 2 else ok)
    tol = 1e-4 * float(xs_r.abs().max()) + 1e-4 * xs_r.abs()
    out["xs"] = ~((xs_k - xs_r).abs() <= tol).all(dim=1).all(dim=0)
    return out


def moved(body, xs, x0, x_end):
    """(iterations, n) bool: the chain's x moved in the iteration; MJHMC
    emits the pre-transition x, so its run's final ``x_end`` closes the last
    one, control and MALT the post-transition x after ``x0``."""
    traj = torch.cat([xs, x_end[None]]) if body == "mjhmc" else torch.cat([x0[None], xs])
    return (traj[1:] != traj[:-1]).any(dim=1)


def run_hold(iters=HOLD_ITERS, n=4096, device="cuda") -> dict:
    """{"hold/rough_well_d50/<body>/<plain|mass>/<iterations>": dict(kernel=
    {field: chains outside rtol 1e-4 of the plain version among those whose
    decisions agree}, decisions_differ, nudge={field: the same for the plain
    version against itself after a one-ulp nudge of x}, nudge_decisions_differ)}
    of HOLD_ROWS in fixed-uniform mode: what the kernel's and the plain
    version's roundings do to these chaotic chains, beside what one ulp of x
    does to the plain version alone."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.models import RoughWell
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    cfg, dist = BENCHMARK_CONFIGS["rough_well"], RoughWell(ndims=50)
    spec, m = cm.energy_spec_for(dist), cfg.num_leapfrog_steps
    mass = tuple(float(v) for v in torch.linspace(0.8, 1.25, 50))
    res = {}
    for body, beta, with_mass in HOLD_ROWS:
        kw = dict(variant=body, inv_mass=mass if with_mass else None)
        gen = torch.Generator().manual_seed(1)
        x = dist.init_x(gen, n, device)
        v = torch.randn(x.shape, generator=gen).to(device)
        if with_mass:
            v = v / torch.sqrt(torch.tensor(mass, device=device))[:, None]
        u, g = dist.potential_and_grad(x)
        z = torch.zeros(n, device=device)
        nudged = torch.nextafter(x, torch.full_like(x, float("inf")))
        for it in iters:
            args = (spec, x, v, g, u, z, z.clone(), 7, cfg.epsilon, beta)
            k = cm.cuda_mjhmc_run(*args, it, m, fixed_uniform=True, **kw)
            xs_k, _, es_k, so_k = cm.cuda_mjhmc_stream_run(*args, it, 1, m, fixed_uniform=True,
                                                           **kw)
            xs_r, _, es_r, r = cm.stream_reference(*args, it, 1, m, True, **kw)
            xs_n, _, es_n, r_n = cm.stream_reference(spec, nudged, *args[2:], it, 1, m, True,
                                                     **kw)
            base = moved(body, xs_r, x, r.x)
            same = (moved(body, xs_k, x, so_k.x) == base).all(dim=0)
            same_n = (moved(body, xs_n, nudged, r_n.x) == base).all(dim=0)
            if body == "mjhmc":
                same &= (k.evals == r.evals) & (es_k == es_r).all(dim=0)
                same_n &= (r_n.evals == r.evals) & (es_n == es_r).all(dim=0)
            bad = outside_fields(k, r, xs_k, xs_r)
            bad_n = outside_fields(r_n, r, xs_n, xs_r)
            res[f"hold/rough_well_d50/{body}/{'mass' if with_mass else 'plain'}/{it}"] = dict(
                kernel={f: int((b & same).sum()) for f, b in bad.items()},
                decisions_differ=int((~same).sum()),
                nudge={f: int((b & same_n).sum()) for f, b in bad_n.items()},
                nudge_decisions_differ=int((~same_n).sum()))
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
    ap.add_argument("--only", choices=("mm", "ew_nuts", "ew", "hold", "deep", "past"),
                    help="run one group of cases and its breakdowns: the matmul bodies, the "
                    "elementwise NUTS, the elementwise MJHMC, control and MALT, the D=50 "
                    "rough well held against the plain version (run_hold), the matmul "
                    "NUTS's deep trees (run_deep_cases), or the matmul engine past one "
                    "block's shared memory (run_past_cases)")
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
    res, prof = {}, {}
    if args.only in (None, "mm"):
        res.update(run_cases())
        prof.update(run_profiles())
    if args.only in (None, "ew_nuts"):
        res.update(run_ew_nuts_cases())
        prof.update(run_ew_profiles())
    if args.only in (None, "ew"):
        res.update(run_ew_cases())
        prof.update(run_ew_body_profiles())
        prof["ptxas"] = ew_ptxas()
    if args.only in (None, "hold"):
        prof.update(run_hold())
    if args.only in (None, "deep"):
        res.update(run_deep_cases())
    if args.only in (None, "past"):
        res.update(run_past_cases())
    res["profile"] = prof
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.tag}.json"), "w") as f:
        json.dump(res, f, indent=1)
    for case, rec in res.items():
        if case == "profile":
            for row in rec.pop("ptxas", ()):
                print(args.tag, "ptxas", *row)
            for key, p in rec.items():
                print(args.tag, "profile", key, json.dumps(p))
        else:
            print(args.tag, case, f"run {rec['run_ms']:.6g} stream {rec['stream_ms']:.6g}"
                  + (f" matmul {rec['matmul_ms']:.6g}" if "matmul_ms" in rec else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
