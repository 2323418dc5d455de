"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``mjhmc_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, checks the engine's
statistics against analytic, quadrature and plain-sampler variances, drives
the main paths once through the CLI (``sample --engine cuda`` on
``rough_well`` for the elementwise kernel, on ``product_of_t`` and
``sparse_coding`` for the matmul kernel, ``--sampler nuts`` on ``gauss2d``
for the NUTS kernel) and the roofline dossier (``bench_mfu.main`` with its
ceiling probes, at a reduced ``--steps``), and times the kernels beside
their plain versions. One line per phase; any failed check raises, so the
exit code is non-zero. The second to last line is the kernels' JSON record, the
last line ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import time

import torch

M, EPS, BETA = 10, 1.0, 0.1  # the rough_well preset
RUN_SRC = "mjhmc_tpu/ops/pallas_mjhmc.py:1451"
STREAM_SRC = "mjhmc_tpu/ops/pallas_mjhmc.py:1494"
MM_RUN_SRC = "mjhmc_tpu/ops/pallas_mjhmc.py:1265"
MM_STREAM_SRC = "mjhmc_tpu/ops/pallas_mjhmc.py:1596"
KERNEL_SRC = "mjhmc_tpu_torch/csrc/mjhmc_engine.cu"
MM_KERNEL_SRC = "mjhmc_tpu_torch/csrc/mjhmc_mm_engine.cu"
# matmul presets: iterations after which single chains are held at rtol 1e-4.
# Product of t's preset ε=0.2 makes the leapfrog unstable along W's stiffest
# direction near y = 0, so last-ulp differences of two f32 summation orders
# pass 1e-4 on many chains by iteration 5 (a one-ulp nudge of x does the same
# to the JAX kernel against itself); by iteration 3 they stay well inside.
MM_STATE_ITERS = {"product_of_t": 3, "sparse_coding": 5}
CEIL_SRC = "mjhmc_tpu_torch/csrc/ceilings.cu"
FMA_SRC = "bench_mfu.py:159"  # measure_vpu_ceiling's kernel
TC_SRC = "bench_mfu.py:94"  # measure_mxu_ceiling's kernel
NUTS_VARIANT = "nuts (_make_step_nuts, mjhmc_tpu/ops/pallas_mjhmc.py:1011)"
STUB_VARIANT = "stub_dots (MatmulEnergySpec._dot, mjhmc_tpu/ops/pallas_mjhmc.py:282)"
NUTS_EPS, NUTS_DEPTH = 0.3, 7  # the dossier's gauss2d NUTS row
CLI_NUTS_DEPTH = 8  # max_depth of `sample --sampler nuts` (at the config's eps)
#: the dossier's --steps here (its default is 20,000): the engine rows time
#: 2,000 and 10,000 jump iterations
DOSSIER_STEPS = 2000


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def assert_close(a, b, rtol, atol, what):
    err = (a.double() - b.double()).abs()
    bad = err > atol + rtol * b.double().abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} of {b.numel()} outside "
          f"rtol={rtol} atol={atol:.3g} (max abs err {float(err.max()):.3g})")
    return float(err.max())


def events_ms(fn) -> float:
    """Device milliseconds of ``fn()`` by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def initial_state(dist, n, seed):
    gen = torch.Generator().manual_seed(seed)
    x = dist.init_x(gen, n, "cuda")
    v = torch.randn(x.shape, generator=gen).cuda()
    u, g = dist.potential_and_grad(x)
    z = torch.zeros(n, device="cuda")
    return x, v, g, u, z, z.clone()


def ptxas_report(log: str):
    """(kernel, registers, spill bytes stored) per entry function of the
    nvcc ``-Xptxas -v`` log."""
    rows, name, spill = [], None, 0
    for ln in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", ln):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores", ln):
            spill = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            rows.append((name, int(m.group(1)), spill))
            name = None
    return rows


def run_cli(cli, argv, counters, attr="launches"):
    """Drive ``python -m mjhmc_tpu_torch`` in process with the wrappers'
    launch counters ``attr`` set to 0 just before; returns (record,
    launches, seconds)."""
    for fn in counters.values():
        setattr(fn, attr, 0)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: getattr(fn, attr) for k, fn in counters.items()}
    return json.loads(buf.getvalue().strip().splitlines()[-1]), launches, seconds


def mm_kernel_checks(cm, cname, cfg, dist, n):
    """Matmul kernel vs its plain version on the card at a preset's shape;
    returns (max |dx| of the run, of the stream)."""
    spec = cm.energy_spec_for(dist)
    eps, m = cfg.epsilon, cfg.num_leapfrog_steps
    ts = MM_STATE_ITERS[cname]
    args = (spec, *initial_state(dist, n, seed=1), 7, eps, BETA)
    k100 = cm.cuda_mjhmc_mm_run(*args, 100, m, fixed_uniform=True)
    r100 = cm.mjhmc_run_reference(*args, 100, m, fixed_uniform=True)
    check(bool((k100.evals == m * 100 + m).all()) and bool((r100.evals == m * 100 + m).all()),
          f"{cname}: fixed-uniform evals must be exactly M*100 + M on every chain")
    w_rel = abs(float(k100.w.double().sum() / r100.w.double().sum()) - 1)
    if cname == "sparse_coding":
        assert_close(k100.w.sum(), r100.w.sum(), 1e-4, 0.0, f"{cname} sum of w after 100")
    kt = cm.cuda_mjhmc_mm_run(*args, ts, m, fixed_uniform=True)
    rt = cm.mjhmc_run_reference(*args, ts, m, fixed_uniform=True)
    check(torch.equal(kt.evals, rt.evals) and torch.equal(kt.back_valid, rt.back_valid),
          f"{cname}: counters or cache flags differ after {ts}")
    assert_close(kt.w.sum(), rt.w.sum(), 1e-4, 0.0, f"{cname} sum of w after {ts}")
    errs = {f: assert_close(getattr(kt, f), getattr(rt, f), 1e-4,
                            1e-4 * float(getattr(rt, f).abs().max()), f"{cname} {f} after {ts}")
            for f in ("x", "v", "grad", "u", "h_back")}
    run_err = errs["x"]
    for name in ("wx", "wx2"):
        a, b = getattr(kt, name).double().sum(1), getattr(rt, name).double().sum(1)
        assert_close(a, b, 1e-4, 1e-4 * float(b.abs().max()), f"{cname} sum of {name} after {ts}")
    k5 = cm.cuda_mjhmc_mm_run(*args, 5, m, fixed_uniform=True)
    r5 = cm.mjhmc_run_reference(*args, 5, m, fixed_uniform=True)
    check(torch.equal(k5.evals, r5.evals), f"{cname}: counters differ after 5")
    tol = 1e-4 * r5.x.abs().max() + 1e-4 * r5.x.abs()
    share5 = float(((k5.x - r5.x).abs() <= tol).all(dim=0).double().mean())
    xs_k, ws_k, es_k, so_k = cm.cuda_mjhmc_mm_stream_run(*args, 5, 1, m, fixed_uniform=True)
    xs_r, ws_r, es_r, _ = cm.mjhmc_stream_reference(*args, 5, 1, m, fixed_uniform=True)
    check(torch.equal(es_k[-1], so_k.evals), f"{cname}: stream es[-1] must equal evals")
    check(torch.equal(es_k, es_r), f"{cname}: stream es must equal the plain version's")
    check(xs_k.shape == (5, dist.ndims, n), f"{cname}: stream xs shape {tuple(xs_k.shape)}")
    stream_err = assert_close(xs_k[:ts], xs_r[:ts], 1e-4, 1e-4 * float(xs_r.abs().max()),
                              f"{cname} stream xs")
    assert_close(ws_k.sum(1), ws_r.sum(1), 1e-4, 0.0, f"{cname} stream sum of ws")
    phase("3 mm fixed-uniform", f"{cname} ({n} chains, eps {eps}, M {m}): evals exact "
          f"(M*100 + M); sum of w after 100 rel diff {w_rel:.3g}; after {ts}: x,v,g,u,h_back "
          f"rtol 1e-4 on every chain (max|dx| {run_err:.3g}), sums of w, wx, wx2 rtol 1e-4; "
          f"after 5: x within rtol 1e-4 on {share5:.4f} of chains; stream es exact, "
          f"xs max|dx| {stream_err:.3g}")
    return run_err, stream_err


def mm_philox_checks(cm, cname, cfg, dist, n):
    spec = cm.energy_spec_for(dist)
    m = cfg.num_leapfrog_steps
    args = (spec, *initial_state(dist, n, seed=2), 12345, cfg.epsilon, BETA)
    kp = cm.cuda_mjhmc_mm_run(*args, 5, m)
    rp = cm.mjhmc_run_reference(*args, 5, m)
    same = float((kp.evals == rp.evals).double().mean())
    refreshed = int((rp.evals > 6 * m).sum())
    check(same >= 0.999, f"{cname}: Philox-mode counters match on {same:.5f} of chains (< 0.999)")
    check(refreshed >= 10, f"{cname}: only {refreshed} chains refreshed: draws not exercised")
    # a refreshed chain's v is 128 (36) Box-Muller normals from words 1..2d
    ts = MM_STATE_ITERS[cname]
    kt, rt = cm.cuda_mjhmc_mm_run(*args, ts, m), cm.mjhmc_run_reference(*args, ts, m)
    tol = 1e-4 * rt.v.abs().max() + 1e-4 * rt.v.abs()
    v_same = float(((kt.v - rt.v).abs() <= tol).all(dim=0).double().mean())
    check(v_same >= 0.999, f"{cname}: Philox-mode v within rtol 1e-4 on {v_same:.5f} (< 0.999)")
    phase("4 mm philox", f"{cname}: counters equal on {same:.5f} of chains, {refreshed} "
          f"chains refreshed; v after {ts} within rtol 1e-4 on {v_same:.5f} of chains")


def mm_stats(cm, cname, dist, n):
    """Dwell-weighted variances through CudaMJHMC: product of t against the
    analytic values, sparse coding against the plain sampler, with the
    settings tests/test_pallas_engine.py:300-369 hold the TPU engine to."""
    from mjhmc_tpu_torch.samplers import MarkovJumpHMC

    eps, m = (0.12, 5) if cname == "product_of_t" else (0.02, 5)
    eng = cm.CudaMJHMC(dist, epsilon=eps, beta=BETA, num_leapfrog_steps=m, nbatch=n,
                       seed=0, device="cuda")
    eng.run(400)
    xs, ws = eng.sample(600)
    wsum = ws.double().sum()
    mean = (ws[:, None, :] * xs).double().sum(dim=(0, 2)) / wsum
    var = (ws[:, None, :] * xs * xs).double().sum(dim=(0, 2)) / wsum - mean**2
    _, acc_var = cm.CudaMJHMC.moments(eng.last_out)
    assert_close(acc_var.double(), var, 1e-3, 0.0, f"{cname} accumulator var")
    assert_close(ws.sum(dim=0), eng.last_out.w, 1e-5, 0.0, f"{cname} sum of ws vs w")
    extra = eng.evals - m * 1000
    check(bool((extra >= 0).all()) and bool((extra % m == 0).all()),
          f"{cname}: evals - M*steps must be a non-negative multiple of M")
    dwell_e = float(wsum) / ws.numel()
    if cname == "product_of_t":
        target = dist.analytic_var().double().cuda()
        ratio = (var / target).median()
        check(abs(float(ratio) - 1) < 0.15, f"{cname}: median var/analytic {float(ratio):.4f}")
        phase("5 mm stats", f"{cname} ({n} chains, eps {eps}, M {m}, 400 + 600): median "
              f"var/analytic {float(ratio):.5f}; mean dwell {dwell_e:.5f}; sum(ws) == w")
        return
    ref = MarkovJumpHMC(dist, epsilon=eps, beta=BETA, num_leapfrog_steps=m, nbatch=2048,
                        seed=1, device="cuda")
    ref.burn_in(400)
    rout = ref.sample(600)
    rw = rout["dwell"].double()
    rx = rout["x"].double()
    rmean = (rw[:, None, :] * rx).sum(dim=(0, 2)) / rw.sum()
    rvar = (rw[:, None, :] * rx * rx).sum(dim=(0, 2)) / rw.sum() - rmean**2
    ratio = float((var / rvar).median())
    dwell_r = float(rw.mean())
    check(abs(ratio - 1) < 0.15, f"{cname}: median var ratio engine/plain {ratio:.4f}")
    check(abs(dwell_e - dwell_r) < 0.05 * dwell_r,
          f"{cname}: mean dwell {dwell_e:.5f} vs plain sampler {dwell_r:.5f}")
    phase("5 mm stats", f"{cname} ({n} chains vs 2048 in the plain sampler, eps {eps}, M {m}, "
          f"400 + 600): median var ratio {ratio:.5f}; mean dwell {dwell_e:.5f} vs "
          f"{dwell_r:.5f}; sum(ws) == w")


def ceiling_checks(ce):
    """Both ceiling probes vs their plain versions at the dossier's inputs;
    returns (fma max|err|, fma plain ms/iteration, tc max|err|, tc plain
    ms/iteration at depth 128)."""
    import numpy as np

    from mjhmc_tpu_torch.bench_mfu import TC_DEPTHS

    rng = np.random.default_rng(1)
    a = torch.as_tensor(0.5 + 0.01 * rng.random((256, 1024)), dtype=torch.float32).cuda()
    b = torch.as_tensor(0.1 * rng.random((256, 1024)), dtype=torch.float32).cuda()
    fma_err = max(assert_close(ce.fma_chain(a, b, 50, sin), ce.fma_chain_reference(a, b, 50, sin),
                               1e-5, 0.0, f"fma_chain (sin={sin}) after 50")
                  for sin in (False, True))
    fma_plain_ms = events_ms(lambda: ce.fma_chain_reference(a, b, 50)) / 50
    tc_err, rel = 0.0, []
    for depth in TC_DEPTHS:
        lanes = ce.tc_chain_lanes(depth)
        rng = np.random.default_rng(0)
        w = torch.as_tensor(rng.normal(size=(depth, depth)) / np.sqrt(depth),
                            dtype=torch.float32).cuda()
        bb = torch.as_tensor(rng.normal(size=(depth, lanes)), dtype=torch.float32).cuda()
        for iters in (1, 3):
            k, r = ce.tc_chain(w, bb, iters), ce.tc_chain_reference(w, bb, iters)
            top = float(r.abs().max())
            err = assert_close(k, r, 0.0, 1e-3 * top, f"tc_chain depth {depth} after {iters}")
            tc_err = max(tc_err, err)
            rel.append(err / top)
    tc_plain_ms = events_ms(lambda: ce.tc_chain_reference(w, bb, 3)) / 3
    phase("8 ceilings", f"fma_chain (256, 1024) x 4 chains, both branches, 50 iterations: "
          f"rtol 1e-5 (max|err| {fma_err:.3g}); tc_chain at depths {list(TC_DEPTHS)}, 1 and 3 "
          f"iterations: within 1e-3 of the max (largest {max(rel):.3g} of the max)")
    return fma_err, fma_plain_ms, tc_err, tc_plain_ms


def round_directions(cm, seed, n, iters, depth):
    """(iters, depth, n) bool: round jj of iteration t goes right, from the
    NUTS kernel's Philox words (tag 2, word 0)."""
    return torch.stack([torch.stack([
        cm._uniform_of(cm.philox_block(seed, n, t, jj, cm.TAG_NUTS_ROUND, "cuda")[0]) < 0.5
        for jj in range(depth)]) for t in range(iters)])


def chains_within(k, r, fields=("x", "v", "grad", "u")):
    """(n,) bool: the chain's fields all lie within rtol 1e-4 (atol 1e-4 of
    each field's largest value) of the plain version's."""
    ok = None
    for f in fields:
        a, b = getattr(k, f).double(), getattr(r, f).double()
        good = (a - b).abs() <= 1e-4 * float(b.abs().max()) + 1e-4 * b.abs()
        good = good.all(dim=0) if good.dim() == 2 else good
        ok = good if ok is None else ok & good
    return ok


def nuts_checks(cm):
    """The NUTS run and stream kernels vs their plain version, in
    fixed-uniform mode and in Philox mode, at the main path's shapes (the
    dossier's gauss2d row and the CLI's, both at 10,240 chains), on the
    rough well and on the D=50 instances; returns (max|dx| run, stream)."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.models import Gaussian, RoughWell

    g2 = Gaussian(ndims=2, log_conditioning=2.0)
    cases = (  # name, distribution, eps, max_depth, chains, fixed-uniform iterations
        ("gauss2d", g2, NUTS_EPS, NUTS_DEPTH, 10_240, 5),
        ("gauss2d", g2, BENCHMARK_CONFIGS["gauss2d"].epsilon, CLI_NUTS_DEPTH, 10_240, 5),
        ("rough_well", RoughWell(), 1.0, NUTS_DEPTH, 4096, 1),
        # the D=50 instance as `sample --config gauss50d --sampler nuts` runs it
        ("gauss50d", Gaussian(ndims=50, log_conditioning=4.0),
         BENCHMARK_CONFIGS["gauss50d"].epsilon, CLI_NUTS_DEPTH, 4096, 5),
    )
    run_err = stream_err = 0.0
    for cname, dist, eps, depth, n, iters in cases:
        spec = cm.energy_spec_for(dist)
        what = f"NUTS {cname} ({n} chains, eps {eps}, max_depth {depth})"
        nuts = dict(variant="nuts")

        # fixed-uniform: every round goes right
        args = (spec, *initial_state(dist, n, seed=1), 7, eps, 0.0)
        k = cm.cuda_mjhmc_run(*args, iters, depth, fixed_uniform=True, **nuts)
        xs_k, ws_k, es_k, so_k = cm.cuda_mjhmc_stream_run(*args, iters, 1, depth,
                                                          fixed_uniform=True, **nuts)
        xs_r, _, es_r, r = cm.nuts_stream_reference(*args, iters, 1, depth, fixed_uniform=True)
        check(torch.equal(k.evals, r.evals), f"{what}: fixed-uniform leaf counts differ")
        check(torch.equal(es_k, es_r) and torch.equal(es_k[-1], so_k.evals),
              f"{what}: stream es differ from the plain version's or es[-1] != evals")
        check(bool((k.w == iters).all()) and bool((r.w == iters).all())
              and bool((ws_k == 1).all()), f"{what}: w must equal the number of steps, ws 1")
        for f in ("x", "v", "grad", "u"):
            err = assert_close(getattr(k, f), getattr(r, f), 1e-4,
                               1e-4 * float(getattr(r, f).abs().max()), f"{what} {f}")
            run_err = max(run_err, err) if f == "x" else run_err
        stream_err = max(stream_err, assert_close(xs_k, xs_r, 1e-4, 1e-4 * float(xs_r.abs().max()),
                                                  f"{what} stream xs"))
        leaves = float(r.evals.double().mean()) / iters
        phase("9 nuts fixed-uniform", f"{what}, {iters} iterations, {leaves:.4g} "
              f"leaves/iteration: leaf counts and stream es exact; w == steps, ws == 1; "
              f"x,v,g,u and stream xs rtol 1e-4 on every chain")

        # Philox mode: rounds go both ways; every iteration's tree compared
        seed = 12345
        args = (spec, *initial_state(dist, n, seed=2), seed, eps, 0.0)
        kp = cm.cuda_mjhmc_run(*args, 5, depth, **nuts)
        xs_k, _, es_k, _ = cm.cuda_mjhmc_stream_run(*args, 5, 1, depth, **nuts)
        xs_r, _, es_r, rp = cm.nuts_stream_reference(*args, 5, 1, depth)
        counts = (kp.evals == rp.evals) & (es_k == es_r).all(dim=0)
        tol = 1e-4 * float(xs_r.abs().max()) + 1e-4 * xs_r.abs()
        agree = counts & chains_within(kp, rp) & ((xs_k - xs_r).abs() <= tol).all(dim=1).all(dim=0)
        identical = torch.ones_like(agree)
        for f in ("x", "v", "grad", "u"):
            eq = getattr(kp, f) == getattr(rp, f)
            identical &= eq.all(dim=0) if eq.dim() == 2 else eq
        same, share_agree = float(counts.double().mean()), float(agree.double().mean())
        check(same >= 0.999, f"{what}: Philox-mode leaf counts equal on {same:.5f} (< 0.999)")
        check(share_agree >= 0.999,
              f"{what}: Philox-mode x,v,g,u and xs within rtol 1e-4 on {share_agree:.5f} (< 0.999)")
        # rounds each iteration began, and their directions; a chain whose
        # every emitted x agrees with the plain version's took the same trees
        per_iter = torch.diff(es_r.long(), dim=0, prepend=torch.zeros_like(es_r[:1]).long())
        started = torch.floor(torch.log2(per_iter.double())).long() + 1
        right = round_directions(cm, seed, n, 5, depth)
        live = torch.arange(depth, device="cuda")[None, :, None] < started[:, None, :]
        both = ((right & live).any(dim=1) & (~right & live).any(dim=1)).any(dim=0) & agree
        share = float(both.double().mean())
        check(share > 0.01, f"{what}: only {share:.4f} of chains built rounds both ways "
              "and agree with the plain version")
        phase("10 nuts philox", f"{what}, 5 iterations: leaf counts and stream es equal on "
              f"{same:.5f} of chains; x,v,g,u and every emitted x within rtol 1e-4 on "
              f"{share_agree:.5f} (bit-identical on {float(identical.double().mean()):.5f}); "
              f"{share:.4f} of chains built rounds in both directions and agree")
    return run_err, stream_err


def nuts_timing_and_stats(cm, card):
    """CudaNUTS on gauss2d at the dossier's settings: variances within 5% of
    [1, 100]; returns (run, stream, plain run, plain stream) ms/iteration."""
    from mjhmc_tpu_torch.models import Gaussian

    dist = Gaussian(ndims=2, log_conditioning=2.0)
    eng = cm.CudaNUTS(dist, epsilon=NUTS_EPS, num_leapfrog_steps=NUTS_DEPTH, nbatch=10_240,
                      seed=3)
    eng.run(100)
    run_ms = events_ms(lambda: eng.run(1000)) / 1000
    out = eng.last_out
    check(bool((out.w == 1000).all()), "NUTS: w must equal the number of steps")
    _, var = cm.CudaMJHMC.moments(out)
    ratio = var.double() / torch.tensor([1.0, 100.0], dtype=torch.float64, device="cuda")
    check(bool(((ratio - 1).abs() < 0.05).all()), f"NUTS gauss2d var {var.tolist()}: outside 5%")
    leaves = float(out.evals.double().mean()) / 1000
    stream_ms = events_ms(lambda: eng.sample(1000)) / 1000
    args = (cm.energy_spec_for(dist), *initial_state(dist, 10_240, seed=5), 99, NUTS_EPS, 0.0)
    cm.nuts_run_reference(*args, 1, NUTS_DEPTH)
    plain_ms = events_ms(lambda: cm.nuts_run_reference(*args, 3, NUTS_DEPTH)) / 3
    plain_stream_ms = events_ms(lambda: cm.nuts_stream_reference(*args, 3, 1, NUTS_DEPTH)) / 3
    phase("11 nuts stats", f"CudaNUTS gauss2d (10,240 chains, eps {NUTS_EPS}, max_depth "
          f"{NUTS_DEPTH}, 100 + 1000): var/analytic {[round(x, 5) for x in ratio.tolist()]}; "
          f"{leaves:.5g} leaves/iteration")
    phase("11 nuts stats", f"NUTS run kernel {run_ms:.6g} ms/iteration "
          f"({leaves * 10_240 / run_ms * 1e3:.6g} leaves/s), stream {stream_ms:.6g}; plain "
          f"version run {plain_ms:.6g}, stream {plain_stream_ms:.6g} ms/iteration [{card}]")
    return run_ms, stream_ms, plain_ms, plain_stream_ms


def stub_checks(cm):
    """The stubbed product-of-t kernel vs its plain version (fixed-uniform);
    returns (max|dx|, plain ms/iteration at the dossier's settings)."""
    from mjhmc_tpu_torch.models import ProductOfT

    pot = ProductOfT()
    spec = cm.ProductOfTSpec(pot, stub_dots=True)
    args = (spec, *initial_state(pot, 4096, seed=1), 7, 0.12, BETA)
    k = cm.cuda_mjhmc_mm_run(*args, 3, 10, fixed_uniform=True)
    r = cm.mjhmc_run_reference(*args, 3, 10, fixed_uniform=True)
    check(torch.equal(k.evals, r.evals), "stubbed product_of_t: counters differ after 3")
    err = {f: assert_close(getattr(k, f), getattr(r, f), 1e-4, 1e-4 * float(getattr(r, f).abs().max()),
                           f"stubbed product_of_t {f} after 3") for f in ("x", "v", "grad", "u")}
    plain_ms = events_ms(lambda: cm.mjhmc_run_reference(*args, 3, 10)) / 3
    phase("12 stub", f"stubbed product_of_t kernel (4096 chains, eps 0.12, M 10): evals exact, "
          f"x,v,g,u rtol 1e-4 after 3 (max|dx| {err['x']:.3g})")
    return err["x"], plain_ms


def run_dossier(cm, ce, card):
    """The roofline dossier in process at DOSSIER_STEPS, its launch counts
    set to 0 just before; every mfu must lie in (0, 1.05]."""
    from mjhmc_tpu_torch import bench_mfu

    counted = [(ce.fma_chain, "launches"), (ce.tc_chain, "launches"),
               (cm.cuda_mjhmc_mm_run, "stub_launches"), (cm.cuda_mjhmc_run, "nuts_launches")]
    for fn, attr in counted:
        setattr(fn, attr, 0)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench_mfu.main(["--steps", str(DOSSIER_STEPS)])
    seconds = time.perf_counter() - t0
    launches = {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in counted}
    check(rc == 0, f"bench_mfu.main returned {rc}")
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.strip()]
    head, rows = lines[0], lines[1:]
    ceil = head["ceilings"]
    names = [r["engine"] for r in rows]
    want = ["mjhmc_roughwell_elementwise", "mjhmc_product_of_t[full]",
            "mjhmc_product_of_t[dots=stubbed]", "mjhmc_product_of_t[ablation_verdict]",
            "mjhmc_sparse_coding[fp32]", "nuts_gauss2d_elementwise"]
    check(names == want, f"dossier rows {names}")
    check(all(v > 0 for v in launches.values()), f"dossier kernels not launched: {launches}")
    for r in rows:
        flops = (r.get("achieved_matmul_flops_per_s") or r.get("achieved_flops_per_s")
                 or r.get("achieved_matmul_flops_per_s_executed"))
        if flops:
            check("mfu" in r and 0 < r["mfu"] <= 1.05, f"{r['engine']}: mfu {r.get('mfu')}")
    probes = ceil["probes"]
    phase("14 dossier", f"--steps {DOSSIER_STEPS} (the default is 20,000), {seconds:.4g} s host "
          f"clock; launches {launches}")
    phase("14 dossier", "ceilings: " + json.dumps(
        {k: v for k, v in ceil.items() if k != "probes"}) + f" [{card}]")
    phase("14 dossier", "probe iterations (lo, hi) and lanes: " + json.dumps(
        {k: {kk: v[kk] for kk in ("iters", "lanes", "elements") if kk in v}
         for k, v in probes.items()}))
    for r in rows:
        phase("14 dossier", json.dumps(r))
    stub_row = rows[2]
    return {"launches": launches, "fma_ms": probes["fp32_fma"]["s_per_iter"] * 1e3,
            "tc_ms": probes["tc_depth_128"]["s_per_iter"] * 1e3,
            "stub_ms": 4096 / stub_row["iterations_per_s"] * 1e3}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # ---- 1. device -------------------------------------------------------
    from mjhmc_tpu_torch.bench import bench_cuda, gpu_name_and_power_limit
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.models import Gaussian, ProductOfT, RoughWell, SparseCoding
    from mjhmc_tpu_torch.ops import _build
    from mjhmc_tpu_torch.ops import ceilings as ce
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    name, limit = gpu_name_and_power_limit()
    card = f"{name} @ {limit}"
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"{name}, {limit}")  # as nvidia-smi --query-gpu=name,power.limit prints it
    phase("1 device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{[ln for ln in nvcc if 'release' in ln][0]}")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    phase("2 build", f"{time.perf_counter() - t0:.1f} s -> {_build.library_path().name}")
    for kernel, regs, spill in ptxas_report(_build.build_log()):
        phase("2 build", f"ptxas {kernel}: {regs} registers, {spill} bytes spill stores")

    # ---- 3. kernels vs plain version, fixed-uniform mode -----------------
    rw = RoughWell()
    spec = cm.energy_spec_for(rw)
    st = initial_state(rw, 4096, seed=1)
    args = (spec, *st, 7, EPS, BETA)
    k100 = cm.cuda_mjhmc_run(*args, 100, M, fixed_uniform=True)
    r100 = cm.mjhmc_run_reference(*args, 100, M, fixed_uniform=True)
    check(bool((k100.evals == M * 100 + M).all()) and bool((r100.evals == M * 100 + M).all()),
          "fixed-uniform evals must be exactly M*100 + M on every chain")
    # Σw over all chains: single chains may drift apart over 100 chaotic
    # iterations (x/scale2 reaches ~100 rad, where sin turns ulps into states)
    assert_close(k100.w.sum(), r100.w.sum(), 1e-4, 0.0, "sum of w after 100 iterations")
    w_rel = float(((k100.w - r100.w).abs() / r100.w).max())
    k5 = cm.cuda_mjhmc_run(*args, 5, M, fixed_uniform=True)
    r5 = cm.mjhmc_run_reference(*args, 5, M, fixed_uniform=True)
    atol = 1e-4 * float(r5.x.abs().max())
    run_err = assert_close(k5.x, r5.x, 1e-4, atol, "x after 5")
    for fname in ("v", "grad", "u"):
        assert_close(getattr(k5, fname), getattr(r5, fname), 1e-4, atol, f"{fname} after 5")
    xs_k, ws_k, es_k, so_k = cm.cuda_mjhmc_stream_run(*args, 5, 1, M, fixed_uniform=True)
    xs_r, ws_r, es_r, _ = cm.mjhmc_stream_reference(*args, 5, 1, M, fixed_uniform=True)
    check(torch.equal(es_k[-1], so_k.evals), "stream es[-1] must equal evals")
    check(torch.equal(es_k, es_r), "stream es must equal the plain version's")
    stream_err = assert_close(xs_k, xs_r, 1e-4, atol, "stream xs")
    assert_close(ws_k, ws_r, 1e-4, 0.0, "stream ws")
    phase("3 fixed-uniform", f"evals exact; sum of w rtol 1e-4 (largest per-chain "
          f"relative w difference {w_rel:.3g}); x,v,g,u rtol 1e-4 atol {atol:.3g}; "
          f"max|dx| run {run_err:.3g} stream {stream_err:.3g}")

    # the D=50 instance (gauss50d preset: eps 0.1, M 10)
    g50 = Gaussian(ndims=50, log_conditioning=4.0)
    spec50 = cm.energy_spec_for(g50)
    args50 = (spec50, *initial_state(g50, 4096, seed=6), 7, 0.1, BETA)
    k50 = cm.cuda_mjhmc_run(*args50, 5, M, fixed_uniform=True)
    r50 = cm.mjhmc_run_reference(*args50, 5, M, fixed_uniform=True)
    check(torch.equal(k50.evals, r50.evals), "gauss50d fixed-uniform evals differ")
    atol50 = 1e-4 * float(r50.x.abs().max())
    for fname in ("x", "v", "grad", "u", "wx2"):
        assert_close(getattr(k50, fname), getattr(r50, fname), 1e-4, atol50, f"gauss50d {fname}")
    phase("3 fixed-uniform", f"gauss50d (D=50): evals exact; x,v,g,u,wx2 rtol 1e-4 atol {atol50:.3g}")

    # the matmul kernel at the product_of_t and sparse_coding presets
    mm_cases = []
    for cname in ("product_of_t", "sparse_coding"):
        cfg = BENCHMARK_CONFIGS[cname]
        dist = cfg.make_distribution()
        mm_cases.append((cname, cfg, dist, cfg.nbatch))
    mm_err = {c[0]: mm_kernel_checks(cm, *c) for c in mm_cases}

    # ---- 4. Philox mode, identical draws ---------------------------------
    st = initial_state(rw, 10_000, seed=2)
    args = (spec, *st, 12345, EPS, BETA)
    kp = cm.cuda_mjhmc_run(*args, 5, M)
    rp = cm.mjhmc_run_reference(*args, 5, M)
    same = float((kp.evals == rp.evals).double().mean())
    rebuilt = float((rp.evals > 6 * M).double().mean())
    check(same >= 0.999, f"Philox-mode counters match on {same:.5f} of chains (< 0.999)")
    check(rebuilt > 0.01, f"only {rebuilt:.4f} of chains refreshed: draws not exercised")
    phase("4 philox", f"counters equal on {same:.5f} of chains; "
          f"{rebuilt:.3f} of chains refreshed at least once")
    args50 = (spec50, *initial_state(g50, 4096, seed=7), 12345, 0.1, BETA)
    same50 = float((cm.cuda_mjhmc_run(*args50, 5, M).evals
                    == cm.mjhmc_run_reference(*args50, 5, M).evals).double().mean())
    check(same50 >= 0.999, f"gauss50d Philox-mode counters match on {same50:.5f} (< 0.999)")
    phase("4 philox", f"gauss50d (D=50): counters equal on {same50:.5f} of chains")
    for c in mm_cases:
        mm_philox_checks(cm, *c)

    # ---- 5. statistics through CudaMJHMC ---------------------------------
    for cname in ("gauss2d", "rough_well"):
        cfg = BENCHMARK_CONFIGS[cname]
        dist = cfg.make_distribution()
        eng = cm.CudaMJHMC(dist, epsilon=cfg.epsilon, beta=cfg.beta,
                           num_leapfrog_steps=cfg.num_leapfrog_steps,
                           nbatch=10_240, seed=3, device="cuda")
        eng.run(200)
        xs, ws = eng.sample(2000)
        m = cfg.num_leapfrog_steps
        wsum = ws.double().sum()
        mean = (ws[:, None, :] * xs).double().sum(dim=(0, 2)) / wsum
        var = (ws[:, None, :] * xs * xs).double().sum(dim=(0, 2)) / wsum - mean**2
        target = dist.analytic_var().double().cuda()
        ratio = var / target
        check(bool(((ratio - 1).abs() < 0.05).all()), f"{cname} var {var.tolist()} "
              f"vs {target.tolist()}: outside 5%")
        _, acc_var = cm.CudaMJHMC.moments(eng.last_out)
        assert_close(acc_var.double(), var, 1e-3, 0.0, f"{cname} accumulator var")
        extra = eng.evals - m * 2200
        check(bool((extra >= 0).all()) and bool((extra % m == 0).all()),
              f"{cname}: evals - M*steps must be a non-negative multiple of M")
        assert_close(ws.sum(dim=0), eng.last_out.w, 1e-5, 0.0, f"{cname} sum of ws vs w")
        phase("5 stats", f"{cname}: var/target {[round(r, 5) for r in ratio.tolist()]}; "
              f"evals exact multiples of M; sum(ws) == w")
    mm_stats(cm, "product_of_t", ProductOfT(), 4096)
    mm_stats(cm, "sparse_coding", SparseCoding(), 8192)

    # ---- 6. the CLI paths (main paths; launches counted here only) -------
    from mjhmc_tpu_torch.__main__ import main as cli

    counters = {"run": cm.cuda_mjhmc_run, "stream": cm.cuda_mjhmc_stream_run,
                "mm_run": cm.cuda_mjhmc_mm_run, "mm_stream": cm.cuda_mjhmc_mm_stream_run}
    rec, rw_launches, cli_s = run_cli(cli, ["sample", "--config", "rough_well", "--engine",
                                            "cuda", "--steps", "1000", "--burn", "500"],
                                      counters)
    check(rw_launches["run"] > 0 and rw_launches["stream"] > 0,
          f"kernels not launched: {rw_launches}")
    target = RoughWell().analytic_var().tolist()
    check(all(abs(v / t - 1) < 0.05 for v, t in zip(rec["var"], target)),
          f"CLI var {rec['var']} vs {target}: outside 5%")
    check(rec["chains"] == 10_000 and rec["ess"] > 0, f"bad CLI record {rec}")
    phase("6 cli", f"{json.dumps(rec)}; launches {rw_launches}; {cli_s:.4g} s host clock")

    mm_launches = {"mm_run": 0, "mm_stream": 0}
    mm_cli_s = {}
    mm_cli = {"product_of_t": (500, 1000), "sparse_coding": (200, 200)}  # burn, steps
    for cname, (burn, steps) in mm_cli.items():
        cfg = BENCHMARK_CONFIGS[cname]
        rec, launches, mm_cli_s[cname] = run_cli(
            cli, ["sample", "--config", cname, "--engine", "cuda", "--burn", str(burn),
                  "--steps", str(steps)], counters)
        check(launches["mm_run"] > 0 and launches["mm_stream"] > 0,
              f"{cname}: matmul kernels not launched: {launches}")
        for k in mm_launches:
            mm_launches[k] += launches[k]
        m, n = cfg.num_leapfrog_steps, cfg.nbatch
        ge = rec["grad_evals"]
        check(rec["chains"] == n and rec["steps"] == steps and rec["ess"] > 0
              and ge >= m * (burn + steps) * n and ge % m == 0
              and all(v > 0 and v == v for v in rec["var"])
              and all(abs(x) < 1e6 for x in rec["mean"]), f"{cname}: bad CLI record {rec}")
        phase("6 cli", f"{cname}: {json.dumps(rec)}; launches {launches}; "
              f"{mm_cli_s[cname]:.4g} s host clock")

    # ---- 7. timings ------------------------------------------------------
    cfg = BENCHMARK_CONFIGS["rough_well"]
    rate_10k = bench_cuda(cfg, nbatch=10_000)
    rate_102k = bench_cuda(cfg, nbatch=102_400)
    run_ms = 10_000 * M / rate_10k * 1e3
    phase("7 timing", f"run kernel, rough_well: {rate_10k:.6g} credited steps/s at "
          f"10,000 chains ({run_ms:.6g} ms/iteration), {rate_102k:.6g} at 102,400 "
          f"chains [{card}]")

    eng = cm.CudaMJHMC(RoughWell(), nbatch=10_000, seed=4, device="cuda")
    eng.sample(100)
    stream_ms = events_ms(lambda: eng.sample(2000)) / 2000
    phase("7 timing", f"stream kernel, rough_well, 10,000 chains, thin 1: "
          f"{stream_ms:.6g} ms/iteration [{card}]")
    kernel_s = (500 * run_ms + 1000 * stream_ms) / 1e3
    phase("7 timing", f"CLI sample (burn 500 + 1000 at 10,000 chains): kernels "
          f"~{kernel_s:.4g} s of {cli_s:.4g} s host clock [{card}]")
    rate_g50 = bench_cuda(BENCHMARK_CONFIGS["gauss50d"], nbatch=4096, steps_per_call=2000)
    phase("7 timing", f"run kernel, gauss50d (D=50): {rate_g50:.6g} credited steps/s at "
          f"4,096 chains [{card}]")

    st = initial_state(rw, 10_000, seed=5)
    args = (spec, *st, 99, EPS, BETA)
    cm.mjhmc_run_reference(*args, 5, M)
    plain_ms = events_ms(lambda: cm.mjhmc_run_reference(*args, 300, M)) / 300
    plain_stream_ms = events_ms(lambda: cm.mjhmc_stream_reference(*args, 300, 1, M)) / 300
    phase("7 timing", f"plain version on the card, rough_well, 10,000 chains: "
          f"run {plain_ms:.6g} ms/iteration, stream {plain_stream_ms:.6g} ms/iteration "
          f"[{card}]")

    mm_ms = {}
    for cname, cfg, dist, n in mm_cases:
        m = cfg.num_leapfrog_steps
        iters = 2000 if cname == "product_of_t" else 500
        rate = bench_cuda(cfg, nbatch=n, steps_per_call=iters)
        k_ms = n * m / rate * 1e3
        eng = cm.CudaMJHMC(dist, epsilon=cfg.epsilon, beta=cfg.beta, num_leapfrog_steps=m,
                           nbatch=n, seed=4, device="cuda")
        eng.sample(20)
        s_ms = events_ms(lambda: eng.sample(iters)) / iters
        args = (cm.energy_spec_for(dist), *initial_state(dist, n, seed=5), 99,
                cfg.epsilon, BETA)
        cm.mjhmc_run_reference(*args, 5, m)
        p_ms = events_ms(lambda: cm.mjhmc_run_reference(*args, 50, m)) / 50
        ps_ms = events_ms(lambda: cm.mjhmc_stream_reference(*args, 50, 1, m)) / 50
        mm_ms[cname] = (k_ms, s_ms, p_ms, ps_ms)
        burn, steps = mm_cli[cname]
        kern_s = (burn * k_ms + steps * s_ms) / 1e3
        phase("7 timing", f"matmul kernel, {cname}, {n} chains: run {k_ms:.6g} ms/iteration "
              f"({rate:.6g} credited steps/s), stream (thin 1) {s_ms:.6g} ms/iteration; "
              f"plain version run {p_ms:.6g}, stream {ps_ms:.6g} ms/iteration; CLI kernels "
              f"~{kern_s:.4g} s of {mm_cli_s[cname]:.4g} s host clock [{card}]")

    # ---- 8-12. ceiling probes, NUTS and the stub vs their plain versions --
    fma_err, fma_plain_ms, tc_err, tc_plain_ms = ceiling_checks(ce)
    nuts_run_err, nuts_stream_err = nuts_checks(cm)
    nuts_ms = nuts_timing_and_stats(cm, card)
    stub_err, stub_plain_ms = stub_checks(cm)

    # ---- 13. the NUTS CLI path (launches counted here only) -------------
    nuts_counters = {"nuts_run": cm.cuda_mjhmc_run, "nuts_stream": cm.cuda_mjhmc_stream_run}
    rec, nuts_launches, nuts_cli_s = run_cli(
        cli, ["sample", "--config", "gauss2d", "--engine", "cuda", "--sampler", "nuts",
              "--nbatch", "10240"], nuts_counters, attr="nuts_launches")
    check(nuts_launches["nuts_run"] > 0 and nuts_launches["nuts_stream"] > 0,
          f"NUTS kernels not launched: {nuts_launches}")
    check(all(abs(v / t - 1) < 0.05 for v, t in zip(rec["var"], (1.0, 100.0)))
          and rec["chains"] == 10_240 and rec["sampler"] == "nuts",
          f"NUTS CLI record {rec}: var outside 5% of [1, 100]")
    phase("13 cli nuts", f"{json.dumps(rec)}; launches {nuts_launches}; {nuts_cli_s:.4g} s "
          f"host clock [{card}]")

    # ---- 14. the roofline dossier (main path of the ceiling probes) -------
    dossier = run_dossier(cm, ce, card)

    def mm_entry(kname, src, launches, idx_ms, idx_plain, err_idx):
        sc = mm_ms["sparse_coding"]
        return {"name": kname, "route": "cuda", "source": MM_KERNEL_SRC, "replaces": src,
                "launches": launches, "max_abs_err": max(e[err_idx] for e in mm_err.values()),
                "ms": sc[idx_ms], "plain_ms": sc[idx_plain], "shape": "sparse_coding, 8192 chains",
                "per_config_ms": {c: {"ms": v[idx_ms], "plain_ms": v[idx_plain]}
                                  for c, v in mm_ms.items()}}

    print(json.dumps({"kernels": [
        {"name": "mjhmc_run", "route": "cuda", "source": KERNEL_SRC,
         "replaces": RUN_SRC, "launches": rw_launches["run"], "max_abs_err": run_err,
         "ms": run_ms, "plain_ms": plain_ms},
        {"name": "mjhmc_stream", "route": "cuda", "source": KERNEL_SRC,
         "replaces": STREAM_SRC, "launches": rw_launches["stream"],
         "max_abs_err": stream_err, "ms": stream_ms, "plain_ms": plain_stream_ms},
        mm_entry("mjhmc_mm_run", MM_RUN_SRC, mm_launches["mm_run"], 0, 2, 0),
        mm_entry("mjhmc_mm_stream", MM_STREAM_SRC, mm_launches["mm_stream"], 1, 3, 1),
        {"name": "fma_chain", "route": "cuda", "source": CEIL_SRC, "replaces": FMA_SRC,
         "launches": dossier["launches"]["fma_chain.launches"], "max_abs_err": fma_err,
         "ms": dossier["fma_ms"], "plain_ms": fma_plain_ms,
         "shape": "(256, 1024) x 4 chains, ms per iteration"},
        {"name": "tc_chain", "route": "cuda", "source": CEIL_SRC, "replaces": TC_SRC,
         "launches": dossier["launches"]["tc_chain.launches"], "max_abs_err": tc_err,
         "ms": dossier["tc_ms"], "plain_ms": tc_plain_ms,
         "shape": "depth 128 x 4 chains, ms per iteration"},
        {"name": "nuts_run", "route": "cuda", "source": KERNEL_SRC, "replaces": RUN_SRC,
         "variant": NUTS_VARIANT, "launches": nuts_launches["nuts_run"],
         "max_abs_err": nuts_run_err, "ms": nuts_ms[0], "plain_ms": nuts_ms[2],
         "shape": "gauss2d, 10,240 chains, max_depth 7, ms per iteration"},
        {"name": "nuts_stream", "route": "cuda", "source": KERNEL_SRC, "replaces": STREAM_SRC,
         "variant": NUTS_VARIANT, "launches": nuts_launches["nuts_stream"],
         "max_abs_err": nuts_stream_err, "ms": nuts_ms[1], "plain_ms": nuts_ms[3],
         "shape": "gauss2d, 10,240 chains, max_depth 7, thin 1, ms per iteration"},
        {"name": "mjhmc_mm_run_stub", "route": "cuda", "source": MM_KERNEL_SRC,
         "replaces": MM_RUN_SRC, "variant": STUB_VARIANT,
         "launches": dossier["launches"]["cuda_mjhmc_mm_run.stub_launches"],
         "max_abs_err": stub_err, "ms": dossier["stub_ms"], "plain_ms": stub_plain_ms,
         "shape": "product_of_t, 4,096 chains, M 10, ms per iteration"},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
