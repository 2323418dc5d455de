"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA engine from ``mjhmc_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card, checks the
engine's statistics against analytic and quadrature variances, drives the
main path once through the CLI (``sample --config rough_well --engine
cuda``) and times the kernels beside their plain versions. One line per
phase; any failed check raises, so the exit code is non-zero. The second
to last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

import torch

M, EPS, BETA = 10, 1.0, 0.1  # the rough_well preset
RUN_SRC = "mjhmc_tpu/ops/pallas_mjhmc.py:1451"
STREAM_SRC = "mjhmc_tpu/ops/pallas_mjhmc.py:1494"
KERNEL_SRC = "mjhmc_tpu_torch/csrc/mjhmc_engine.cu"


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # ---- 1. device -------------------------------------------------------
    from mjhmc_tpu_torch.bench import bench_cuda, gpu_name_and_power_limit
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.models import Gaussian, RoughWell
    from mjhmc_tpu_torch.ops import _build
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
    for ln in _build.build_log().splitlines():
        if "registers" in ln or "spill" in ln:
            phase("2 build", "ptxas " + ln.strip())

    # ---- 3. kernel vs plain version, fixed-uniform mode ------------------
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
    for name in ("v", "grad", "u"):
        assert_close(getattr(k5, name), getattr(r5, name), 1e-4, atol, f"{name} after 5")
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
    for name in ("x", "v", "grad", "u", "wx2"):
        assert_close(getattr(k50, name), getattr(r50, name), 1e-4, atol50, f"gauss50d {name}")
    phase("3 fixed-uniform", f"gauss50d (D=50): evals exact; x,v,g,u,wx2 rtol 1e-4 atol {atol50:.3g}")

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

    # ---- 6. the CLI path (main path; launches counted here only) ----------
    from mjhmc_tpu_torch.__main__ import main as cli

    cm.cuda_mjhmc_run.launches = 0
    cm.cuda_mjhmc_stream_run.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli(["sample", "--config", "rough_well", "--engine", "cuda",
             "--steps", "1000", "--burn", "500"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"run": cm.cuda_mjhmc_run.launches, "stream": cm.cuda_mjhmc_stream_run.launches}
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(launches["run"] > 0 and launches["stream"] > 0, f"kernels not launched: {launches}")
    target = RoughWell().analytic_var().tolist()
    check(all(abs(v / t - 1) < 0.05 for v, t in zip(rec["var"], target)),
          f"CLI var {rec['var']} vs {target}: outside 5%")
    check(rec["chains"] == 10_000 and rec["ess"] > 0, f"bad CLI record {rec}")
    phase("6 cli", f"{json.dumps(rec)}; launches {launches}; {cli_s:.4g} s host clock")

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

    print(json.dumps({"kernels": [
        {"name": "mjhmc_run", "route": "cuda", "source": KERNEL_SRC,
         "replaces": RUN_SRC, "launches": launches["run"], "max_abs_err": run_err,
         "ms": run_ms, "plain_ms": plain_ms},
        {"name": "mjhmc_stream", "route": "cuda", "source": KERNEL_SRC,
         "replaces": STREAM_SRC, "launches": launches["stream"],
         "max_abs_err": stream_err, "ms": stream_ms, "plain_ms": plain_stream_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
