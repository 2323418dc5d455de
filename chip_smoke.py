"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``mjhmc_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, checks the engine's
statistics against analytic, quadrature, Laplace and plain-sampler
variances, drives the main paths once through the CLI (``sample --engine
cuda`` on ``rough_well`` for the elementwise kernel, on ``product_of_t``,
``sparse_coding`` and ``logreg`` for the matmul kernel, ``--sampler nuts`` on
``gauss2d`` and on the matmul presets for the NUTS bodies, ``--sampler
control|malt`` and ``--integrator two_stage``, and every sampler on the zoo
presets ``funnel``, ``banana``, ``mog`` and ``eight_schools``), the
engines' ``from_warmup`` (also on the funnel) and the roofline dossier
(``bench_mfu.main`` with its ceiling probes, at a reduced ``--steps``), and
times the kernels beside their plain versions. The matmul presets run at
their JAX default dot precisions (product of t and logreg one bf16 pass,
sparse coding bf16x3, on the tensor cores); the phases that held the
matmul bodies before those existed (3-4, 12, 15-16, 21) and their timings
(7, 20, 24) run them at full f32 (``precision="highest"``), and phases
30-33 hold every bf16 instance against its plain version (its gradient
and energy at ε = 0, then its dynamics), compare the
sparse-coding variances across precisions, run the precision sweep
(``bench_mm_precision``) and time every instance beside its full-f32 twin.
Phases 34-35 hold the chain-sharded runtime (``sharded_cuda_mjhmc_run``,
the TPU's ``sharded_pallas_mjhmc_run``): at world size 1 under NCCL against
the direct call, bit for bit, with its collectives counted, the sharded
moments, the adaptive step, the sharded checkpoint and ``bench_scaling``;
then two processes (this script started again with ``--phase35-rank``)
sharing the card under gloo, each rank against a direct launch at its
offset seed. Phase 36 prints the matmul NUTS kernel's per-leaf phase
breakdown at the three presets, the elementwise NUTS kernel's on gauss2d
and the funnel, mm_kernel's per-iteration one (MJHMC and MALT on sparse
coding, MALT on logreg) and the elementwise MJHMC, control and MALT
kernels' per-iteration ones, from their PROF instances (clock64() stamps),
and phase 2 holds the NUTS, elementwise NUTS and mm_kernel tiles the
library reports (chains, threads and shared bytes a block) and the
elementwise MJHMC, control and MALT groupings (lanes a chain, threads a
block) to the wrappers' mirror, the NUTS tiles at depths 1-31 (past 12 the
matmul kernel's DEEP instances). Phases 9-10 also run elementwise NUTS at
max_depth 14 (and ``CudaNUTS`` at 13 and 14) bit for bit against its
plain version, check
that a real share of its trees entered their last round, and see both
kernels refuse 32 (2^32 − 1 leaves would pass an int32); phase 21 holds
the matmul kernel's trees at max_depth 14 (on its DEEP instances, the
stack rows and span slots past 12 in the device buffer) and at 12 (on
those every shallower tree runs) to its plain version and times one depth-12, -13 and -14 launch at product of t's 4,096 chains,
phase 44 a9a's chunked tile at max_depth 13; phases 11 and 29
print the share of the warps' leaf slots that ran a live leaf. Phase 15 also runs each matmul preset's MJHMC, control and MALT at
a width that leaves mm_kernel's last tile partly empty (4,093, 8,185 and
2,045 chains). Phase 38 drives slices B and E: ``bench_ess.main`` rows at
the presets' widths (the rough well's MJHMC, control, MALT and NUTS
engines, product of t's MJHMC, gauss2d's plain NUTS), each record held to
its ESS bounds, a float64 recomputation of its block's ESS, its launch
counts and (engine rows) split-R-hat; ``calculate_autocorrelation`` on
the engine, the ladder oracle on the card and the ``diagnostics``
subcommand on a ``sample --save`` file. Phase 39 drives slices D and F on
the card with the plain PyTorch samplers and heads (no fused-engine
launch): parallel tempering from a stuck start and ``sample --sampler pt
--adapt-ladder``, ``sample --sampler reduced_flip`` beside control HMC's
rejections, reduced flip and MJHMC's partial refresh on gauss50d, ChEES,
SMC on the Gaussian oracle with both mutations (and bit for bit under a
world-size-1 mesh), ``smc`` and ``vi`` (gauss50d, full rank on a
correlated Gaussian, sparse coding at rank 16), the autocorrelation
experiment with reduced flip and PT, and ``bench_heads``. Phase 40 drives
slice H on the card: ``search`` with the grid and the GP-EI methods (each
GP proposal timed), one grid point of the efficiency battery on gauss50d
at M 5 and 50 (and the battery's projected hours on this eager path),
``figures --quick`` (every ``.npz`` held to its checks: the spectral gaps
against their eigensolutions recomputed on the host, tempering's mode
recovery, the overlay's curves, the fan's spread; the ``.png`` files only
where matplotlib is installed, its absence reported by name),
``efficiency --quick`` and ``examples/quickstart_torch.py`` (these plain
rows in a process of their own, which imports beside phases 3-38 and runs
beside phase 39, so that no kernel is timed beside them; its grid point's
ms and the rows' host seconds are then not those of a card alone), then
``bench --profile``, whose ``torch.profiler`` trace must hold
``mjhmc_kernel``'s device events (its share of the traced window
printed). Phase 41 drives slice H's third part: one boundary-audited
``bench_ess._tune`` round on the card and ``_candidates`` over its table,
``_arbitrate_nuts`` on product of t's engine NUTS row with one more
``measure`` at max_depth 12 and one at 14 (the matmul NUTS kernel's
deepest trees, on its DEEP instances, which phase 21 holds to its plain
version), ``bench_ess --table`` and
``bench_two_stage`` on gauss2d, and holds ``bench_heads.sharded_path_receipt``
as phase 39's ``bench_heads.main`` ran it (8 gloo ranks on the host's CPU:
its wall is no card number). Phase 42 runs the elementwise engine at any D:
the on-demand instances (``csrc/ondemand/ew_instance.cu``, one library a
body, energy and D, built in phase 2 beside the library) at the JAX
package's TPU-gated shapes, a banana of D 10, a mixture of 10 components,
the funnel at D 12 and 30 and Gaussian D 3 and 128 (``ANY_D_SHAPES``,
``ANY_D_CARD_SHAPES``): their nvcc seconds and ptxas, their tiles against
the mirror, every body and branch against its plain version (fixed-uniform
counters exact), JAX's six gated statistical checks at their own shapes,
settings and tolerances (run beside phase 39 in phase 40's process, as are
phase 43's statistics), and each instance's ms an iteration. Phase 44 runs
the matmul engine past one block's shared memory (``PAST_SHAPES``): logistic
regression at LIBSVM a9a's shape (124 × 32,561, k rows in chunks) and sparse
coding at 1,024 × 4,096 (k in chunks, X, G and the mass in the device
buffer; a9a's tiles at "default" keep a ring of chunks in shared memory
and, with few chains, split one tile over a thread block cluster), their
tiles with each launch's cluster size and the clusters the card holds,
every body run and stream against its plain version with phase 43's
allowances (NUTS at max_depth 4, logreg also 8; each run launched twice,
one hash of its outputs; a9a's control also at "bf16x3", a split tile with
lo fragments, one iteration), JAX's Laplace oracle
and phase 43's moments check at those shapes, each
instance's ms an iteration (first, alone on the card), and the dictionary
learner on the card, and a9a's tree at max_depth 13, whose plain runs (three
processes on the card) run beside phase 44's checks, statistics and
learner, so their host seconds are not those of a card alone; phase 34's ``bench_scaling`` runs with ``--profile`` and prints the
``collective_time_fraction`` line. Phase 2 also
runs the plain NUTS of phases 22 and 42 on the CPU (``PLAIN_NUTS``) and
waits for it and for the on-demand builds, so nothing of it overlaps a
timed phase. One line
per phase; any failed
check raises, so the exit code is non-zero. The second to last line is the kernels' JSON record, the
last line ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import importlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

M, EPS, BETA = 10, 1.0, 0.1  # the rough_well preset
RUN_SRC = "mjhmc_tpu/ops/pallas_mjhmc.py:1451"
STREAM_SRC = "mjhmc_tpu/ops/pallas_mjhmc.py:1494"
MM_RUN_SRC = "mjhmc_tpu/ops/pallas_mjhmc.py:1265"
MM_STREAM_SRC = "mjhmc_tpu/ops/pallas_mjhmc.py:1596"
KERNEL_SRC = "mjhmc_tpu_torch/csrc/mjhmc_engine.cuh"
ONDEMAND_SRC = "mjhmc_tpu_torch/csrc/ondemand/ew_instance.cu"
MM_ONDEMAND_SRC = "mjhmc_tpu_torch/csrc/ondemand/mm_instance.cu"
MM_KERNEL_SRC = "mjhmc_tpu_torch/csrc/mjhmc_mm_engine.cuh"
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
#: gauss2d NUTS past the matmul kernel's tile depth on the elementwise
#: kernel (phases 9-10; 1,024 chains, one iteration): at max_depth 14 and
#: this ε every fixed-uniform tree runs the 16,383 leaves of the cap and in
#: Philox mode ~0.57 of the trees begin round 14, ~0.37 turn in rounds
#: 12-14 (the plain version on the CPU); CudaNUTS runs at 13 and 14
EW_DEEP_DEPTH, EW_DEEP_EPS = 14, 5e-4
#: phase 21's matmul trees past the tile depth (``MM_NUTS_DEEP``) and the
#: depths of its timed product-of-t launch
MM_DEEP_DEPTH = 14
MM_DEEP_TIMED = (12, 13, 14)
#: phase 44's chunked tile (a9a, one tile of chains, Philox, one iteration
#: from the posterior's bulk) past the tile depth: every a9a tree turned
#: after 127-511 leaves at ε 0.0015-0.004 (the plain version on the CPU, 8
#: chains), so it turns after 0.44-0.51 time units and at this ε every tree
#: runs the 8,191 leaves of round 13
PAST_DEEP_DEPTH, PAST_DEEP_EPS = 13, 4e-5
#: the depths at which phase 2 holds every NUTS tile to the mirror
NUTS_TILE_DEPTHS = (1, 8, 10, 11, 12, 13, 14, 31)
CLI_NUTS_DEPTH = 8  # max_depth of `sample --sampler nuts` (at the config's eps)
#: the dossier's --steps here (its default is 20,000): the engine rows time
#: 2,000 and 10,000 jump iterations
DOSSIER_STEPS = 2000
CONTROL_VARIANT = "control (_make_step_control, mjhmc_tpu/ops/pallas_mjhmc.py:863)"
MALT_VARIANT = "malt (_make_step_malt, mjhmc_tpu/ops/pallas_mjhmc.py:938)"
TWO_STAGE_BRANCH = "two_stage (_two_stage_half, mjhmc_tpu/ops/pallas_mjhmc.py:745)"
MASS_BRANCH = "inv_mass (_make_step, mjhmc_tpu/ops/pallas_mjhmc.py:738, :793, :848)"
MM_ENERGIES = {"product_of_t": "ProductOfTSpec (mjhmc_tpu/ops/pallas_mjhmc.py:379)",
               "sparse_coding": "SparseCodingSpec (mjhmc_tpu/ops/pallas_mjhmc.py:468)",
               "logreg": "LogregSpec (mjhmc_tpu/ops/pallas_mjhmc.py:519)"}
MM_NUTS_DEPTH = 8  # max_depth of the matmul NUTS checks and of `sample --sampler nuts`
#: phase 30's iterations of the MJHMC, control and MALT cases at the bf16
#: precisions per preset: the most at which one-ulp nudges of x and ε and
#: another summation order move a few percent of the chains at most in the
#: plain version alone (product of t's ε=0.2 is unstable along W's stiffest
#: direction, a one-pass rounding flip grows within an iteration)
#: max_depth of phase 30's deep NUTS cases (leaf counts held, states
#: reported), below the CLI's 8 for the plain version's time
PRECISION_NUTS_DEEP = 6
PRECISION_ITERS = {"product_of_t": 1, "sparse_coding": 5, "logreg": 2}
#: (iterations, M) of the sweep's sparse coding run at one pass, where the
#: residual's bf16 rounding turns a last-ulp difference into 2⁻⁹: at the
#: preset's M=10 one iteration moves ~11% of the chains, at M=3 ~2%
SPARSE_DEFAULT_HELD = (1, 3)
#: most chains the perturbed plain runs may move in a phase-30 case (but
#: the deep NUTS trees): a case past it could not tell a wrong kernel
INFORMATIVE = 0.05
PRECISION_SRC = "MatmulEnergySpec._dot (mjhmc_tpu/ops/pallas_mjhmc.py:282-375)"

# The least time the card could take for a kernel's work (bound_ms): the
# larger of its operations over the FP32 peak and its bytes (each input read
# once, each output written once) over the memory rate, H100 SXM data sheet
# (the bf16 tensor-core peak for tc_chain). Operations are counted per chain
# from the shapes and this run's counters: each multiply, add or fused
# multiply-add step of the algorithm as written (an FMA as two), each
# transcendental as one, and a Philox4x32-10 block (four words) as 100
# integer operations at the same rate. The matmul kernel's bf16 instances
# run their contractions on the tensor cores: those FLOPs, times the
# precision's passes, count at the bf16 peak and the rest at the FP32 peak.
# It is a floor, not a model of the kernels' instruction mix.
FP32_PEAK, BF16_PEAK, HBM_RATE = 67e12, 989e12, 3.35e12
PHILOX_OPS = 100
NORMAL_OPS = 6 + PHILOX_OPS / 2  # log, sqrt, cos, three products; two words
PAIR_OPS = 10 + PHILOX_OPS / 2  # both branches: log, sqrt, sin, cos, six products


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - T0:.1f} s since start)", flush=True)


def check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


#: children that ``stop_children`` leaves running: phase 40's plain rows,
#: which run in a process of their own from phase 2's end to phase 40
SPARED: set[int] = set()


def stop_children() -> list[str]:
    """Stops the processes this one started that still run, but those in
    ``SPARED``, and returns their command lines: multiprocessing's resource
    tracker, which the first spawn pool starts and which otherwise lives
    until this process has exited (it is started again if a later pool
    needs it), then any other child (SIGTERM, SIGKILL after 10 s)."""
    import signal
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()
    left = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
            state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
            if int(ppid) != os.getpid() or int(pid) in SPARED:
                continue
            if state == "Z":  # ended, not yet reaped
                os.waitpid(int(pid), os.WNOHANG)
                continue
            left[int(pid)] = Path(f"/proc/{pid}/cmdline").read_text().replace("\0", " ")
        except (OSError, ValueError):
            continue  # ended meanwhile
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and any(Path(f"/proc/{p}").exists() for p in left):
            for pid in left:
                with contextlib.suppress(ChildProcessError):
                    os.waitpid(pid, os.WNOHANG)
            time.sleep(0.05)
    return [cmd.strip() for cmd in left.values()]


def at(spec, precision="highest"):
    """A matmul spec at another dot precision (the elementwise specs have
    none), as a user picks one: dataclasses.replace(spec, precision=...)."""
    return dataclasses.replace(spec, precision=precision) if hasattr(spec, "precision") else spec


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


def initial_state(dist, n, seed, inv_mass=None):
    """(x, v, g, u, h_back, valid) on the card; v ~ N(0, M) with a mass."""
    gen = torch.Generator().manual_seed(seed)
    x = dist.init_x(gen, n, DEV).contiguous()  # a mixture's draws come transposed
    v = torch.randn(x.shape, generator=gen).to(DEV)
    if inv_mass is not None:
        v = v / torch.sqrt(torch.tensor(inv_mass, device=DEV))[:, None]
    u, g = dist.potential_and_grad(x)
    z = torch.zeros(n, device=DEV)
    return x, v, g.contiguous(), u.contiguous(), z, z.clone()


def cpu_seconds() -> float:
    """User and system CPU seconds of this process and of its children that
    have ended and been waited for (with theirs)."""
    import resource

    return sum(r.ru_utime + r.ru_stime for r in (resource.getrusage(resource.RUSAGE_SELF),
                                                  resource.getrusage(resource.RUSAGE_CHILDREN)))


def host_probe() -> float:
    """Seconds one core of the host takes for a fixed piece of Python work
    (the same in every run), to compare the hosts of two runs."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i * i % 7
    return time.perf_counter() - t0


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


def mm_sass(_build, library=None):
    """{instance: (HMMA instructions in its SASS, a digest of its SASS)} of
    every matmul kernel of a built library (the current build's by
    default), the instance named from its mangled template arguments (a
    shape other than its energy's preset's named too; NUTS's DEEP instances
    "deep"). The library's
    cubins are extracted
    (``cuobjdump -xelf``) and those holding matmul kernels disassembled
    (``cuobjdump -sass``), one process each, all at once; a digest covers a
    function's instructions, not its name."""
    import hashlib
    import tempfile

    names = ("product_of_t", "sparse_coding", "logreg")
    bodies = ("mjhmc", "nuts", "control", "malt")
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    out, digests = {}, {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        subprocess.run([tool, "-xelf", "all", str(library or _build.library_path())], cwd=tmp,
                       check=True, capture_output=True)
        cubins = [p for p in Path(tmp).glob("*.cubin") if b"mm_kernel" in p.read_bytes()]
        procs = []
        for cubin in cubins:
            with open(cubin.with_suffix(".sass"), "w") as f:
                procs.append(subprocess.Popen([tool, "-sass", str(cubin)], stdout=f))
        for cubin, proc in zip(cubins, procs):
            check(proc.wait() == 0, f"cuobjdump -sass {cubin.name} failed ({proc.returncode})")
            label = None
            for ln in cubin.with_suffix(".sass").read_text().splitlines():
                if "Function : " in ln:
                    label = None
                    m = re.search(r"\d+(nuts_mm_kernel|mm_kernel)I((?:L[ib]\d+E)+)E", ln)
                    if m:
                        a = [int(v) for v in re.findall(r"L[ib](\d+)E", m.group(2))]
                        mm = m.group(1) == "mm_kernel"
                        shape = ""  # E, D, K, then the rest
                        if (a[1], a[2]) != ((36, 36), (128, 64), (16, 256))[a[0]]:
                            shape = f" {a[1]}x{a[2]}"
                        a = a[:1] + a[3:]
                        if mm:  # E, VAR, EMIT, STUB, BR, P, PROF
                            body, emit, stub, br, prec, prof = (bodies[a[1]], a[2], a[3], a[4],
                                                                a[5], a[6])
                        else:  # E, EMIT, BR, P, PROF, DEEP
                            body, emit, stub, br, prec, prof = "nuts", a[1], 0, a[2], a[3], a[4]
                        deep = not mm and len(a) > 5 and a[5]
                        label = (f"{names[a[0]]}{shape} {body} "
                                 f"{'stream' if emit else 'run'}"
                                 f"{' stub' if stub else ''}{' branches' if br else ''}"
                                 f"{' prof' if prof else ''}{' deep' if deep else ''} "
                                 f"{('highest', 'bf16x3', 'bf16x2', 'default')[prec]}")
                        out[label] = 0
                        digests[label] = hashlib.sha256()
                elif label and re.match(r"\s+/\*[0-9a-f]{4,}\*/", ln):
                    out[label] += "HMMA" in ln
                    digests[label].update(ln.encode())
    return {k: (out[k], digests[k].hexdigest()[:16]) for k in out}


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
    spec = at(cm.energy_spec_for(dist))
    eps, m = cfg.epsilon, cfg.num_leapfrog_steps
    ts = MM_STATE_ITERS[cname]
    args = (spec, *initial_state(dist, n, seed=1), 7, eps, BETA)
    k100 = cm.cuda_mjhmc_mm_run(*args, 100, m, fixed_uniform=True)
    r100 = cm.run_reference(*args, 100, m, fixed_uniform=True)
    check(bool((k100.evals == m * 100 + m).all()) and bool((r100.evals == m * 100 + m).all()),
          f"{cname}: fixed-uniform evals must be exactly M*100 + M on every chain")
    w_rel = abs(float(k100.w.double().sum() / r100.w.double().sum()) - 1)
    if cname == "sparse_coding":
        assert_close(k100.w.sum(), r100.w.sum(), 1e-4, 0.0, f"{cname} sum of w after 100")
    kt = cm.cuda_mjhmc_mm_run(*args, ts, m, fixed_uniform=True)
    rt = cm.run_reference(*args, ts, m, fixed_uniform=True)
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
    r5 = cm.run_reference(*args, 5, m, fixed_uniform=True)
    check(torch.equal(k5.evals, r5.evals), f"{cname}: counters differ after 5")
    tol = 1e-4 * r5.x.abs().max() + 1e-4 * r5.x.abs()
    share5 = float(((k5.x - r5.x).abs() <= tol).all(dim=0).double().mean())
    xs_k, ws_k, es_k, so_k = cm.cuda_mjhmc_mm_stream_run(*args, 5, 1, m, fixed_uniform=True)
    xs_r, ws_r, es_r, _ = cm.stream_reference(*args, 5, 1, m, fixed_uniform=True)
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
    spec = at(cm.energy_spec_for(dist))
    m = cfg.num_leapfrog_steps
    args = (spec, *initial_state(dist, n, seed=2), 12345, cfg.epsilon, BETA)
    kp = cm.cuda_mjhmc_mm_run(*args, 5, m)
    rp = cm.run_reference(*args, 5, m)
    same = float((kp.evals == rp.evals).double().mean())
    refreshed = int((rp.evals > 6 * m).sum())
    check(same >= 0.999, f"{cname}: Philox-mode counters match on {same:.5f} of chains (< 0.999)")
    check(refreshed >= 10, f"{cname}: only {refreshed} chains refreshed: draws not exercised")
    # a refreshed chain's v is 128 (36) Box-Muller normals from words 1..2d
    ts = MM_STATE_ITERS[cname]
    kt, rt = cm.cuda_mjhmc_mm_run(*args, ts, m), cm.run_reference(*args, ts, m)
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


def rounds_begun(es):
    """(E, n) rounds each chain's tree began in each iteration, from a
    stream's cumulative leaf counts ``es`` (E, n): a tree that began round
    r (from 1) has 2^(r−1) leaves or more and fewer than 2^r."""
    per_iter = torch.diff(es.long(), dim=0, prepend=torch.zeros_like(es[:1]).long())
    return torch.floor(torch.log2(per_iter.double())).long() + 1


def check_last_round(what, began, depth, least=0.1):
    """Fail unless some tree began round ``depth`` and at least ``least`` of
    ``began`` (the rounds each tree began) did; returns that share."""
    share = float((began == depth).double().mean())
    check(int(began.max()) == depth and share >= least,
          f"{what}: trees began {int(began.max())} rounds at most, and {share:.4f} of them "
          f"round {depth} (< {least}): the deepest stack rows went untested")
    return share


def nuts_checks(cm):
    """The NUTS run and stream kernels vs their plain version, in
    fixed-uniform mode and in Philox mode, at the main path's shapes (the
    dossier's gauss2d row and the CLI's, both at 10,240 chains), on the
    rough well and on the D=50 instances, and gauss2d past the matmul
    kernel's tile depth (fixed-uniform at EW_DEEP_DEPTH; CudaNUTS.run at one
    less and CudaNUTS.sample at it, Philox, bit for bit); returns (max|dx|
    run, stream, the CudaNUTS calls' numbers)."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.models import Gaussian, ProductOfT, RoughWell

    g2 = Gaussian(ndims=2, log_conditioning=2.0)
    cases = (  # name, distribution, eps, max_depth, chains, fixed-uniform and Philox iterations
        ("gauss2d", g2, NUTS_EPS, NUTS_DEPTH, 10_240, 5, 5),
        ("gauss2d", g2, BENCHMARK_CONFIGS["gauss2d"].epsilon, CLI_NUTS_DEPTH, 10_240, 5, 5),
        # past the matmul kernel's tile depth, its stack rows 12-13 (one
        # fixed-uniform iteration: the plain version pays a host sync a
        # leaf); it runs every stack row of a depth-12 tree. Its Philox
        # mode is CudaNUTS.sample's at this depth below (no iteration here)
        ("gauss2d", g2, EW_DEEP_EPS, EW_DEEP_DEPTH, 1024, 1, 0),
        ("rough_well", RoughWell(), 1.0, NUTS_DEPTH, 4096, 1, 5),
        # the D=50 instance as `sample --config gauss50d --sampler nuts` runs it
        ("gauss50d", Gaussian(ndims=50, log_conditioning=4.0),
         BENCHMARK_CONFIGS["gauss50d"].epsilon, CLI_NUTS_DEPTH, 4096, 5, 5),
    )
    run_err = stream_err = 0.0
    for cname, dist, eps, depth, n, iters, piters in cases:
        t_case = time.perf_counter()
        spec = cm.energy_spec_for(dist)
        what = f"NUTS {cname} ({n} chains, eps {eps}, max_depth {depth})"
        nuts = dict(variant="nuts")

        # fixed-uniform: every round goes right
        args = (spec, *initial_state(dist, n, seed=1), 7, eps, 0.0)
        k = cm.cuda_mjhmc_run(*args, iters, depth, fixed_uniform=True, **nuts)
        xs_k, ws_k, es_k, so_k = cm.cuda_mjhmc_stream_run(*args, iters, 1, depth,
                                                          fixed_uniform=True, **nuts)
        xs_r, _, es_r, r = cm.stream_reference(*args, iters, 1, depth, fixed_uniform=True,
                                               **nuts)
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
        deep = ""
        if depth == EW_DEEP_DEPTH:
            last = check_last_round(what, rounds_begun(es_r), depth)
            identical = all(torch.equal(getattr(k, f), getattr(r, f))
                            for f in ("x", "v", "grad", "u", "evals")) and torch.equal(xs_k, xs_r)
            check(identical, f"{what}: not bit-identical to the plain version")
            deep = (f"; bit-identical; {last:.4f} of trees began round {depth} "
                    f"({time.perf_counter() - t_case:.3g} s)")
        phase("9 nuts fixed-uniform", f"{what}, {iters} iterations, {leaves:.4g} "
              f"leaves/iteration: leaf counts and stream es exact; w == steps, ws == 1; "
              f"x,v,g,u and stream xs rtol 1e-4 on every chain{deep}")
        if not piters:
            continue
        t_case = time.perf_counter()

        # Philox mode: rounds go both ways; every iteration's tree compared
        seed = 12345
        args = (spec, *initial_state(dist, n, seed=2), seed, eps, 0.0)
        kp = cm.cuda_mjhmc_run(*args, piters, depth, **nuts)
        xs_k, _, es_k, _ = cm.cuda_mjhmc_stream_run(*args, piters, 1, depth, **nuts)
        xs_r, _, es_r, rp = cm.stream_reference(*args, piters, 1, depth, **nuts)
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
        started = rounds_begun(es_r)
        right = round_directions(cm, seed, n, piters, depth)
        live = torch.arange(depth, device="cuda")[None, :, None] < started[:, None, :]
        both = ((right & live).any(dim=1) & (~right & live).any(dim=1)).any(dim=0) & agree
        share = float(both.double().mean())
        check(share > 0.01, f"{what}: only {share:.4f} of chains built rounds both ways "
              "and agree with the plain version")
        phase("10 nuts philox", f"{what}, {piters} iterations: leaf counts and stream es equal "
              f"on {same:.5f} of chains; x,v,g,u and every emitted x within rtol 1e-4 on "
              f"{share_agree:.5f} (bit-identical on {float(identical.double().mean()):.5f}); "
              f"{share:.4f} of chains built rounds in both directions and agree; "
              f"{int(started.max())} rounds at most")

    # CudaNUTS past the matmul kernel's tile depth, from its own state and
    # seed, against the plain version: run at 13, sample (the stream) at 14;
    # the main path, its counts from 0 just before the engine's call, read
    # just after; the engine's launch and the plain call timed by CUDA events
    deep = {}
    for depth, stream in ((EW_DEEP_DEPTH - 1, False), (EW_DEEP_DEPTH, True)):
        t_case = time.perf_counter()
        eng = cm.CudaNUTS(g2, epsilon=EW_DEEP_EPS, num_leapfrog_steps=depth, nbatch=1024, seed=6)
        st = tuple(t.clone() for t in (eng.x, eng.v, eng.g, eng.u, eng.h_back, eng.back_valid))
        gen = torch.Generator()
        gen.set_state(eng._seed_gen.get_state())
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
        got, ref = {}, {}
        cm.reset_counts()
        if stream:
            ms = events_ms(lambda: got.update(s=eng.sample(1, return_evals=True)))
            plain_ms = events_ms(lambda: ref.update(s=cm.stream_reference(
                eng.spec, *st, seed, EW_DEEP_EPS, 0.0, 1, 1, depth, variant="nuts")))
            xs, _, es = got["s"]
            out, r = eng.last_out, ref["s"][3]
            same = (torch.equal(xs, ref["s"][0]) and torch.equal(es, ref["s"][2])
                    and all(torch.equal(a, b) for a, b in zip(out, r)))
            pairs = [(xs, ref["s"][0])]
        else:
            ms = events_ms(lambda: got.update(s=eng.run(1)))
            plain_ms = events_ms(lambda: ref.update(s=cm.run_reference(
                eng.spec, *st, seed, EW_DEEP_EPS, 0.0, 1, depth, variant="nuts")))
            out, r = got["s"], ref["s"]
            same = all(torch.equal(a, b) for a, b in zip(out, r))
            pairs = []
        # the largest |kernel − plain| over x, v, g, u (and the stream's xs)
        err = max(float((a - b).abs().max())
                  for a, b in pairs + [(getattr(out, f), getattr(r, f))
                                       for f in ("x", "v", "grad", "u")])
        wrapper = cm.cuda_mjhmc_stream_run if stream else cm.cuda_mjhmc_run
        launched = wrapper.deep_nuts_launches
        check(launched == 1, f"CudaNUTS gauss2d max_depth {depth}: {launched} launches past "
              "max_depth 10")
        check(same, f"CudaNUTS gauss2d max_depth {depth}: not bit-identical to the plain version")
        # a tree of 2^(depth-1) leaves or more began its last round
        entered = float((out.evals >= 2**(depth - 1)).double().mean())
        check(entered >= 0.1, f"CudaNUTS gauss2d max_depth {depth}: only {entered:.4f} of "
              f"chains began round {depth} (< 0.1): the deepest stack rows went untested")
        deep["stream" if stream else "run"] = dict(launches=launched, err=err, ms=ms,
                                                   plain_ms=plain_ms,
                                                   depth=depth, leaves=int(out.evals.sum()))
        phase("10 nuts philox", f"CudaNUTS gauss2d (1024 chains, eps {EW_DEEP_EPS}, max_depth "
              f"{depth}, 1 iteration, {'sample' if stream else 'run'}): bit-identical to the "
              f"plain version; {float(out.evals.double().mean()):.5g} leaves/iteration; "
              f"{entered:.4f} of chains began round {depth}; kernel {ms:.6g} ms, plain version "
              f"{plain_ms:.6g} ms ({time.perf_counter() - t_case:.3g} s)")
    # past the last depth whose leaf counts fit an int32 both kernels refuse
    pot = cm.energy_spec_for(ProductOfT())
    pst = initial_state(ProductOfT(), 8, seed=1)
    g2st = initial_state(g2, 8, seed=1)
    for name, call, cap in (
            ("matmul", lambda m: cm.cuda_mjhmc_mm_run(pot, *pst, 5, 0.12, 0.0, 2, m,
                                                      variant="nuts"), cm.NUTS_MM_MAX_DEPTH),
            ("elementwise", lambda m: cm.cuda_mjhmc_stream_run(
                cm.energy_spec_for(g2), *g2st, 5, 0.1, 0.0, 2, 1, m, variant="nuts"),
             cm.NUTS_MAX_DEPTH)):
        try:
            call(cap + 1)
            refused = ""
        except NotImplementedError as e:
            refused = str(e)
        check(cap == 31 and f"max_depth 1..{cap}" in refused and "int32" in refused,
              f"the {name} NUTS kernel must refuse max_depth {cap + 1}: {refused!r}")
        phase("10 nuts philox", f"{name} NUTS at max_depth {cap + 1}: refused ({refused})")
    return run_err, stream_err, deep


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
    got = {}
    stream_ms = events_ms(lambda: got.update(s=eng.sample(1000, return_evals=True))) / 1000
    es = got["s"][2]
    args = (cm.energy_spec_for(dist), *initial_state(dist, 10_240, seed=5), 99, NUTS_EPS, 0.0)
    cm.run_reference(*args, 1, NUTS_DEPTH, variant="nuts")
    plain_ms = events_ms(lambda: cm.run_reference(*args, 3, NUTS_DEPTH, variant="nuts")) / 3
    plain_stream_ms = events_ms(
        lambda: cm.stream_reference(*args, 3, 1, NUTS_DEPTH, variant="nuts")) / 3
    phase("11 nuts stats", f"CudaNUTS gauss2d (10,240 chains, eps {NUTS_EPS}, max_depth "
          f"{NUTS_DEPTH}, 100 + 1000): var/analytic {[round(x, 5) for x in ratio.tolist()]}; "
          f"{leaves:.5g} leaves/iteration")
    phase("11 nuts stats", f"NUTS run kernel {run_ms:.6g} ms/iteration "
          f"({leaves * 10_240 / run_ms * 1e3:.6g} leaves/s), stream {stream_ms:.6g}; plain "
          f"version run {plain_ms:.6g}, stream {plain_stream_ms:.6g} ms/iteration [{card}]")
    phase("11 nuts stats", f"the stream's leaf slots live: "
          f"{nuts_shares(cm, 2, es, NUTS_DEPTH)}")
    return run_ms, stream_ms, plain_ms, plain_stream_ms, leaves


def stub_checks(cm):
    """The stubbed product-of-t kernel vs its plain version (fixed-uniform);
    returns (max|dx|, plain ms/iteration at the dossier's settings)."""
    from mjhmc_tpu_torch.models import ProductOfT

    pot = ProductOfT()
    spec = cm.ProductOfTSpec(pot, precision="highest", stub_dots=True)
    args = (spec, *initial_state(pot, 4096, seed=1), 7, 0.12, BETA)
    k = cm.cuda_mjhmc_mm_run(*args, 3, 10, fixed_uniform=True)
    r = cm.run_reference(*args, 3, 10, fixed_uniform=True)
    check(torch.equal(k.evals, r.evals), "stubbed product_of_t: counters differ after 3")
    err = {f: assert_close(getattr(k, f), getattr(r, f), 1e-4, 1e-4 * float(getattr(r, f).abs().max()),
                           f"stubbed product_of_t {f} after 3") for f in ("x", "v", "grad", "u")}
    plain_ms = events_ms(lambda: cm.run_reference(*args, 3, 10)) / 3
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
            "mjhmc_sparse_coding[bf16x3]", "nuts_gauss2d_elementwise"]
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
    return {"launches": launches, "ceilings": ceil,
            "fma_ms": probes["fp32_fma"]["s_per_iter"] * 1e3,
            "tc_ms": probes["tc_depth_128"]["s_per_iter"] * 1e3,
            "stub_ms": 4096 / stub_row["iterations_per_s"] * 1e3}


def energy_ops(cname, d, k):
    """(operations of one gradient with its kick-drift-kick, of one energy
    U) per chain, for a config's energy (d dims, k rows of y or r; the
    mixture's k components), counted from the kernel's code: the
    kick-drift-kick is 6 per dim, an expf or logf one."""
    if cname.startswith("rough_well"):
        return 11 * d, 7 * d
    if cname.startswith("gauss"):
        return 7 * d, 3 * d
    if cname == "funnel":  # one expf; the tail sum, row 0, e·x_i
        return 6 * d + 1 + 2 * (d - 1) + 5 + (d - 1), 2 * (d - 1) + 9
    if cname == "banana":
        return 6 * d + 9, 2 * (d - 2) + 11
    if cname == "mog":  # k logits (2d + 4 each), k expf and a divide; U also a logf
        logits = 2 * d + k * (2 * d + 4) + k
        return 6 * d + logits + 2 * k + 1 + 3 * k + d * (1 + 2 * k), logits + 2 * k + 3
    if cname.startswith("eight_schools"):  # one expf, 8 per school
        return 6 * d + 1 + 8 * (d - 2) + 6, 6 * (d - 2) + 12
    if cname.startswith("product_of_t"):
        return 4 * d * k + 5 * k + 6 * d, 4 * k
    if cname.startswith("logreg"):  # σ(z): exp, add, divide; softplus: max, abs, exp, log1p, add
        return 4 * d * k + 3 * k + 7 * d, 5 * k + 2 * d
    return 4 * d * k + 8 * d + k, 3 * d + 2 * k  # sparse coding


@functools.lru_cache(maxsize=None)
def on_matmul_kernel(cname):
    """Whether a config's energy runs on the matmul kernel (its spec one of
    ``cuda_mjhmc.MATMUL_SPECS``) rather than the elementwise one."""
    from mjhmc_tpu_torch.bench_mm_ab import ew_nuts_dist
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    return isinstance(cm.energy_spec_for(ew_nuts_dist(cname)[0]), cm.MATMUL_SPECS)


def bound(cname, variant, d, k, n, iters, grads, emits=0, stub=False, passes=0,
          peaks=(FP32_PEAK, BF16_PEAK), mass=False):
    """(bound_ms per iteration, "operations" or "bytes") of a run of
    ``iters`` iterations of ``n`` chains that evaluated ``grads`` gradients
    (the run's counters: MJHMC's backward rebuilds, two-stage's two per
    step and NUTS's leaves included) and streamed ``emits`` emissions.
    ``passes`` > 0: the two contractions of every gradient (4·d·k FLOPs)
    run as that many bf16 passes at the bf16 peak of ``peaks`` (FP32,
    bf16), the rest at its FP32 peak. ``mass``: a diagonal M⁻¹ adds d
    multiplies per gradient (the drift's M⁻¹·v) and 2d per chain and
    iteration (the kinetic energies' M⁻¹, the momenta's √M), and its 2d
    floats to the bytes."""
    g, u_ops = energy_ops(cname, d, k)
    if stub:
        g -= 4 * d * k
    kahan = 8 * d + 4
    if variant == "mjhmc":
        m = grads / (n * iters)  # gradients per chain and iteration
        refresh = 0.05  # refreshes per chain and iteration (β·dwell), a floor
        per_iter = 2 * u_ops + 6 * d + kahan + 30 + PHILOX_OPS / 4 + refresh * d * NORMAL_OPS
        ops = grads * g + n * iters * per_iter
    elif variant == "control":
        # the elementwise kernel draws both Box-Muller branches of a pair,
        # ceil(d/2) pairs, the Metropolis uniform a word of their last block;
        # the matmul kernel d cosine branches and a block for the uniform
        draws = (d * NORMAL_OPS + PHILOX_OPS if on_matmul_kernel(cname)
                 else (d + 1) // 2 * PAIR_OPS + PHILOX_OPS / 4)
        per_iter = u_ops + 7 * d + kahan + 20 + draws
        ops = grads * g + n * iters * per_iter
    elif variant == "malt":
        m = grads / (n * iters)
        # the elementwise kernel draws both Box-Muller branches of a pair, M + 1
        # pairs a dim; the matmul kernel (2M + 1)·d cosine branches
        draws = ((2 * m + 1) * d * NORMAL_OPS if on_matmul_kernel(cname)
                 else (m + 1) * d * PAIR_OPS)
        per_iter = m * (u_ops + 10 * d) + kahan + 20 + draws + PHILOX_OPS
        ops = grads * g + n * iters * per_iter
    else:  # nuts: every leaf one gradient, its energy and ~40 of tree work
        ops = grads * (g + u_ops + 2 * d + 40) + n * iters * (d * NORMAL_OPS + kahan)
    nbytes = 4 * (n * (3 * d + 3) + d * k + k + n * (5 * d + 5) + emits * n * (d + 2))
    if mass:
        ops += grads * d + n * iters * 2 * d
        nbytes += 4 * 2 * d
    mm_flops = grads * 4 * d * k if passes else 0
    t_ops = (ops - mm_flops) / peaks[0] + passes * mm_flops / peaks[1]
    t_bytes = nbytes / HBM_RATE
    return max(t_ops, t_bytes) / iters * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def wrappers_for(cm, spec):
    if isinstance(spec, cm.MATMUL_SPECS):
        return cm.cuda_mjhmc_mm_run, cm.cuda_mjhmc_mm_stream_run
    return cm.cuda_mjhmc_run, cm.cuda_mjhmc_stream_run


def moves(xs, x0, x_end=None):
    """(iterations, n) bool: the chain's x moved in the iteration. Control
    and MALT emit the post-transition x (``x0`` the start); MJHMC the
    pre-transition x, so ``x_end`` (the run's final x) closes the last
    iteration. Control and MALT keep x exactly on reject, MJHMC on F and R."""
    if x_end is None:
        return (xs != torch.cat([x0[None], xs[:-1]])).any(dim=1)
    traj = torch.cat([xs, x_end[None]])
    return (traj[1:] != traj[:-1]).any(dim=1)


def stream_within(xs_k, xs_r):
    """(n,) bool: every emitted x of the chain lies within rtol 1e-4 (atol
    1e-4 of the largest) of the plain version's."""
    tol = 1e-4 * float(xs_r.abs().max()) + 1e-4 * xs_r.abs()
    return ((xs_k - xs_r).abs() <= tol).all(dim=1).all(dim=0)


def slice_cases(cm):
    """The slice's bodies and branches at the main paths' widths: (label,
    config, distribution, chains, ε, β, M, iterations held, options)."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    cfg = {c: BENCHMARK_CONFIGS[c] for c in ("rough_well", "gauss50d", "product_of_t",
                                              "sparse_coding", "logreg", "gauss2d")}
    dist = {c: v.make_distribution() for c, v in cfg.items()}
    # the rough well's D=50 instances (no preset: the rough_well preset's ε, M)
    from mjhmc_tpu_torch.models import RoughWell

    cfg["rough_well_d50"], dist["rough_well_d50"] = cfg["rough_well"], RoughWell(ndims=50)
    var_rw50 = tuple(float(v) for v in torch.linspace(0.8, 1.25, 50))
    var50 = tuple(float(v) for v in dist["gauss50d"].analytic_var())
    var_pot = tuple(float(v) for v in dist["product_of_t"].analytic_var())
    sc_mass = tuple(float(v) for v in torch.linspace(0.8, 1.25, 128))
    lr_mass = tuple(float(v) for v in dist["logreg"].laplace_var())
    rows = []
    for label, c, n, beta, kw in (
        ("control", "rough_well", 10_000, 0.2, dict(variant="control")),
        ("malt", "rough_well", 10_000, 1.0, dict(variant="malt")),
        ("mjhmc two_stage", "rough_well", 10_000, 0.1, dict(integrator="two_stage")),
        ("control two_stage", "rough_well", 10_000, 0.2,
         dict(variant="control", integrator="two_stage")),
        ("mjhmc inv_mass", "gauss50d", 4096, 0.1, dict(inv_mass=var50)),
        ("control inv_mass", "gauss50d", 4096, 0.2, dict(variant="control", inv_mass=var50)),
        ("malt inv_mass", "gauss50d", 4096, 1.0, dict(variant="malt", inv_mass=var50)),
        ("control", "product_of_t", 4096, 0.2, dict(variant="control")),
        ("malt", "product_of_t", 4096, 1.0, dict(variant="malt")),
        ("mjhmc two_stage", "product_of_t", 4096, 0.1, dict(integrator="two_stage")),
        ("control two_stage inv_mass", "product_of_t", 4096, 0.2,
         dict(variant="control", integrator="two_stage", inv_mass=var_pot)),
        ("control", "sparse_coding", 8192, 0.2, dict(variant="control")),
        ("malt", "sparse_coding", 8192, 1.0, dict(variant="malt")),
        ("mjhmc inv_mass", "sparse_coding", 8192, 0.1, dict(inv_mass=sc_mass)),
        ("control two_stage inv_mass", "sparse_coding", 8192, 0.2,
         dict(variant="control", integrator="two_stage", inv_mass=sc_mass)),
        # widths that leave mm_kernel's last tile (mm_tile_rule) partly empty
        ("mjhmc ragged", "product_of_t", 4093, 0.1, {}),
        ("control ragged", "product_of_t", 4093, 0.2, dict(variant="control")),
        ("malt ragged", "product_of_t", 4093, 1.0, dict(variant="malt")),
        ("mjhmc ragged", "sparse_coding", 8185, 0.1, {}),
        ("control ragged", "sparse_coding", 8185, 0.2, dict(variant="control")),
        ("malt ragged", "sparse_coding", 8185, 1.0, dict(variant="malt")),
        ("mjhmc ragged", "logreg", 2045, 0.1, {}),
        ("control ragged", "logreg", 2045, 0.2, dict(variant="control")),
        ("malt ragged", "logreg", 2045, 1.0, dict(variant="malt")),
        # slice K: the logreg energy on every body and branch
        ("mjhmc", "logreg", 2048, 0.1, {}),
        ("control", "logreg", 2048, 0.2, dict(variant="control")),
        ("malt", "logreg", 2048, 1.0, dict(variant="malt")),
        ("mjhmc two_stage inv_mass", "logreg", 2048, 0.1,
         dict(integrator="two_stage", inv_mass=lr_mass)),
        ("control two_stage inv_mass", "logreg", 2048, 0.2,
         dict(variant="control", integrator="two_stage", inv_mass=lr_mass)),
        ("malt inv_mass", "logreg", 2048, 1.0, dict(variant="malt", inv_mass=lr_mass)),
        # the elementwise instances no other phase holds against the plain
        # version: the D=2 Gaussian's and the D=50 rough well's
        ("mjhmc", "gauss2d", 10_240, 0.1, {}),
        ("mjhmc inv_mass", "gauss2d", 10_240, 0.1, dict(inv_mass=(1.0, 100.0))),
        ("malt", "gauss2d", 10_240, 1.0, dict(variant="malt")),
        ("control", "gauss2d", 10_240, 0.2, dict(variant="control")),
        ("mjhmc", "rough_well_d50", 4096, 0.1, {}),
        ("mjhmc inv_mass", "rough_well_d50", 4096, 0.1, dict(inv_mass=var_rw50)),
        ("malt inv_mass", "rough_well_d50", 4096, 1.0, dict(variant="malt", inv_mass=var_rw50)),
        ("control", "rough_well_d50", 4096, 0.2, dict(variant="control")),
        ("control two_stage inv_mass", "rough_well_d50", 4096, 0.2,
         dict(variant="control", integrator="two_stage", inv_mass=var_rw50)),
    ):
        # two-stage rough-well trajectories take 2M sin-laden gradients per
        # half, the D=50 rough well's 50 sin-laden dims: their single chains
        # are held after 3 iterations, not 5 (at 5 the D=50 MJHMC rows put
        # ~14 of 4,096 chains' g past rtol 1e-4, as the one-thread-a-chain
        # kernel did, while one ulp of x moves ~1,800 in the plain version
        # alone: bench_mm_ab --only hold)
        chaotic = (c == "rough_well" and "two_stage" in label) or c == "rough_well_d50"
        held = 3 if chaotic else MM_STATE_ITERS.get(c, 5)
        rows.append((f"{c} {label}", c, dist[c], n, cfg[c].epsilon, beta,
                     cfg[c].num_leapfrog_steps, held, kw))
    return rows


def slice_kernel_checks(cm):
    """Phases 15-16: every body and branch of the slice, run and stream
    kernels, against the plain version on the card, from v ~ N(0, M), in
    fixed-uniform mode (15) and in Philox mode (16). Both: Σw = steps and
    evals = M·steps (2M two-stage) for control and MALT; the decisions (x
    moved or not, each iteration; MJHMC also its counters and stream es)
    equal on >= 0.999 of chains; x, v, g, u and every emitted x within rtol
    1e-4 of the plain version's on all but 0.1% of the chains whose
    decisions agree (MJHMC: Σw over those chains rtol 1e-4). Fixed-uniform
    mode: counters and stream es exact. Philox mode: the share of
    iterations that moved x, and what a one-ulp nudge of x does to the
    plain version alone (decisions changed, chains moved past rtol 1e-4),
    which also bounds the chains allowed outside when it exceeds 0.1%.
    The ragged widths (a partly empty last tile of mm_kernel) run in
    fixed-uniform mode only. Returns {label: max |dx| on the fixed-uniform
    chains within}."""
    errs = {}
    for label, cname, dist, n, eps, beta, m, held, kw in slice_cases(cm):
        spec = at(cm.energy_spec_for(dist))
        run, stream = wrappers_for(cm, spec)
        variant = kw.get("variant", "mjhmc")
        cost = (2 if kw.get("integrator") == "two_stage" else 1) * m
        modes = ((True, 7),) if "ragged" in label else ((True, 7), (False, 12345))
        for fixed, seed in modes:
            st = initial_state(dist, n, seed=1 if fixed else 2, inv_mass=kw.get("inv_mass"))
            args = (spec, *st, seed, eps, beta)
            k = run(*args, held, m, fixed_uniform=fixed, **kw)
            xs_k, ws_k, es_k, so_k = stream(*args, held, 1, m, fixed_uniform=fixed, **kw)
            xs_r, ws_r, es_r, r = cm.stream_reference(*args, held, 1, m, fixed, **kw)
            mj = variant == "mjhmc"
            moved_k = moves(xs_k, st[0], so_k.x if mj else None)
            moved_r = moves(xs_r, st[0], r.x if mj else None)
            same = (moved_k == moved_r).all(dim=0)
            if mj:
                same &= (k.evals == r.evals) & (es_k == es_r).all(dim=0)
            else:
                check(bool((k.evals == held * cost).all()) and bool((k.w == held).all())
                      and bool((ws_k == 1).all()), f"{label}: evals must be M*steps, w steps")
            share = float(same.double().mean())
            mode = "fixed-uniform" if fixed else "Philox"
            check(share >= 0.999, f"{label} ({mode}): decisions equal on {share:.5f} of "
                  "chains (< 0.999)")
            if fixed:
                check(torch.equal(k.evals, r.evals) and torch.equal(es_k, es_r)
                      and torch.equal(es_k[-1], k.evals), f"{label}: fixed-uniform counters differ")
            # chaotic energies (the rough well's sin, product of t at its
            # preset ε) move single chains past 1e-4 from a last-ulp
            # difference. Fixed-uniform mode holds all but 0.1% of the
            # chains; Philox mode, whose draws spread the chains over the
            # chaotic region, all but 0.1% or as many as a one-ulp nudge of
            # x moves in the plain version alone, if more
            within = chains_within(k, r) & stream_within(xs_k, xs_r)
            outside = int((~within & same).sum())
            # which fields put those chains outside
            by_field = {f: int((~chains_within(k, r, (f,)) & same).sum())
                        for f in ("x", "v", "grad", "u")}
            by_field["xs"] = int((~stream_within(xs_k, xs_r) & same).sum())
            allowed, ulp = 0.001 * n, ""
            if not fixed:
                nudged = (torch.nextafter(st[0], torch.full_like(st[0], float("inf"))), *st[1:])
                xs_n, _, es_n, r_n = cm.stream_reference(spec, *nudged, seed, eps, beta, held, 1,
                                                         m, False, **kw)
                moved_n = moves(xs_n, nudged[0], r_n.x if mj else None)
                same_n = (moved_n == moved_r).all(dim=0)
                if mj:
                    same_n &= (r_n.evals == r.evals) & (es_n == es_r).all(dim=0)
                drift = int((~(chains_within(r_n, r) & stream_within(xs_n, xs_r)) & same_n).sum())
                allowed = max(allowed, drift)
                ulp = (f"; a one-ulp nudge of x changes {int((~same_n).sum())} chains' decisions "
                       f"and moves {drift} more past rtol 1e-4 in the plain version alone")
            check(outside <= allowed, f"{label} ({mode}): {outside} chains with equal "
                  f"decisions outside rtol 1e-4 (states or stream xs; by field "
                  f"{json.dumps(by_field)}), {allowed:g} allowed")
            ok = within & same
            if mj:  # dwell weights: their sum over those chains
                assert_close(k.w[ok].sum(), r.w[ok].sum(), 1e-4, 0.0, f"{label} sum of w")
            err = float((k.x - r.x).abs()[:, ok].max())
            what = (f"{label} ({n} chains, eps {eps}, beta {beta}, M {m}, {held} iterations): "
                    f"decisions equal on {share:.5f} ({int((~same).sum())} chains differ); "
                    f"x,v,g,u and stream xs rtol 1e-4 on all but {outside} of the chains "
                    f"with equal decisions (by field {json.dumps(by_field)}; max|dx| {err:.3g} "
                    f"on the others)")
            if fixed:
                errs[label] = err
                phase("15 slice fixed-uniform", f"{what}; evals and stream es exact")
            else:
                phase("16 slice philox", f"{what}; x moved on "
                      f"{float(moved_r.double().mean()):.4f} of chain-iterations{ulp}")
    return errs


def nuts_mass_checks(cm):
    """The NUTS body with an inverse mass, bit-identical to its plain
    version in both modes (gauss2d at the CLI's width, gauss50d)."""
    from mjhmc_tpu_torch.models import Gaussian

    for cname, dist, eps, n, mass in (
        ("gauss2d", Gaussian(ndims=2, log_conditioning=2.0), 0.5, 10_240, (1.0, 100.0)),
        ("gauss50d", Gaussian(ndims=50, log_conditioning=4.0), 0.5, 4096, None),
    ):
        mass = mass or tuple(float(v) for v in dist.analytic_var())
        spec = cm.energy_spec_for(dist)
        for fixed in (True, False):
            args = (spec, *initial_state(dist, n, seed=8), 99, eps, 0.0)
            kw = dict(variant="nuts", inv_mass=mass)
            k = cm.cuda_mjhmc_run(*args, 3, CLI_NUTS_DEPTH, fixed_uniform=fixed, **kw)
            xs_k, _, es_k, _ = cm.cuda_mjhmc_stream_run(*args, 3, 1, CLI_NUTS_DEPTH,
                                                        fixed_uniform=fixed, **kw)
            xs_r, _, es_r, r = cm.stream_reference(*args, 3, 1, CLI_NUTS_DEPTH, fixed,
                                                   inv_mass=mass, variant="nuts")
            identical = torch.equal(es_k, es_r) and torch.equal(xs_k, xs_r) and all(
                torch.equal(getattr(k, f), getattr(r, f)) for f in ("x", "v", "grad", "u", "evals"))
            check(identical, f"NUTS inv_mass {cname} (fixed={fixed}): not bit-identical")
            phase("17 nuts inv_mass", f"{cname} ({n} chains, eps {eps}, max_depth "
                  f"{CLI_NUTS_DEPTH}, M^-1 = the variances, fixed={fixed}): leaf counts, x, v, "
                  f"g, u and stream bit-identical ({float(r.evals.double().mean()) / 3:.4g} "
                  "leaves/iteration)")


def counts(cm, attr, mm=False):
    fns = (cm.cuda_mjhmc_mm_run, cm.cuda_mjhmc_mm_stream_run) if mm else \
        (cm.cuda_mjhmc_run, cm.cuda_mjhmc_stream_run)
    return tuple(getattr(f, attr) for f in fns)


def slice_stats(cm, card):
    """Phase 18: the engines' statistics. Control and MALT on gauss2d within
    5% of [1, 100] with Σw = steps and evals = M·steps exactly; MALT at γ=0
    against control at β=1; control, two-stage MJHMC and two-stage control
    on rough_well within 5% of quadrature; MJHMC with M⁻¹ = the variances on
    gauss50d (elementwise) within 5% and on product_of_t (matmul kernel)
    with the median within 15% of analytic. Returns the inverse-mass runs'
    launches and gradients per chain and iteration."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    def run(ecls, cname, n, burn, steps, **kw):
        cfg = BENCHMARK_CONFIGS[cname]
        dist = cfg.make_distribution()
        kw = {"epsilon": cfg.epsilon, "num_leapfrog_steps": cfg.num_leapfrog_steps, **kw}
        eng = ecls(dist, nbatch=n, seed=5, device="cuda", **kw)
        eng.run(burn)
        out = eng.run(steps)
        _, var = cm.CudaMJHMC.moments(out)
        return eng, out, var.double() / dist.analytic_var().double().cuda()

    res = {}
    for ecls, beta in ((cm.CudaControlHMC, 0.2), (cm.CudaMALT, 1.0)):
        eng, out, ratio = run(ecls, "gauss2d", 10_240, 200, 2000, beta=beta)
        m = eng.num_leapfrog_steps
        check(bool((out.w == 2000).all()) and bool((out.evals == m * 2000).all()),
              f"{ecls.__name__} gauss2d: w must be steps, evals M*steps")
        check(bool(((ratio - 1).abs() < 0.05).all()), f"{ecls.__name__} gauss2d var/analytic "
              f"{ratio.tolist()}: outside 5%")
        phase("18 slice stats", f"{ecls.__name__} gauss2d (10,240 chains, beta {beta}, 200 + "
              f"2000): var/analytic {[round(x, 5) for x in ratio.tolist()]}; w == steps, "
              "evals == M*steps")
    _, _, r_malt = run(cm.CudaMALT, "gauss2d", 10_240, 200, 2000, beta=0.0)
    _, _, r_hmc = run(cm.CudaControlHMC, "gauss2d", 10_240, 200, 2000, beta=1.0)
    check(bool(((r_malt - 1).abs() < 0.05).all()) and bool(((r_malt / r_hmc - 1).abs() < 0.05).all()),
          f"MALT gamma 0 {r_malt.tolist()} vs control beta 1 {r_hmc.tolist()}: outside 5%")
    phase("18 slice stats", f"gauss2d MALT gamma=0 var/analytic {[round(x, 5) for x in r_malt.tolist()]}"
          f", control beta=1 {[round(x, 5) for x in r_hmc.tolist()]}")
    for ecls, beta, integrator in ((cm.CudaControlHMC, 0.1, "leapfrog"),
                                   (cm.CudaMJHMC, 0.1, "two_stage"),
                                   (cm.CudaControlHMC, 0.1, "two_stage")):
        eng, out, ratio = run(ecls, "rough_well", 10_000, 200, 2000, beta=beta,
                              integrator=integrator)
        m = (2 if integrator == "two_stage" else 1) * eng.num_leapfrog_steps
        extra = out.evals - m * 2000
        ok = bool((extra == 0).all()) if ecls is cm.CudaControlHMC else \
            bool((extra >= 0).all()) and bool((extra % m == 0).all())
        check(ok, f"{ecls.__name__} {integrator} rough_well: evals not exact")
        check(bool(((ratio - 1).abs() < 0.05).all()), f"{ecls.__name__} {integrator} rough_well "
              f"var/quadrature {ratio.tolist()}: outside 5%")
        phase("18 slice stats", f"{ecls.__name__} {integrator} rough_well (10,000 chains, beta "
              f"{beta}, 200 + 2000): var/quadrature {[round(x, 5) for x in ratio.tolist()]}; "
              f"evals exact ({'M' if integrator == 'leapfrog' else '2M'} per half)")
    # the inverse-mass main paths: the engine as from_warmup would hand it
    # M⁻¹; launch counts set to 0 just before
    for cname, n, eps, tol in (("gauss50d", 4096, 0.5, 0.05), ("product_of_t", 4096, 0.06, 0.15)):
        dist = BENCHMARK_CONFIGS[cname].make_distribution()
        mm = cname == "product_of_t"
        cm.reset_counts()
        eng, out, ratio = run(cm.CudaMJHMC, cname, n, 200, 1000, epsilon=eps, beta=0.1,
                              inv_mass=tuple(float(v) for v in dist.analytic_var()))
        res[cname] = (counts(cm, "mass_launches", mm), float(out.evals.double().mean()) / 1000)
        bad = (ratio - 1).abs() >= tol if not mm else (ratio.median() - 1).abs() >= tol
        check(not bool(bad.any()), f"{cname} inv_mass var/analytic {ratio.tolist()}: outside "
              f"{tol:.0%}")
        phase("18 slice stats", f"CudaMJHMC {cname} with M^-1 = the variances ({n} chains, eps "
              f"{eps}, 200 + 1000): var/analytic {'median ' if mm else 'max dev '}"
              f"{float(ratio.median() if mm else (ratio - 1).abs().max()):.5f}; launches "
              f"(run, stream) {res[cname][0]}")
    return res


def slice_cli(cm, cli):
    """Phase 19: `sample --sampler control|malt` on rough_well, product_of_t
    and sparse_coding, `--integrator two_stage` (MJHMC and control) on
    rough_well and product_of_t, and MJHMC's on sparse_coding and logreg;
    every count set to 0 just before each call. Returns {(sampler, config,
    integrator): (record, counts, seconds)}; the matmul presets' counts
    include "precision", the launches at the preset's JAX default precision
    (all of them)."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    jax_default, _ = mm_precisions(cm)
    out = {}
    calls = [(s, c, "leapfrog") for s in ("control", "malt")
             for c in ("rough_well", "product_of_t", "sparse_coding")]
    calls += [(s, c, "two_stage") for s in ("mjhmc", "control") for c in ("rough_well", "product_of_t")]
    calls += [("mjhmc", c, "two_stage") for c in ("sparse_coding", "logreg")]
    for sampler, cname, integrator in calls:
        cfg = BENCHMARK_CONFIGS[cname]
        burn, steps = (200, 200) if cname == "sparse_coding" else (500, 1000)
        cm.reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli(["sample", "--config", cname, "--engine", "cuda", "--sampler", sampler,
                 "--integrator", integrator, "--burn", str(burn), "--steps", str(steps)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        mm = cname != "rough_well"
        attr = "launches" if sampler == "mjhmc" else f"{sampler}_launches"
        c = {"body": counts(cm, attr, mm), "two_stage": counts(cm, "two_stage_launches", mm)}
        check(all(v > 0 for v in c["body"]) and (integrator == "leapfrog" or all(c["two_stage"])),
              f"{sampler} {cname} {integrator}: kernels not launched: {c}")
        if mm:
            c["precision"] = counts(cm, f"{jax_default[cname]}_launches", mm)
            check(c["precision"] == c["body"], f"{sampler} {cname}: not all launches at "
                  f"{jax_default[cname]}: {c}")
        m = (2 if integrator == "two_stage" else 1) * cfg.num_leapfrog_steps
        n = cfg.nbatch
        ge = rec["grad_evals"]
        exact = ge == m * (burn + steps) * n if sampler != "mjhmc" else \
            ge >= m * (burn + steps) * n and ge % m == 0
        check(exact and rec["chains"] == n and rec["ess"] > 0
              and all(v > 0 and v == v for v in rec["var"]), f"bad CLI record {rec}")
        if cname == "rough_well":
            target = BENCHMARK_CONFIGS[cname].make_distribution().analytic_var().tolist()
            check(all(abs(v / t - 1) < 0.05 for v, t in zip(rec["var"], target)),
                  f"{sampler} {integrator} rough_well CLI var {rec['var']}: outside 5%")
        out[(sampler, cname, integrator)] = (rec, c, seconds)
        phase("19 slice cli", f"{json.dumps(rec)}; launches {c}; {seconds:.4g} s host clock")
    return out


def slice_timing(cm, card):
    """Phase 20: ms per iteration (CUDA events) of each new body and branch,
    run and stream kernels, beside the plain version, at the main paths'
    widths; with the gradients per chain and iteration of the timed run."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    rows = {}
    mass_of = {c: tuple(float(v) for v in BENCHMARK_CONFIGS[c].make_distribution().analytic_var())
               for c in ("gauss50d", "product_of_t")}
    for key, cname, n, beta, kw in (
        ("control", "rough_well", 10_000, 0.1, dict(variant="control")),
        ("malt", "rough_well", 10_000, 1.0, dict(variant="malt")),
        ("control", "product_of_t", 4096, 0.1, dict(variant="control")),
        ("malt", "product_of_t", 4096, 1.0, dict(variant="malt")),
        ("control", "sparse_coding", 8192, 0.1, dict(variant="control")),
        ("malt", "sparse_coding", 8192, 1.0, dict(variant="malt")),
        ("two_stage", "rough_well", 10_000, 0.1, dict(integrator="two_stage")),
        ("two_stage", "product_of_t", 4096, 0.1, dict(integrator="two_stage")),
        ("inv_mass", "gauss50d", 4096, 0.1, dict(inv_mass=mass_of["gauss50d"])),
        ("inv_mass", "product_of_t", 4096, 0.1, dict(inv_mass=mass_of["product_of_t"])),
        # control's branch instances on the elementwise kernel
        ("control two_stage", "rough_well", 10_000, 0.1,
         dict(variant="control", integrator="two_stage")),
        ("control inv_mass", "gauss50d", 4096, 0.1,
         dict(variant="control", inv_mass=mass_of["gauss50d"])),
    ):
        cfg = BENCHMARK_CONFIGS[cname]
        dist = cfg.make_distribution()
        m = cfg.num_leapfrog_steps
        iters = {"rough_well": 2000, "gauss50d": 200, "product_of_t": 500}.get(cname, 100)
        if kw.get("variant") == "malt" and cname != "rough_well":
            iters //= 4
        eng = cm.CudaMJHMC(dist, epsilon=cfg.epsilon, beta=beta, num_leapfrog_steps=m,
                           nbatch=n, seed=4, device="cuda", **kw)
        eng.spec = at(eng.spec)
        eng.run(10)
        before = eng.grad_evals
        run_ms = events_ms(lambda: eng.run(iters)) / iters
        grads = eng.grad_evals - before
        stream_ms = events_ms(lambda: eng.sample(iters)) / iters
        args = (eng.spec, *initial_state(dist, n, seed=5), 99, cfg.epsilon, beta)
        cm.run_reference(*args, 1, m, **kw)
        plain_ms = events_ms(lambda: cm.run_reference(*args, 3, m, **kw)) / 3
        plain_stream_ms = events_ms(lambda: cm.stream_reference(*args, 3, 1, m, **kw)) / 3
        rows[(key, cname)] = (run_ms, stream_ms, plain_ms, plain_stream_ms, grads, iters, n)
        phase("20 slice timing", f"{key} {cname} ({n} chains, eps {cfg.epsilon}, beta {beta}, "
              f"M {m}): run {run_ms:.6g} ms/iteration, stream (thin 1) {stream_ms:.6g}; plain "
              f"version run {plain_ms:.6g}, stream {plain_stream_ms:.6g} ms/iteration; "
              f"{grads / (n * iters):.4g} gradients per chain and iteration [{card}]")
    return rows


def mm_nuts_cases():
    """The matmul NUTS body at the presets' widths: (label, config,
    distribution, chains, ε, max_depth, (fixed-uniform, Philox) iterations,
    M⁻¹). Product of t at ε 0.12 (ε·ω ≈ 1.2 < 2; its preset 0.2 is
    unstable). Fixed-uniform mode gives every chain the momentum 5.9 in every
    dim and takes every leaf, so product of t and sparse coding run full
    trees (255 and ~243 leaves) far out from the bulk: one iteration. There
    last-ulp differences carry nearly every product-of-t chain past rtol
    1e-4 (as one-ulp nudges do to the plain version alone), so its states
    are also held at max_depth 4 (15 leaves), with and without a mass. Each
    preset runs again at a width that leaves its last NUTS tile (8 or 16
    chains) partly empty: 4,093, 8,185 and 2,045 chains."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    dist = {c: BENCHMARK_CONFIGS[c].make_distribution()
            for c in ("product_of_t", "sparse_coding", "logreg")}
    lr_mass = tuple(float(v) for v in dist["logreg"].laplace_var())
    pot_mass = tuple(float(v) for v in dist["product_of_t"].analytic_var())
    return (
        ("product_of_t", "product_of_t", dist["product_of_t"], 4096, 0.12, MM_NUTS_DEPTH, (1, 2),
         None),
        ("product_of_t max_depth 4", "product_of_t", dist["product_of_t"], 4096, 0.12, 4, (2, 3),
         None),
        ("product_of_t max_depth 4 inv_mass", "product_of_t", dist["product_of_t"], 4096, 0.12,
         4, (2, 3), pot_mass),
        ("sparse_coding", "sparse_coding", dist["sparse_coding"], 8192, 0.02, MM_NUTS_DEPTH,
         (1, 2), None),
        ("logreg", "logreg", dist["logreg"], 2048, 0.15, MM_NUTS_DEPTH, (3, 3), None),
        ("logreg inv_mass", "logreg", dist["logreg"], 2048, 0.15, MM_NUTS_DEPTH, (3, 3),
         lr_mass),
        ("product_of_t partial last tile", "product_of_t", dist["product_of_t"], 4093, 0.12,
         MM_NUTS_DEPTH, (1, 2), None),
        ("sparse_coding partial last tile", "sparse_coding", dist["sparse_coding"], 8185, 0.02,
         MM_NUTS_DEPTH, (1, 2), None),
        ("logreg partial last tile", "logreg", dist["logreg"], 2045, 0.15, MM_NUTS_DEPTH, (3, 3),
         None),
    )


def mm_nuts_checks(cm):
    """Phase 21: the matmul kernel's NUTS body, run and stream, against its
    plain version on the card, in fixed-uniform mode and in Philox mode.
    The contractions sum in another order than torch.matmul and a tree
    decision flips with the last ulp of H, so: per-chain leaf counts (and
    stream es) equal on all but 0.1% of the chains, or as many as one-ulp
    nudges of x (up, down) change in the plain version alone, if more; x, v,
    g, u and every emitted x within rtol 1e-4 (atol 1e-4 of the field's
    largest value) on the chains whose counts agree, all but 0.1% or as
    many as the nudges move past it (the nudged plain runs are made only
    where a count passes 0.1% of the chains); w = steps, ws = 1, es[-1] =
    evals. Returns {label: max |dx| on the chains within}."""
    errs = {}
    for label, _, dist, n, eps, depth, both_iters, mass in mm_nuts_cases():
        spec = at(cm.energy_spec_for(dist))
        kw = dict(variant="nuts", inv_mass=mass)
        for fixed, seed, iters in ((True, 7, both_iters[0]), (False, 12345, both_iters[1])):
            st = initial_state(dist, n, seed=1 if fixed else 2, inv_mass=mass)
            args = (spec, *st, seed, eps, 0.0)
            k = cm.cuda_mjhmc_mm_run(*args, iters, depth, fixed_uniform=fixed, **kw)
            xs_k, ws_k, es_k, so_k = cm.cuda_mjhmc_mm_stream_run(*args, iters, 1, depth,
                                                                 fixed_uniform=fixed, **kw)
            xs_r, _, es_r, r = cm.stream_reference(*args, iters, 1, depth, fixed, **kw)
            mode = "fixed-uniform" if fixed else "Philox"
            what = f"NUTS {label} ({n} chains, eps {eps}, max_depth {depth}, {mode})"
            check(bool((k.w == iters).all()) and bool((ws_k == 1).all())
                  and torch.equal(es_k[-1], so_k.evals), f"{what}: w, ws or es[-1]")
            same = (k.evals == r.evals) & (es_k == es_r).all(dim=0)
            within = chains_within(k, r) & stream_within(xs_k, xs_r)
            flips, drift = torch.zeros_like(same), torch.zeros_like(same)
            differ, outside = int((~same).sum()), int((same & ~within).sum())
            # the nudged plain runs only where a count passes 0.1% of the chains
            nudges_run = max(differ, outside) > 0.001 * n
            for to in (float("inf"), float("-inf")) if nudges_run else ():
                nudged = (torch.nextafter(st[0], torch.full_like(st[0], to)), *st[1:])
                xs_n, _, es_n, r_n = cm.stream_reference(spec, *nudged, seed, eps, 0.0, iters, 1,
                                                         depth, fixed, **kw)
                same_n = (r_n.evals == r.evals) & (es_n == es_r).all(dim=0)
                flips |= ~same_n
                drift |= same_n & ~(chains_within(r_n, r) & stream_within(xs_n, xs_r))
            allow_counts = max(0.001 * n, int(flips.sum()))
            allow_states = max(0.001 * n, int(drift.sum()))
            check(differ <= allow_counts, f"{what}: leaf counts differ on {differ} chains, "
                  f"{allow_counts:g} allowed")
            check(outside <= allow_states, f"{what}: {outside} chains with equal counts outside "
                  f"rtol 1e-4, {allow_states:g} allowed")
            ok = same & within
            dx = (k.x - r.x).abs()
            err = float(dx[:, ok].max()) if bool(ok.any()) else float(dx.max())
            errs[label] = max(errs.get(label, 0.0), err)
            leaves = float(r.evals.double().mean()) / iters
            phase("21 mm nuts", f"{what}, {iters} iterations, {leaves:.4g} leaves/iteration: "
                  f"leaf counts and stream es equal on {1 - differ / n:.5f} of chains; x,v,g,u "
                  f"and stream xs rtol 1e-4 on all but {outside} of those (max|dx| {err:.3g}); "
                  + (f"one-ulp nudges of x change {int(flips.sum())} chains' counts and move "
                     f"{int(drift.sum())} more past rtol 1e-4 in the plain version alone"
                     if nudges_run else "no nudged runs needed (within 0.1%)"))
    return errs


#: phase 21's trees past the tile depth (max_depth 14, MM_DEEP_DEPTH: the
#: DEEP instances, their stack rows and span slots past 12 in the device
#: buffer) and at 12 (the instances every tree to 12 without a mass runs: product of t at `highest` and sparse coding's
#: scratch tile at `bf16x3` fixed-uniform at the ε of the parent's depth-12
#: cases, and product of t `default`'s timed launch): (config, precision,
#: fixed-uniform, chains, ε, max_depth), one iteration each. Product of t
#: runs at 14 in Philox mode only: its fixed-uniform tree at 14 (16,383
#: leaves at ε 0.00025) was the phase's longest plain run, and the same
#: DEEP instance runs its Philox case and the timed launches. The depth-14
#: trees span the time the depth-12 cases' did (ε a quarter of theirs): at
#: product of t's ε 0.001 the fixed-uniform trees' 16,383 leaves carry the
#: chains so far into the tails that one-ulp nudges of x alone move 13 of
#: the 16 past rtol 1e-4 at `default` on the H100 (PERF.md §6), and a case
#: like that cannot tell a wrong kernel. Fixed-uniform momenta (5.9 in every
#: dim) carry every product-of-t tree to the 16,383-leaf cap and every
#: sparse-coding tree into round 14 (a quarter to the cap); Philox momenta
#: turn sooner (the plain version on the CPU: product of t 11 of 16 trees
#: at the cap, 4 turned in round 12; sparse coding, over two of its tiles
#: at a smaller ε, 9 of 32 at the cap, none short of round 13)
MM_NUTS_DEEP = (("product_of_t", "highest", False, 16, 0.0005, MM_DEEP_DEPTH),
                ("product_of_t", "default", False, 16, 0.0005, MM_DEEP_DEPTH),
                ("sparse_coding", "bf16x3", True, 16, 0.0005, MM_DEEP_DEPTH),
                ("sparse_coding", "bf16x3", False, 32, 0.000005, MM_DEEP_DEPTH),
                ("product_of_t", "highest", True, 16, 0.001, 12),
                ("sparse_coding", "bf16x3", True, 16, 0.002, 12),
                ("product_of_t", "default", False, 16, 0.002, 12))


def deep_plain(cname, prec, arrays, seed, eps, fixed, depth, nudge=0.0):
    """One plain run of a ``MM_NUTS_DEEP`` case on the CPU, a worker
    process's job: ``arrays`` the (x, v, g, u, h_back, valid) NumPy start,
    x moved one ulp toward ``nudge`` (±inf) where it is not 0. Returns
    (xs, es, RunOut's fields, host ms) as NumPy arrays."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    torch.set_num_threads(1)
    spec = at(cm.energy_spec_for(BENCHMARK_CONFIGS[cname].make_distribution()), prec)
    st = [torch.from_numpy(a) for a in arrays]
    if nudge:
        st[0] = torch.nextafter(st[0], torch.full_like(st[0], nudge))
    t0 = time.perf_counter()
    xs, _, es, r = cm.stream_reference(spec, *st, seed, eps, 0.0, 1, 1, depth, fixed,
                                       variant="nuts")
    ms = (time.perf_counter() - t0) * 1e3
    return xs.numpy(), es.numpy(), tuple(t.numpy() for t in r), ms


def mm_nuts_deep_checks(cm, meanwhile):
    """Phase 21 past the tile depth: ``nuts_mm_kernel``, run and stream,
    against its plain version on ``MM_NUTS_DEEP``'s cases (tree rows on chip
    for product of t, the rows past 12 in the device scratch; all of them
    there for sparse coding), both random modes, with ``mm_nuts_checks``'s
    allowances; fails unless some tree began the last round and some ran
    the 2^max_depth − 1 leaves of the cap. The plain
    version runs on the CPU in worker processes (its cost is per leaf, the
    chains are few), a run a job: every case's run and its two one-ulp-nudged
    runs are submitted before ``meanwhile()`` (the rest of phase 21's checks,
    on the card meanwhile); a case's nudged runs are read only where its
    counts or states fall outside the 0.1% allowance without them, and those
    not yet started are cancelled where they are not. Returns ({label: max |dx|}, {max_depth:
    (run ms, stream ms, plain ms, leaves, chains, ε)}, what ``meanwhile``
    returned), the product-of-t `default` Philox cases' times by CUDA
    events (one launch each) and the host clock (the plain stream)."""
    import multiprocessing

    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    t0 = time.perf_counter()
    cases = []
    for cname, prec, fixed, n, eps, depth in MM_NUTS_DEEP:
        dist = BENCHMARK_CONFIGS[cname].make_distribution()
        spec = at(cm.energy_spec_for(dist), prec)
        seed = 7 if fixed else 12345
        st = initial_state(dist, n, seed=1 if fixed else 2)
        args = (spec, *st, seed, eps, 0.0)
        k = cm.cuda_mjhmc_mm_run(*args, 1, depth, fixed_uniform=fixed, variant="nuts")
        stream = cm.cuda_mjhmc_mm_stream_run(*args, 1, 1, depth, fixed_uniform=fixed,
                                             variant="nuts")
        job = (cname, prec, tuple(t.cpu().numpy() for t in st), seed, eps, fixed, depth)
        cases.append((cname, prec, n, fixed, eps, depth, args, k, stream, job))

    def plain(out):
        xs, es, r, ms = out
        return (torch.from_numpy(xs).to(DEV), torch.from_numpy(es).to(DEV),
                cm.RunOut(*(torch.from_numpy(t).to(DEV) for t in r)), ms)

    errs, times = {}, {}
    with concurrent.futures.ProcessPoolExecutor(
            max(1, (os.cpu_count() or 2) - 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        base = [pool.submit(deep_plain, *c[-1]) for c in cases]
        every = [[pool.submit(deep_plain, *c[-1], to) for to in (math.inf, -math.inf)]
                 for c in cases]
        other = meanwhile()
        refs = [plain(f.result()) for f in base]
        outside = []
        for c, (xs_r, es_r, r, _) in zip(cases, refs):
            k, (xs_k, _, es_k, _) = c[7], c[8]
            same = (k.evals == r.evals) & (es_k == es_r).all(dim=0)
            within = chains_within(k, r) & stream_within(xs_k, xs_r)
            outside.append((same, within))
        nudged = {i: every[i] for i, (c, (same, within)) in enumerate(zip(cases, outside))
                  if int((~same).sum()) > 0.001 * c[2] or int((same & ~within).sum()) > 0.001 * c[2]}
        for i, runs in enumerate(every):
            for f in runs if i not in nudged else ():
                f.cancel()
        for i, (c, (xs_r, es_r, r, plain_ms), (same, within)) in enumerate(
                zip(cases, refs, outside)):
            cname, prec, n, fixed, eps, depth, args, k, (xs_k, ws_k, es_k, so_k), _ = c
            mode = "fixed-uniform" if fixed else "Philox"
            what = f"NUTS {cname} {prec} ({n} chains, eps {eps}, max_depth {depth}, {mode})"
            check(bool((k.w == 1).all()) and bool((ws_k == 1).all())
                  and torch.equal(es_k[-1], so_k.evals), f"{what}: w, ws or es[-1]")
            differ, out_n = int((~same).sum()), int((same & ~within).sum())
            flips, drift = torch.zeros_like(same), torch.zeros_like(same)
            note = "not needed"
            if i in nudged:
                for f in nudged[i]:
                    xs_n, es_n, r_n, _ = plain(f.result())
                    same_n = (r_n.evals == r.evals) & (es_n == es_r).all(dim=0)
                    flips |= ~same_n
                    drift |= same_n & ~(chains_within(r_n, r) & stream_within(xs_n, xs_r))
                note = (f"change {int(flips.sum())} chains' counts and move "
                        f"{int(drift.sum())} more past rtol 1e-4 in the plain version alone")
            allow_counts = max(0.001 * n, int(flips.sum()))
            allow_states = max(0.001 * n, int(drift.sum()))
            check(differ <= allow_counts, f"{what}: leaf counts differ on {differ} chains, "
                  f"{allow_counts:g} allowed")
            check(out_n <= allow_states, f"{what}: {out_n} chains with equal counts outside "
                  f"rtol 1e-4, {allow_states:g} allowed")
            began = rounds_begun(es_r.cpu())
            r_before, r_last = (float((began >= j).double().mean()) for j in (depth - 1, depth))
            cap = float((r.evals == 2**depth - 1).double().mean())
            check(r_last > 0 and cap > 0, f"{what}: {r_last:.4f} of trees began round {depth} "
                  f"and {cap:.4f} ran the {2**depth - 1}-leaf cap: the deepest rounds went "
                  "untested")
            ok = same & within
            dx = (k.x - r.x).abs()
            err = float(dx[:, ok].max()) if bool(ok.any()) else float(dx.max())
            label = f"{cname} {prec} max_depth {depth}"
            errs[label] = max(errs.get(label, 0.0), err)
            leaves = float(r.evals.double().mean())
            if cname == "product_of_t" and prec == "default" and not fixed:
                times[depth] = (
                    events_ms(lambda: cm.cuda_mjhmc_mm_run(*args, 1, depth, variant="nuts")),
                    events_ms(lambda: cm.cuda_mjhmc_mm_stream_run(*args, 1, 1, depth,
                                                                  variant="nuts")),
                    plain_ms, leaves, n, eps)
            phase("21 mm nuts", f"{what}, 1 iteration, {leaves:.5g} leaves/iteration: leaf "
                  f"counts and stream es equal on {1 - differ / n:.5f} of chains; x,v,g,u and "
                  f"stream xs rtol 1e-4 on all but {out_n} of those (max|dx| {err:.3g}); "
                  f"trees that began round {depth - 1} {r_before:.4f}, round {depth} "
                  f"{r_last:.4f}, ran the {2**depth - 1}-leaf cap {cap:.4f}; one-ulp nudges "
                  f"of x: {note} (the plain version on the CPU, {plain_ms / 1e3:.3g} s)")
    stop_children()  # the spawn pool's resource tracker
    phase("21 mm nuts", f"the trees past round 10 took {time.perf_counter() - t0:.4g} s, the "
          "rest of phase 21's checks beside their plain runs")
    return errs, times, other


def mm_nuts_deep_timing(cm, card):
    """One launch of ``nuts_mm_kernel`` at each of MM_DEEP_TIMED's depths
    (12 on the instance every shallower tree runs, 13-14 on the DEEP one) on
    product of t at the preset's chains and JAX default precision (4,096,
    one bf16 pass), ε 0.002 (Philox), each after a warm one: CUDA events,
    the trees' leaves, the bound, the blocks an SM holds at depths 10-14
    (``nuts_mm_tile``). Returns {max_depth: its record}."""
    from mjhmc_tpu_torch.bench_mfu import PASSES
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    n, eps = BENCHMARK_CONFIGS["product_of_t"].nbatch, 0.002
    dist = BENCHMARK_CONFIGS["product_of_t"].make_distribution()
    spec = cm.energy_spec_for(dist)
    st = initial_state(dist, n, seed=3)
    blocks = {dd: cm.nuts_mm_tile(spec, dd)[3] for dd in (10, 11, 12, 13, 14)}
    recs = {}
    for depth in MM_DEEP_TIMED:
        call = functools.partial(cm.cuda_mjhmc_mm_run, spec, *st, 99, eps, 0.0, 1, depth,
                                 variant="nuts")
        call()
        out = None

        def run():
            nonlocal out
            out = call()
        ms = events_ms(run)
        leaves = float(out.evals.double().mean())
        bnd = bound("product_of_t", "nuts", 36, 36, n, 1, int(out.evals.sum()),
                    passes=PASSES[spec.precision])
        phase("21 mm nuts", f"nuts_mm_kernel product_of_t {spec.precision} ({n} chains, eps "
              f"{eps}, max_depth {depth}, Philox), one launch of 1 iteration: {ms:.6g} ms, "
              f"{leaves:.5g} leaves a chain (deepest {int(out.evals.max())}), bound "
              f"{bnd[0]:.4g} ms ({bnd[1]}); blocks an SM at max_depth 10-14: {blocks} [{card}]")
        recs[depth] = dict(ms=ms, leaves=leaves, bound=bnd, blocks=blocks, n=n, eps=eps,
                           precision=spec.precision)
    return recs


def leaf_slot_share(es, depth, tile):
    """Share of the leaf slots a tile of ``tile`` chains ran that were live,
    from a stream's cumulative leaf counts ``es`` (E, n): round j of a tile
    runs as many leaf steps as its chain with the most leaves in that round
    (a chain with nl leaves in the iteration spent clamp(nl − 2^j + 1, 0,
    2^j) of them in round j), every column each step."""
    nl = torch.diff(es.long(), dim=0, prepend=torch.zeros_like(es[:1]).long())
    n = nl.shape[1]
    nl = torch.nn.functional.pad(nl, (0, (-n) % tile)).reshape(nl.shape[0], -1, tile)
    steps = sum((nl - (2**j - 1)).clamp(0, 2**j).amax(dim=-1) for j in range(depth))
    return float(nl.sum()) / float(tile * steps.sum())


def lane_leaf_share(leaves, lanes):
    """Share of the leaf slots a warp of ``lanes`` chains would run live if
    each lane ran on into its next round and iteration at once: a warp runs
    as many leaf steps as its lanes' largest count of leaves over the run,
    every lane each step, from each chain's leaves ``leaves`` (n,) (a run's
    evals); the last warp counts its live lanes."""
    nl = leaves.long()
    n = nl.shape[0]
    per = torch.nn.functional.pad(nl, (0, (-n) % lanes)).reshape(-1, lanes)
    live = torch.nn.functional.pad(torch.ones_like(nl), (0, (-n) % lanes)).reshape(-1, lanes)
    return float(nl.sum()) / float((per.amax(dim=1) * live.sum(dim=1)).sum())


def nuts_shares(cm, d, es, depth):
    """The leaf slots live in the elementwise NUTS kernel's warps over a
    stream's cumulative leaf counts ``es`` (E, n), its lanes in step round
    by round (``leaf_slot_share``) in its blocks, beside what lanes that ran
    on at once would keep (``lane_leaf_share``)."""
    n = es.shape[1]
    t = cm.nuts_threads(d, n, torch.cuda.get_device_properties(0).multi_processor_count)
    return (f"{leaf_slot_share(es, depth, t):.4f} in {t}-thread blocks (lanes that ran on at "
            f"once would keep {lane_leaf_share(es[-1], t):.4f})")




def slice_k_stats(cm, plain):
    """Phase 22: the statistics of slice K. CudaNUTS on product_of_t (the
    settings of tests/test_pallas_engine.py:892-923): the median of
    var/analytic within 15% and mean leaves per iteration within 12% of the
    plain NUTS sampler (``plain``: its run on the CPU in phase 2,
    ``PLAIN_NUTS``); CudaMJHMC (ε 0.25, β 0.15, M 10, 2,048
    chains, 400 + 1500, as :548-557) and CudaNUTS on logreg: the median of
    var/laplace_var within 25%; both from_warmup engines: ε > 0, M⁻¹ > 0
    and the same bounds after a short run, then 20 iterations of samples
    (the stream kernel with the mass). Product of t's ν = 2.5 leaves
    x² without a finite variance, so a 400-iteration window's median
    var/analytic swings with single excursions into the tails (one such
    window of the warmed engine read 1.16); the warmed engine is read over
    2,000 iterations. Returns {(config, instance): (run, stream) launches at
    the preset's JAX default precision} of the from_warmup engines (from 0
    just before each)."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    pot = BENCHMARK_CONFIGS["product_of_t"].make_distribution()
    lr = BENCHMARK_CONFIGS["logreg"].make_distribution()
    target = {"product_of_t": pot.analytic_var().double().cuda(),
              "logreg": torch.as_tensor(lr.laplace_var(), device="cuda")}

    def median_ratio(cname, out):
        _, var = cm.CudaMJHMC.moments(out)
        return float((var.double() / target[cname]).median())

    def held(what, cname, out, tol):
        ratio = median_ratio(cname, out)
        oracle = "analytic" if cname == "product_of_t" else "laplace_var"
        check(abs(ratio - 1) < tol, f"{what}: median var/{oracle} {ratio:.4f}, outside {tol:.0%}")
        return f"median var/{oracle} {ratio:.5f}"

    eng = cm.CudaNUTS(pot, epsilon=0.12, num_leapfrog_steps=7, nbatch=2048, seed=0)
    eng.run(100)
    out = eng.run(400)
    check(bool((out.w == 400).all()), "CudaNUTS product_of_t: w must equal the steps")
    got = held("CudaNUTS product_of_t", "product_of_t", out, 0.15)
    leaves = float(out.evals.double().mean()) / 400
    leaves_ref = plain["leaves"]
    check(abs(leaves / leaves_ref - 1) < 0.12,
          f"CudaNUTS product_of_t {leaves:.4g} leaves/iteration vs the plain NUTS {leaves_ref:.4g}")
    phase("22 slice K stats", f"CudaNUTS product_of_t (2,048 chains, eps 0.12, max_depth 7, "
          f"100 + 400): {got}; {leaves:.5g} leaves/iteration vs {leaves_ref:.5g} in the plain "
          f"NUTS ({plain['what']})")

    eng = cm.CudaMJHMC(lr, epsilon=0.25, beta=0.15, num_leapfrog_steps=10, nbatch=2048, seed=0)
    eng.run(400)
    got = held("CudaMJHMC logreg", "logreg", eng.run(1500), 0.25)
    phase("22 slice K stats", f"CudaMJHMC logreg (2,048 chains, eps 0.25, beta 0.15, M 10, "
          f"400 + 1500): {got}")
    eng = cm.CudaNUTS(lr, epsilon=0.15, num_leapfrog_steps=MM_NUTS_DEPTH, nbatch=2048, seed=0)
    eng.run(200)
    out = eng.run(1000)
    got = held("CudaNUTS logreg", "logreg", out, 0.25)
    phase("22 slice K stats", f"CudaNUTS logreg (2,048 chains, eps 0.15, max_depth "
          f"{MM_NUTS_DEPTH}, 200 + 1000): {got}; "
          f"{float(out.evals.double().mean()) / 1000:.5g} leaves/iteration")

    jax_default, _ = mm_precisions(cm)
    res = {}
    for ecls, dist, cname, kw, burn, steps, tol in (
            # the warmup's phases halved from nuts_full_warmup's 60/60/40 (the
            # plain NUTS on 1,024 chains, ~0.24 s an iteration on the card)
            (cm.CudaNUTS, pot, "product_of_t", dict(nbatch=4096, max_depth=MM_NUTS_DEPTH,
                                                    phase1=30, phase2=30, phase3=20), 100,
             2000, 0.15),
            (cm.CudaMJHMC, lr, "logreg", dict(nbatch=2048, beta=0.15, num_leapfrog_steps=10), 0,
             1500, 0.25)):
        cm.reset_counts()
        t0 = time.perf_counter()
        eng = ecls.from_warmup(dist, seed=0, **kw)
        warm_s = time.perf_counter() - t0
        im = torch.as_tensor(eng.inv_mass)
        check(eng.epsilon > 0 and bool((im > 0).all()) and im.numel() == dist.ndims,
              f"{ecls.__name__}.from_warmup({cname}): eps {eng.epsilon}, M^-1 {im.tolist()}")
        if burn:
            eng.run(burn)
        got = held(f"{ecls.__name__}.from_warmup({cname})", cname, eng.run(steps), tol)
        xs, ws = eng.sample(20)
        check(bool(torch.isfinite(xs).all()) and bool((ws >= 0).all()),
              f"{ecls.__name__}.from_warmup({cname}): samples not finite")
        mass = counts(cm, "mass_launches", mm=True)
        at_prec = counts(cm, f"{jax_default[cname]}_launches", mm=True)
        check(all(v > 0 for v in mass) and at_prec == mass,
              f"{ecls.__name__}.from_warmup({cname}): launches with the mass {mass}, at "
              f"{jax_default[cname]} {at_prec}")
        res[(cname, f"{'nuts' if ecls is cm.CudaNUTS else 'mjhmc'} branches")] = at_prec
        phase("22 slice K stats", f"{ecls.__name__}.from_warmup({cname}, {kw}): warmup "
              f"{warm_s:.3g} s host clock, eps {eng.epsilon:.5g}, M^-1 in [{float(im.min()):.4g}, "
              f"{float(im.max()):.4g}]; {burn} + {steps}: {got}; 20 samples; (run, stream) "
              f"launches, all with the mass at {jax_default[cname]}: {at_prec}")
    return res


def slice_k_cli(cm, cli):
    """Phase 23: `sample --sampler nuts` on product_of_t and sparse_coding,
    every sampler on logreg (--engine cuda), and the plain NUTS sampler on
    logreg (--engine torch), at the presets' widths; every count set to 0
    just before each call. Returns {(sampler, config, engine): (record,
    (run, stream) launches, seconds)}: --engine cuda's all at the preset's
    JAX default precision."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    jax_default, _ = mm_precisions(cm)
    out = {}
    for sampler, cname, engine, burn, steps in (
            ("nuts", "product_of_t", "cuda", 200, 400), ("nuts", "sparse_coding", "cuda", 100, 100),
            ("mjhmc", "logreg", "cuda", 500, 1000), ("control", "logreg", "cuda", 500, 1000),
            ("malt", "logreg", "cuda", 500, 1000), ("nuts", "logreg", "cuda", 500, 1000),
            ("nuts", "logreg", "torch", 20, 50)):
        cfg = BENCHMARK_CONFIGS[cname]
        cm.reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli(["sample", "--config", cname, "--engine", engine, "--sampler", sampler,
                 "--burn", str(burn), "--steps", str(steps)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        attr = "launches" if sampler == "mjhmc" else f"{sampler}_launches"
        launches = counts(cm, attr, mm=True)
        n, m, ge = cfg.nbatch, cfg.num_leapfrog_steps, rec["grad_evals"]
        iters = steps if engine == "torch" else burn + steps  # the plain burn-in resets
        if engine == "cuda":
            at_prec = counts(cm, f"{jax_default[cname]}_launches", mm=True)
            check(all(v > 0 for v in launches) and at_prec == launches,
                  f"{sampler} {cname}: kernels not launched, or not all at "
                  f"{jax_default[cname]}: {launches}, {at_prec}")
        else:
            check(not any(v for a in cm.COUNTS for mm in (False, True) for v in counts(cm, a, mm)),
                  "--engine torch launched a kernel")
        if sampler == "nuts":
            good = iters * n <= ge <= iters * n * (2**MM_NUTS_DEPTH - 1)
        elif sampler == "mjhmc":
            good = ge >= m * iters * n and ge % m == 0
        else:
            good = ge == m * iters * n
        check(good and rec["chains"] == n and rec["steps"] == steps and rec["ess"] > 0
              and all(v > 0 and v == v for v in rec["var"]), f"bad CLI record {rec}")
        out[(sampler, cname, engine)] = (rec, launches, seconds)
        phase("23 slice K cli", f"{json.dumps(rec)}; launches (run, stream) {launches}; "
              f"{seconds:.4g} s host clock")
    return out


def slice_k_timing(cm, card):
    """Phase 24: ms per iteration (CUDA events) of every slice-K instance,
    run and stream, beside the plain version, at the presets' widths; NUTS
    also leaves/s and the share of its tiles' leaf slots that were live.
    The instances with a mass (and logreg MJHMC's with the two-stage
    integrator) are timed as "<body> inv_mass". Returns {(key, config): (run
    ms, stream ms, plain run ms, plain stream ms, gradients, iterations,
    chains, live share)}."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    dists = {c: BENCHMARK_CONFIGS[c].make_distribution()
             for c in ("product_of_t", "sparse_coding", "logreg")}
    mass = {"product_of_t": tuple(float(v) for v in dists["product_of_t"].analytic_var()),
            "sparse_coding": tuple(float(v) for v in torch.linspace(0.8, 1.25, 128)),
            "logreg": tuple(float(v) for v in dists["logreg"].laplace_var())}
    rows = {}
    for key, cname, n, eps, beta, iters in (
            ("nuts", "product_of_t", 4096, 0.12, 0.0, 200),
            ("nuts", "sparse_coding", 8192, 0.02, 0.0, 30),
            ("nuts", "logreg", 2048, 0.15, 0.0, 300),
            ("nuts inv_mass", "product_of_t", 4096, 0.12, 0.0, 200),
            ("nuts inv_mass", "sparse_coding", 8192, 0.02, 0.0, 30),
            ("nuts inv_mass", "logreg", 2048, 0.15, 0.0, 300),
            ("mjhmc", "logreg", 2048, 0.15, 0.1, 1000),
            ("mjhmc inv_mass", "logreg", 2048, 0.15, 0.1, 1000),
            ("control", "logreg", 2048, 0.15, 0.2, 1000),
            ("malt", "logreg", 2048, 0.15, 1.0, 1000)):
        cfg = BENCHMARK_CONFIGS[cname]
        dist = dists[cname]
        body = key.split()[0]
        nuts = body == "nuts"
        m = MM_NUTS_DEPTH if nuts else cfg.num_leapfrog_steps
        ecls = {"nuts": cm.CudaNUTS, "mjhmc": cm.CudaMJHMC, "control": cm.CudaControlHMC,
                "malt": cm.CudaMALT}[body]
        kw = dict(variant=body)
        if key.endswith("inv_mass"):
            kw["inv_mass"] = mass[cname]
            if body == "mjhmc":
                kw["integrator"] = "two_stage"
        eng = ecls(dist, epsilon=eps, beta=beta, num_leapfrog_steps=m, nbatch=n, seed=4,
                   **{k: v for k, v in kw.items() if k != "variant"})
        eng.spec = at(eng.spec)
        eng.run(10)
        before = eng.grad_evals
        run_ms = events_ms(lambda: eng.run(iters)) / iters
        grads = eng.grad_evals - before
        got = {}
        stream_ms = events_ms(lambda: got.update(s=eng.sample(iters, return_evals=True))) / iters
        tile = cm.nuts_mm_tile_rule(eng.spec).chains
        share = leaf_slot_share(got["s"][2], m, tile) if nuts else 1.0
        plain_iters = 1 if nuts else 3
        args = (eng.spec, *initial_state(dist, n, seed=5, inv_mass=kw.get("inv_mass")),
                99, eps, beta)
        cm.run_reference(*args, 1, m, **kw)
        plain_ms = events_ms(lambda: cm.run_reference(*args, plain_iters, m, **kw)) / plain_iters
        plain_stream_ms = events_ms(
            lambda: cm.stream_reference(*args, plain_iters, 1, m, **kw)) / plain_iters
        rows[(key, cname)] = (run_ms, stream_ms, plain_ms, plain_stream_ms, grads, iters, n, share)
        per = grads / (n * iters)
        extra = (f"{per:.5g} leaves per chain and iteration, {per * n / run_ms * 1e3:.6g} leaves/s, "
                 f"{share:.4f} of the {tile}-chain tiles' leaf slots live" if nuts
                 else f"{per:.4g} gradients per chain and iteration")
        phase("24 slice K timing", f"{key} {cname} ({n} chains, eps {eps}, beta {beta}, "
              f"{'max_depth' if nuts else 'M'} {m}): run {run_ms:.6g} ms/iteration, stream "
              f"(thin 1) {stream_ms:.6g}; plain version run {plain_ms:.6g}, stream "
              f"{plain_stream_ms:.6g} ms/iteration; {extra} [{card}]")
    return rows


# ---- slice L: the zoo energies on the elementwise kernel -------------------
ZOO_ENERGIES = {
    "funnel": "FunnelSpec (mjhmc_tpu/ops/pallas_mjhmc.py:113)",
    "banana": "BananaSpec (mjhmc_tpu/ops/pallas_mjhmc.py:149)",
    "mog": "MogSpec (mjhmc_tpu/ops/pallas_mjhmc.py:174)",
    "eight_schools": "EightSchoolsSpec, centered (mjhmc_tpu/ops/pallas_mjhmc.py:554)",
    "eight_schools_nc": "EightSchoolsSpec, non-centered (mjhmc_tpu/ops/pallas_mjhmc.py:554)",
}
ZOO_BODIES = ("mjhmc", "control", "malt", "nuts")
ZOO_NUTS_DEPTH = 6  # max_depth of the zoo NUTS checks (the CLI's and the engines' is 8)
MJHMC_VARIANT = "mjhmc (_make_step, mjhmc_tpu/ops/pallas_mjhmc.py:714)"
#: iterations of the statistics runs (burn, steps) of phase 27
ZOO_STATS_ITERS = {"banana": (500, 2000), "banana_nuts": (200, 1000), "mog": (300, 1500),
                   "eight_schools_nc": (500, 2500), "funnel": (0, 3000), "funnel_nuts": (200, 2000)}
#: the funnel's warmup phases (the JAX test's for MJHMC; shorter for NUTS,
#: whose warmup runs the plain NUTS sampler, a host sync per leaf: a quarter
#: of nuts_full_warmup's 60/60/40, to keep the script within its time)
FUNNEL_WARMUP = {"mjhmc": dict(phase1=200, phase2=300, phase3=150),
                 "nuts": dict(phase1=15, phase2=25, phase3=10)}
#: (burn, steps) of the zoo CLI calls
ZOO_CLI_ITERS = (300, 600)
#: the elementwise engine's shapes beyond the presets' D, each body held
#: against its plain version at them (on the CPU against the JAX package
#: too, tests/test_torch_any_dims.py): the shapes of the JAX package's
#: TPU-gated engine tests (tests/test_pallas_engine.py:455-889), a banana
#: past its preset's D, a mixture past the library's 8 components, and the
#: funnel at D 12 (control's whole mode on 8 lanes with the Metropolis
#: uniform in a Philox block of its own: 6 pairs fill their last block) and
#: D 30 (MALT's dims over 8 lanes). label -> (model, its keyword arguments,
#: ε, M)
MOG_RING = tuple((round(3.0 * math.cos(0.2 * math.pi * k), 6),
                  round(3.0 * math.sin(0.2 * math.pi * k), 6)) for k in range(10))
ANY_D_SHAPES = {
    "gaussian d4": ("Gaussian", dict(ndims=4, log_conditioning=2.0), 0.15, 10),
    "gaussian d8": ("Gaussian", dict(ndims=8, log_conditioning=2.0), 0.25, 10),
    "gaussian d16": ("Gaussian", dict(ndims=16, log_conditioning=3.0), 0.5, 10),
    "funnel d8": ("Funnel", dict(ndims=8, sigma_v=2.0), 0.1, 8),
    "banana d10": ("Banana", dict(ndims=10), 0.25, 8),
    "mog d2 k10": ("GaussianMixture", dict(ndims=2, means=MOG_RING, scales=(0.8, 1.2) * 5,
                                           weights=(0.1,) * 10), 0.3, 5),
    "funnel d12": ("Funnel", dict(ndims=12, sigma_v=2.0), 0.1, 8),
    "funnel d30": ("Funnel", dict(ndims=30, sigma_v=2.0), 0.1, 8),
}
#: held on the card only: the smallest and a wide separable D
ANY_D_CARD_SHAPES = {
    "gaussian d3": ("Gaussian", dict(ndims=3, log_conditioning=1.0), 0.3, 10),
    "gaussian d128": ("Gaussian", dict(ndims=128, log_conditioning=2.0), 0.25, 10),
}


def any_d_dists():
    """label -> (distribution, ε, M) of every shape of ANY_D_SHAPES and
    ANY_D_CARD_SHAPES."""
    from mjhmc_tpu_torch import models

    return {label: (getattr(models, name)(**kw), eps, m)
            for label, (name, kw, eps, m) in {**ANY_D_SHAPES, **ANY_D_CARD_SHAPES}.items()}


def tested_dims(cm):
    """Every (elementwise spec class, D) the tests and this script hold:
    the library's (``cm.KERNEL_DIMS``), then the any-D shapes'."""
    out = [(spec, d) for spec, dims in cm.KERNEL_DIMS.items() for d in dims]
    for dist, _, _ in any_d_dists().values():
        key = (type(cm.energy_spec_for(dist)), dist.ndims)
        if key not in out:
            out.append(key)
    return out


def zoo_presets():
    """label -> (distribution, preset config): the four zoo presets, and
    eight schools non-centered at the eight_schools preset's settings."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.models import EightSchools

    out = {c: (BENCHMARK_CONFIGS[c].make_distribution(), BENCHMARK_CONFIGS[c])
           for c in ("funnel", "banana", "mog", "eight_schools")}
    out["eight_schools_nc"] = (EightSchools(parameterization="noncentered"),
                               BENCHMARK_CONFIGS["eight_schools"])
    return out


def zoo_cases():
    """Every body and branch on every zoo energy at the preset's width and
    ε (NUTS at max_depth ZOO_NUTS_DEPTH): (label, energy, distribution,
    chains, ε, β, M or max_depth, iterations held, options). The mass is
    M⁻¹ from 0.5 to 1.5 over the dims."""
    rows = []
    for name, (dist, cfg) in zoo_presets().items():
        mass = tuple(float(v) for v in torch.linspace(0.5, 1.5, dist.ndims))
        for label, beta, kw in (
                ("mjhmc", cfg.beta, {}),
                ("mjhmc two_stage", cfg.beta, dict(integrator="two_stage")),
                ("mjhmc inv_mass", cfg.beta, dict(inv_mass=mass)),
                ("control", 0.2, dict(variant="control")),
                ("control two_stage inv_mass", 0.2,
                 dict(variant="control", integrator="two_stage", inv_mass=mass)),
                ("malt", 1.0, dict(variant="malt")),
                ("malt inv_mass", 1.0, dict(variant="malt", inv_mass=mass)),
                ("nuts", 0.0, dict(variant="nuts")),
                ("nuts inv_mass", 0.0, dict(variant="nuts", inv_mass=mass))):
            nuts = label.startswith("nuts")
            rows.append((f"{name} {label}", name, dist, cfg.nbatch, cfg.epsilon, beta,
                         ZOO_NUTS_DEPTH if nuts else cfg.num_leapfrog_steps, 3 if nuts else 5, kw))
    return rows


def finite_within(a, b):
    """(n,) bool: the chain's values of ``a`` lie within rtol 1e-4 (atol 1e-4
    of the largest finite value) of ``b``'s, non-finite where ``b``'s are."""
    a, b = a.double(), b.double()
    fin = torch.isfinite(b)
    top = float(b[fin].abs().max()) if bool(fin.any()) else 1.0
    good = torch.where(fin, (a - b).abs() <= 1e-4 * (top + b.abs()), ~torch.isfinite(a))
    while good.dim() > 1:
        good = good.all(dim=-2)
    return good


def zoo_agree(run, xs, ref, xs_ref):
    """(n,) bool: x, v, g, u and every emitted x within rtol 1e-4,
    non-finite on the same chains."""
    ok = finite_within(xs, xs_ref)
    for f in ("x", "v", "grad", "u"):
        ok &= finite_within(getattr(run, f), getattr(ref, f))
    return ok


def zoo_kernel_checks(cm):
    """Phases 25-26: every body and branch on every zoo energy, run and
    stream kernels, against the plain version on the card (``case_checks``).
    Returns ({label: max |dx| on the fixed-uniform chains held}, {label: NUTS
    identical share, fixed-uniform and Philox})."""
    return case_checks(cm, zoo_cases(), ("25 zoo fixed-uniform", "26 zoo philox"))


def case_checks(cm, cases, phases, exact_counters=False):
    """Every case (label, energy, distribution, chains, ε, β, M or
    max_depth, iterations held, options), run and stream kernels, against
    the plain version on the card, from v ~ N(0, M), in fixed-uniform mode
    (phase ``phases[0]``) and in Philox mode (``phases[1]``). Decisions
    (counters and stream es; and, but for NUTS, whether x moved each
    iteration) equal on >= 0.999 of chains or as many as one-ulp nudges (of
    x or of ε, up and down) change in the plain version alone, if more (the
    count that differ is printed: the kernel contracts FMAs that torch
    rounds apart, and stiff regions carry last-ulp differences on);
    ``exact_counters``: the counters equal on every chain in fixed-uniform
    mode. x, v, g, u and every emitted x within rtol 1e-4 (atol 1e-4 of the
    largest finite value), non-finite on the same chains, on all but 0.1% of
    the chains whose decisions agree or as many as the nudges move past it.
    The nudged plain runs are made only where a count passes 0.1% of the
    chains. NUTS (Rn roundings; the kernel's expf and logf round as
    torch.exp and torch.log do on the card) is held bit for bit: x, v, g, u,
    leaf counts and every emission identical on every chain. Returns
    ({label: max |dx| on the fixed-uniform chains held}, {label: NUTS
    identical share, fixed-uniform and Philox})."""
    errs, ident = {}, {}
    for label, name, dist, n, eps, beta, m, held, kw in cases:
        spec = cm.energy_spec_for(dist)
        variant = kw.get("variant", "mjhmc")
        nuts, mj = variant == "nuts", variant == "mjhmc"
        for fixed, seed in ((True, 7), (False, 12345)):
            st = initial_state(dist, n, seed=1 if fixed else 2, inv_mass=kw.get("inv_mass"))
            args = (spec, *st, seed, eps, beta)
            k = cm.cuda_mjhmc_run(*args, held, m, fixed_uniform=fixed, **kw)
            xs_k, ws_k, es_k, so_k = cm.cuda_mjhmc_stream_run(*args, held, 1, m,
                                                              fixed_uniform=fixed, **kw)
            xs_r, ws_r, es_r, r = cm.stream_reference(*args, held, 1, m, fixed, **kw)

            moved_r = moves(xs_r, st[0], r.x if mj else None)

            def decisions(run, xs, es, x0):
                same = (run.evals == r.evals) & (es == es_r).all(dim=0)
                if not nuts:
                    same &= (moves(xs, x0, run.x if mj else None) == moved_r).all(dim=0)
                return same

            counters = ((k.evals == r.evals) & (so_k.evals == r.evals)
                        & (es_k == es_r).all(dim=0))
            same = decisions(k, xs_k, es_k, st[0]) & decisions(so_k, xs_k, es_k, st[0])
            within = zoo_agree(k, xs_k, r, xs_r) & zoo_agree(so_k, xs_k, r, xs_r)
            differ, outside = int((~same).sum()), int((same & ~within).sum())
            flips, drift = torch.zeros_like(same), torch.zeros_like(same)
            nudged = max(differ, outside) > 0.001 * n
            if nudged:
                for to in (float("inf"), float("-inf")):
                    x_n = torch.nextafter(st[0], torch.full_like(st[0], to))
                    eps_n = float(torch.nextafter(torch.tensor(eps), torch.tensor(to)))
                    for x0, e in ((x_n, eps), (st[0], eps_n)):
                        xs_n, _, es_n, r_n = cm.stream_reference(spec, x0, *st[1:], seed, e,
                                                                 beta, held, 1, m, fixed, **kw)
                        same_n = decisions(r_n, xs_n, es_n, x0)
                        flips |= ~same_n
                        drift |= same_n & ~zoo_agree(r_n, xs_n, r, xs_r)
            allow_dec = max(0.001 * n, int(flips.sum()))
            allow_states = max(0.001 * n, int(drift.sum()))
            mode = "fixed-uniform" if fixed else "Philox"
            what = (f"{label} ({n} chains, eps {eps}, beta {beta}, "
                    f"{'max_depth' if nuts else 'M'} {m}, {held} iterations, {mode})")
            if exact_counters and fixed:
                check(bool(counters.all()), f"{what}: counters differ on "
                      f"{int((~counters).sum())} chains")
            check(differ <= allow_dec, f"{what}: decisions differ on {differ} chains, "
                  f"{allow_dec:g} allowed")
            check(outside <= allow_states, f"{what}: {outside} chains with equal decisions "
                  f"outside rtol 1e-4, {allow_states:g} allowed")
            if variant in ("control", "malt"):
                check(bool((k.w == held).all()) and bool((ws_k == 1).all()), f"{what}: w, ws")
            ok = same & within
            dx = (k.x - r.x).abs()[:, ok]
            err = float(dx[torch.isfinite(dx)].max()) if dx.numel() else 0.0
            nonfinite = int((~torch.isfinite(r.u)).sum())
            extra = ""
            if nuts:
                identical = (k.evals == r.evals) & (es_k == es_r).all(dim=0)
                for f in ("x", "v", "grad", "u"):
                    a, b = getattr(k, f), getattr(r, f)
                    eq = (a == b) | (torch.isnan(a) & torch.isnan(b))
                    identical &= eq.all(dim=0) if eq.dim() == 2 else eq
                eq = (xs_k == xs_r) | (torch.isnan(xs_k) & torch.isnan(xs_r))
                identical &= eq.all(dim=1).all(dim=0)
                share = float(identical.double().mean())
                check(share == 1.0, f"{what}: bit-identical on {share:.5f} of chains")
                ident.setdefault(label, []).append(share)
                extra = (f"; bit-identical on {share:.5f} of chains; "
                         f"{float(r.evals.double().mean()) / held:.4g} leaves/iteration")
            if fixed:
                errs[label] = err
            nudges = (f"one-ulp nudges of x or eps change {int(flips.sum())} chains' decisions "
                      f"and move {int(drift.sum())} more past rtol 1e-4 in the plain version "
                      "alone" if nudged else "no nudged runs needed (within 0.1%)")
            phase(phases[0] if fixed else phases[1],
                  f"{what}: decisions equal on {1 - differ / n:.5f} ({differ} differ)"
                  f"{', counters on every chain' if exact_counters and fixed else ''}; x,v,g,u "
                  f"and stream xs rtol 1e-4 on all but {outside} of the others (max|dx| "
                  f"{err:.3g}); non-finite energies on {nonfinite} chains, the same on both "
                  f"sides where decisions agree; {nudges}{extra}")
    return errs, ident


def zoo_stats(cm):
    """Phase 27: the statistics of the JAX package's TPU-gated zoo checks
    (tests/test_pallas_engine.py:493-581) on the port's engines. Banana
    (MJHMC, and NUTS at max_depth 8): var/analytic within 0.2 on row 0 and
    0.3 on row 1; the mixture at means ±1.5, σ 1: within 0.2; eight schools
    non-centered with M⁻¹ = the quadrature variances: means within 0.5 of
    the quadrature means, var/quadrature within 0.2; the funnel (D 10, σ_v 2;
    the JAX test runs D 8, the preset's D is 10) after CudaMJHMC.from_warmup
    and CudaNUTS.from_warmup: every var/analytic in (0.5, 1.6). Returns the
    launches of each engine entry point, counted from 0 just before it."""
    from mjhmc_tpu_torch.models import Banana, EightSchools, Funnel, GaussianMixture

    res = {}

    def moments(eng, key):
        burn, steps = ZOO_STATS_ITERS[key]
        cm.reset_counts()
        if burn:
            eng.run(burn)
        out = eng.run(steps)
        res[key] = {body: counts(cm, "launches" if body == "mjhmc" else f"{body}_launches")
                    for body in ZOO_BODIES}
        mean, var = cm.CudaMJHMC.moments(out)
        return mean.double(), var.double(), f"{burn} + {steps}"

    banana = Banana()
    target = banana.analytic_var().double().to(DEV)
    for key, eng in (("banana", cm.CudaMJHMC(banana, epsilon=0.35, beta=0.15, num_leapfrog_steps=10,
                                             nbatch=4096, seed=0, device=DEV)),
                     ("banana_nuts", cm.CudaNUTS(banana, epsilon=0.35, num_leapfrog_steps=8,
                                                 nbatch=4096, seed=0, device=DEV))):
        _, var, iters = moments(eng, key)
        ratio = var / target
        check(abs(float(ratio[0]) - 1) < 0.2 and abs(float(ratio[1]) - 1) < 0.3,
              f"{type(eng).__name__} banana var/analytic {ratio.tolist()}")
        phase("27 zoo stats", f"{type(eng).__name__} banana (4,096 chains, eps 0.35, "
              f"{'beta 0.15, M 10' if key == 'banana' else 'max_depth 8'}, {iters}): var/analytic "
              f"{[round(x, 5) for x in ratio.tolist()]} (bounds 0.2, 0.3)")

    mog = GaussianMixture(means=((-1.5,), (1.5,)), scales=(1.0, 1.0))
    _, var, iters = moments(cm.CudaMJHMC(mog, epsilon=0.8, beta=0.2, num_leapfrog_steps=5,
                                         nbatch=4096, seed=0, device=DEV), "mog")
    ratio = float(var[0]) / float(mog.analytic_var()[0])
    check(abs(ratio - 1) < 0.2, f"mog var/analytic {ratio}")
    phase("27 zoo stats", f"CudaMJHMC mog, means +-1.5, sigma 1 (4,096 chains, eps 0.8, beta 0.2, "
          f"M 5, {iters}): var/analytic {ratio:.5f} (bound 0.2)")

    es = EightSchools(parameterization="noncentered")
    tgt = es.analytic_var().double().to(DEV)
    mean, var, iters = moments(cm.CudaMJHMC(es, epsilon=0.6, beta=0.15, num_leapfrog_steps=8,
                                            nbatch=4096, seed=0, device=DEV,
                                            inv_mass=tuple(float(v) for v in tgt)),
                               "eight_schools_nc")
    dmean = float((mean - es.analytic_mean().double().to(DEV)).abs().max())
    dvar = float((var / tgt - 1).abs().max())
    check(dmean < 0.5 and dvar < 0.2, f"eight schools non-centered: max |mean - quadrature| "
          f"{dmean}, max |var/quadrature - 1| {dvar}")
    phase("27 zoo stats", f"CudaMJHMC eight_schools non-centered, M^-1 = the quadrature "
          f"variances (4,096 chains, eps 0.6, beta 0.15, M 8, {iters}): max |mean - quadrature| "
          f"{dmean:.5f} (bound 0.5), max |var/quadrature - 1| {dvar:.5f} (bound 0.2)")

    funnel = Funnel(ndims=10, sigma_v=2.0)
    target = funnel.analytic_var().double().to(DEV)
    for key, ecls, kw in (("funnel", cm.CudaMJHMC,
                           dict(beta=0.2, num_leapfrog_steps=10, **FUNNEL_WARMUP["mjhmc"])),
                          ("funnel_nuts", cm.CudaNUTS, FUNNEL_WARMUP["nuts"])):
        t0 = time.perf_counter()
        eng = ecls.from_warmup(funnel, seed=0, nbatch=8192, device=DEV, **kw)
        warm_s = time.perf_counter() - t0
        im = torch.as_tensor(eng.inv_mass)
        check(eng.epsilon > 0 and bool((im > 0).all()), f"{ecls.__name__}.from_warmup(funnel): "
              f"eps {eng.epsilon}, M^-1 {im.tolist()}")
        _, var, iters = moments(eng, key)
        ratio = var / target
        check(float(ratio.min()) > 0.5 and float(ratio.max()) < 1.6,
              f"{ecls.__name__}.from_warmup(funnel) var/analytic {ratio.tolist()}")
        phase("27 zoo stats", f"{ecls.__name__}.from_warmup(Funnel(ndims=10, sigma_v=2.0)) "
              f"(the preset's D 10; the JAX test's D is 8), 8,192 chains, {kw}: warmup "
              f"{warm_s:.3g} s host clock, eps {eng.epsilon:.5g}, M^-1 in [{float(im.min()):.4g}, "
              f"{float(im.max()):.4g}]; {iters}: var/analytic in [{float(ratio.min()):.5f}, "
              f"{float(ratio.max()):.5f}] (bounds 0.5, 1.6)")
    return res


def zoo_cli(cm, cli):
    """Phase 28: `sample --config funnel|banana|mog|eight_schools --engine
    cuda --sampler mjhmc|control|malt|nuts` at the presets' widths, every
    count set to 0 just before each call. Returns {(config, sampler):
    (record, (run, stream) launches, seconds)}."""
    out = {}
    burn, steps = ZOO_CLI_ITERS
    for cname, (dist, cfg) in zoo_presets().items():
        if cname == "eight_schools_nc":  # no preset: its entry points are the engines
            continue
        for sampler in ZOO_BODIES:
            cm.reset_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli(["sample", "--config", cname, "--engine", "cuda", "--sampler", sampler,
                     "--burn", str(burn), "--steps", str(steps)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rec = json.loads(buf.getvalue().strip().splitlines()[-1])
            launches = counts(cm, "launches" if sampler == "mjhmc" else f"{sampler}_launches")
            check(all(v > 0 for v in launches), f"{sampler} {cname}: kernels not launched")
            n, m, ge = cfg.nbatch, cfg.num_leapfrog_steps, rec["grad_evals"]
            iters = burn + steps
            good = {"nuts": iters * n <= ge <= iters * n * 255,
                    "mjhmc": ge >= m * iters * n and ge % m == 0}.get(sampler, ge == m * iters * n)
            check(good and rec["chains"] == n and rec["steps"] == steps and rec["ess"] > 0
                  and all(v > 0 and v == v for v in rec["var"])
                  and all(v == v for v in rec["mean"]), f"bad CLI record {rec}")
            out[(cname, sampler)] = (rec, launches, seconds)
            phase("28 zoo cli", f"{json.dumps(rec)}; launches (run, stream) {launches}; "
                  f"{seconds:.4g} s host clock")
    return out


def zoo_timing(cm, card):
    """Phase 29: ms per iteration (CUDA events) of every zoo instance, run
    and stream, through the engines at the presets' widths and ε (NUTS at
    max_depth 8), beside the plain version; the branch instances (MJHMC,
    control and NUTS with a mass) as "<body> inv_mass". Eight schools
    non-centered's launches are counted here, from 0 just before each
    engine. Returns {(key, energy): (run ms, stream ms, plain run ms, plain
    stream ms, gradients, iterations, chains, (run, stream) launches)}."""
    rows = {}
    ecls = {"nuts": cm.CudaNUTS, "mjhmc": cm.CudaMJHMC, "control": cm.CudaControlHMC,
            "malt": cm.CudaMALT}
    for name, (dist, cfg) in zoo_presets().items():
        n = cfg.nbatch
        mass = tuple(float(v) for v in torch.linspace(0.5, 1.5, dist.ndims))
        for key in ZOO_BODIES + ("mjhmc inv_mass", "control inv_mass", "nuts inv_mass"):
            body = key.split()[0]
            nuts = body == "nuts"
            m = 8 if nuts else cfg.num_leapfrog_steps
            beta = {"mjhmc": cfg.beta, "control": 0.2, "malt": 1.0, "nuts": 0.0}[body]
            kw = {"inv_mass": mass} if key.endswith("inv_mass") else {}
            iters = 300 if nuts else 1000
            cm.reset_counts()
            eng = ecls[body](dist, epsilon=cfg.epsilon, beta=beta, num_leapfrog_steps=m, nbatch=n,
                             seed=4, device=DEV, **kw)
            eng.run(10)
            before = eng.grad_evals
            run_ms = events_ms(lambda: eng.run(iters)) / iters
            grads = eng.grad_evals - before
            stream_ms = events_ms(lambda: eng.sample(iters)) / iters
            launches = counts(cm, "launches" if body == "mjhmc" else f"{body}_launches")
            check(all(v > 0 for v in launches), f"{key} {name}: kernels not launched")
            share = ""
            if nuts:
                es = eng.sample(100, return_evals=True)[2]
                share = (f"; 100 more iterations' leaf slots live: "
                         f"{nuts_shares(cm, dist.ndims, es, m)}")
            plain_iters = 1 if nuts else 3
            args = (eng.spec, *initial_state(dist, n, seed=5, inv_mass=kw.get("inv_mass")), 99,
                    cfg.epsilon, beta)
            pkw = dict(variant=body, **kw)
            cm.run_reference(*args, 1, m, **pkw)
            plain_ms = events_ms(lambda: cm.run_reference(*args, plain_iters, m, **pkw)) / plain_iters
            plain_stream_ms = events_ms(
                lambda: cm.stream_reference(*args, plain_iters, 1, m, **pkw)) / plain_iters
            rows[(key, name)] = (run_ms, stream_ms, plain_ms, plain_stream_ms, grads, iters, n,
                                 launches)
            per = grads / (n * iters)
            phase("29 zoo timing", f"{key} {name} ({n} chains, eps {cfg.epsilon}, beta {beta}, "
                  f"{'max_depth' if nuts else 'M'} {m}): run {run_ms:.6g} ms/iteration, stream "
                  f"(thin 1) {stream_ms:.6g}; plain version run {plain_ms:.6g}, stream "
                  f"{plain_stream_ms:.6g} ms/iteration; {per:.5g} "
                  f"{'leaves' if nuts else 'gradients'} per chain and iteration{share} [{card}]")
    return rows


def zoo_entries(entry, errs, ident, cli_res, rows):
    """The kernels line's entries of slice L: every body on every zoo
    energy, run and stream; launches from phase 28's CLI calls (eight
    schools non-centered, which has no preset: phase 29's engines), errors
    from phase 25, times from phase 29 (``inv_mass_ms``: the instance with a
    mass, beside its bound ``inv_mass_bound_ms``)."""
    out = []
    variants = {"nuts": NUTS_VARIANT, "mjhmc": MJHMC_VARIANT, "control": CONTROL_VARIANT,
                "malt": MALT_VARIANT}
    for name, (dist, _) in zoo_presets().items():
        d, k = dist.ndims, len(getattr(dist, "scales", ()))
        for body in ZOO_BODIES:
            run_ms, stream_ms, plain_ms, plain_stream_ms, grads, iters, n, t_launches = \
                rows[(body, name)]
            launches = t_launches if name == "eight_schools_nc" else cli_res[(name, body)][1]
            cases = [c for c in errs if c.startswith(f"{name} {body}")]
            branch = rows.get((f"{body} inv_mass", name))
            for idx, (suffix, src) in enumerate((("run", RUN_SRC), ("stream", STREAM_SRC))):
                stream = idx == 1
                extra = {"variant": variants[body], "energy": ZOO_ENERGIES[name],
                         "shape": f"{name}, {n} chains, "
                                  f"{'max_depth 8' if body == 'nuts' else 'preset'}"
                                  f"{', thin 1' if stream else ''}, ms per iteration"}
                if branch:
                    extra["inv_mass_ms"] = branch[1 if stream else 0]
                    extra["inv_mass_bound_ms"], extra["inv_mass_bound_by"] = bound(
                        name, body, d, k, branch[6], branch[5], branch[4],
                        branch[5] if stream else 0, mass=True)
                if body == "nuts":
                    extra["bit_identical_share"] = {c: ident[c] for c in cases}
                out.append(entry(
                    f"{body}_{suffix}[{name}]", KERNEL_SRC, src, launches[idx],
                    max(errs[c] for c in cases), stream_ms if stream else run_ms,
                    plain_stream_ms if stream else plain_ms,
                    bound(name, body, d, k, n, iters, grads, iters if stream else 0), **extra))
    return out


# ---- the matmul kernel's dot precisions -----------------------------------
def mm_presets():
    """config -> (distribution, preset config, M⁻¹ of the mass cases, NUTS ε)
    for the three matmul presets."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    out = {}
    for cname, nuts_eps in (("product_of_t", 0.12), ("sparse_coding", 0.02), ("logreg", 0.15)):
        dist = BENCHMARK_CONFIGS[cname].make_distribution()
        mass = {"product_of_t": lambda: dist.analytic_var(), "logreg": lambda: dist.laplace_var(),
                "sparse_coding": lambda: torch.linspace(0.8, 1.25, 128)}[cname]()
        out[cname] = (dist, BENCHMARK_CONFIGS[cname], tuple(float(v) for v in mass), nuts_eps)
    return out


def mm_precisions(cm):
    """({config: the preset's JAX default precision}, {config: the sweep's
    other precisions}), read from the specs' defaults and
    ``cuda_mjhmc.MM_KERNEL_PRECISIONS``."""
    jax_default, sweep = {}, {}
    for cname, (dist, *_) in mm_presets().items():
        spec = cm.energy_spec_for(dist)
        table = cm.MM_KERNEL_PRECISIONS[type(spec)]
        check(table.get(spec.precision) == cm.ALL_BODIES,
              f"{cname}: no full set of instances at its default {spec.precision}")
        jax_default[cname] = spec.precision
        other = tuple(p for p, have in table.items() if have == cm.SWEEP_RUN)
        if other:
            sweep[cname] = other
    return jax_default, sweep


def branch_key(variant, kw):
    """The instance a case runs: the body, and "branches" for the BR=true
    instance that MJHMC and NUTS take with a mass or the two-stage
    integrator (control and MALT have only that one)."""
    br = variant in ("mjhmc", "nuts") and ("inv_mass" in kw or "integrator" in kw)
    return f"{variant} branches" if br else variant


def precision_cases(cm):
    """Phase 30: every body and branch of each matmul preset at its JAX
    default precision, run and stream, and the sweep's MJHMC leapfrog run
    at its other two precisions: (label, config, precision, distribution,
    chains, ε, β, M or max_depth, (fixed-uniform, Philox) iterations,
    options, stream). NUTS runs one iteration at PRECISION_NUTS_DEEP (deep
    trees: leaf counts held, states reported) and at max_depth 4, with and without
    a mass (states held)."""
    rows = []
    presets = mm_presets()
    jax_default, sweep = mm_precisions(cm)
    for cname, (dist, cfg, mass, nuts_eps) in presets.items():
        prec, n, m = jax_default[cname], cfg.nbatch, cfg.num_leapfrog_steps
        held = PRECISION_ITERS[cname]
        for label, beta, kw in (
                ("mjhmc", 0.1, {}), ("mjhmc two_stage", 0.1, dict(integrator="two_stage")),
                ("mjhmc inv_mass", 0.1, dict(inv_mass=mass)),
                ("control", 0.2, dict(variant="control")),
                ("control two_stage inv_mass", 0.2,
                 dict(variant="control", integrator="two_stage", inv_mass=mass)),
                ("malt", 1.0, dict(variant="malt")),
                ("malt inv_mass", 1.0, dict(variant="malt", inv_mass=mass))):
            rows.append((f"{cname} {label}", cname, prec, dist, n, cfg.epsilon, beta, m,
                         (held, held), kw, True))
        for label, depth, kw in (("nuts", PRECISION_NUTS_DEEP, dict(variant="nuts")),
                                 ("nuts", 4, dict(variant="nuts")),
                                 ("nuts inv_mass", 4, dict(variant="nuts", inv_mass=mass))):
            rows.append((f"{cname} {label} max_depth {depth}", cname, prec, dist, n, nuts_eps,
                         0.0, depth, (1, 1), kw, True))
    for cname, precs in sweep.items():
        dist, cfg, _, _ = presets[cname]
        for prec in precs:
            held, m = (SPARSE_DEFAULT_HELD if (cname, prec) == ("sparse_coding", "default")
                       else (PRECISION_ITERS[cname], cfg.num_leapfrog_steps))
            rows.append((f"{cname} mjhmc", cname, prec, dist, cfg.nbatch, cfg.epsilon, 0.1, m,
                         (held, held), {}, False))
    return rows


@contextlib.contextmanager
def split_depth(cm, parts):
    """The plain version with every contraction summed as ``parts`` partial
    products over slices of its depth, added in order: the same bf16
    products in another summation order (the kernel's mma.sync adds them
    in 16-deep tiles). Only the plain version calls ``_contract``."""
    plain = cm._contract

    def contract(stub, m, b, precision="highest"):
        step = -(-m.shape[-1] // parts)
        parts_ = [plain(stub, m[..., i:i + step], b[..., i:i + step, :], precision)
                  for i in range(0, m.shape[-1], step)]
        return sum(parts_[1:], parts_[0])

    cm._contract = contract
    try:
        yield
    finally:
        cm._contract = plain


def force_check(cm, spec, dist, n, beta, kw, stream, run=None):
    """The contraction alone: one iteration at ε = 0 (M or max_depth 1)
    leaves x where it starts, so the gradient and energy that come out are
    the instance's at the plain version's own x, fresh on every chain. Held
    per chain within rtol 1e-4 (atol 1e-4 of the largest), all but a =
    max(1% of the chains, the chains the plain version summed in halves and
    in quarters of its depth moves past it) with a Poisson margin a + 3√a;
    a must stay within ``INFORMATIVE``. Another precision's contraction
    moves every chain here (one pass or a once-rounded parameter against
    the others: 2⁻⁹). Returns (chains outside, limit, perturbed chains,
    largest relative gradient error of the kernel, of the perturbed runs).
    ``run``: the wrapper held, ``cuda_mjhmc_mm_run`` by default."""
    st = initial_state(dist, n, seed=3, inv_mass=kw.get("inv_mass"))
    args = (spec, *st, 7, 0.0, beta)
    outs = [(run or cm.cuda_mjhmc_mm_run)(*args, 1, 1, fixed_uniform=True, **kw)]
    if stream:
        outs.append(cm.cuda_mjhmc_mm_stream_run(*args, 1, 1, 1, fixed_uniform=True, **kw)[3])
    ref = cm.run_reference(*args, 1, 1, True, **kw)
    fresh = float((ref.grad != st[2]).any(dim=0).double().mean())
    check(fresh >= 0.99 and all(torch.equal(o.x, st[0]) for o in (ref, *outs)),
          f"eps 0: x must stay, the gradient be recomputed (fresh on {fresh:.4f})")

    def rel(o):
        return float(((o.grad - ref.grad).abs() / (ref.grad.abs() + 1e-4 * ref.grad.abs().max()))
                     .max())

    moved, rel_n = torch.zeros(n, dtype=torch.bool, device=DEV), 0.0
    for parts in (2, 4):
        with split_depth(cm, parts):
            r_n = cm.run_reference(*args, 1, 1, True, **kw)
        moved |= ~chains_within(r_n, ref, ("grad", "u"))
        rel_n = max(rel_n, rel(r_n))
    a = max(0.01 * n, int(moved.sum()))
    bad = torch.zeros_like(moved)
    for o in outs:
        bad |= ~chains_within(o, ref, ("grad", "u"))
    return int(bad.sum()), a + 3 * a**0.5, int(moved.sum()), max(rel(o) for o in outs), rel_n


def precision_kernel_checks(cm):
    """Phase 30: every bf16 instance of the matmul kernel against its plain
    version at the same precision. First the contraction alone
    (``force_check``: the gradient and energy at ε = 0 on every chain),
    then the dynamics in fixed-uniform mode and in Philox mode, from v ~
    N(0, M). A bf16 split is not continuous: a last-ulp difference can move
    a rounding by 2⁻⁹ relative at one pass, and the dynamics grow it. One-ulp
    nudges of x and of ε (up, down; as phases 25-26) move the state's;
    another summation order moves the intermediate's (sparse coding's
    residual r = patch − Φa keeps the ulps of Φa, larger than its own, and
    σ⁻² = 100 multiplies its rounding). So the plain version alone is also
    run with its contractions summed in halves and in quarters of their
    depth (``split_depth``): six perturbed runs. The cases run as few
    iterations as keep those runs' moved chains within ``INFORMATIVE``
    (``PRECISION_ITERS``, ``SPARSE_DEFAULT_HELD``), which the phase checks,
    but for NUTS at PRECISION_NUTS_DEEP, whose deep trees are chaotic at any
    precision (their leaf counts are held, their states reported; max_depth
    4 holds the states). The kernel's count of chains that differ is one
    draw of what the perturbed runs count, so each limit below is a = max(0.1%
    of the chains, the perturbed runs' count) with a Poisson margin of three
    standard deviations, a + 3√a. Decisions (counters and stream es; MJHMC,
    control and MALT also whether x moved each iteration; the sweep's runs,
    without a stream, their counters and cache flags) differ on no more
    chains than that, counting the chains the perturbed runs change;
    fixed-uniform counters exact but for NUTS (as phase 21). x, v, g, u and
    every emitted x within rtol 1e-4 (atol 1e-4 of the largest) on the
    chains whose decisions agree, all but that many, counting the chains the
    perturbed runs move past it. Control and MALT: Σw = steps. MJHMC: Σw over
    all chains within rtol 1e-4, or twice the largest change a perturbed run
    makes to it (its relative change, or the root sum of squares of its
    per-chain changes over Σw), if more. Returns {(config, precision,
    instance): max |dx| on the held fixed-uniform chains}."""
    errs = {}
    for label, cname, prec, dist, n, eps, beta, m, both, kw, stream in precision_cases(cm):
        spec = at(cm.energy_spec_for(dist), prec)
        variant = kw.get("variant", "mjhmc")
        nuts, mj = variant == "nuts", variant == "mjhmc"
        deep = nuts and m == PRECISION_NUTS_DEEP
        key = (cname, prec, branch_key(variant, kw))
        head = f"{label} at {prec} ({n} chains"
        bad, limit, moved, rel_k, rel_n = force_check(cm, spec, dist, n, beta, kw, stream)
        check(moved <= INFORMATIVE * n, f"{head}, eps 0): summing in parts moves {moved} "
              "chains' gradients past rtol 1e-4 in the plain version alone")
        check(bad <= limit, f"{head}, eps 0): gradient or energy outside rtol 1e-4 on {bad} "
              f"chains, {limit:.4g} allowed")
        phase("30 precision kernels", f"{head}, eps 0, {'max_depth' if nuts else 'M'} 1): "
              f"gradient and energy at the start rtol 1e-4 on all but {bad} chains (limit "
              f"{limit:.4g}; the split-depth sums move {moved}); largest relative gradient error "
              f"{rel_k:.3g}, of the split-depth sums {rel_n:.3g}")
        for fixed, seed, held in ((True, 7, both[0]), (False, 12345, both[1])):
            st = initial_state(dist, n, seed=1 if fixed else 2, inv_mass=kw.get("inv_mass"))

            def plain(x0, e=eps):
                if stream:
                    return cm.stream_reference(spec, x0, *st[1:], seed, e, beta, held, 1, m,
                                               fixed, **kw)
                return None, None, None, cm.run_reference(spec, x0, *st[1:], seed, e, beta,
                                                          held, m, fixed, **kw)

            args = (spec, *st, seed, eps, beta)
            runs = [(cm.cuda_mjhmc_mm_run(*args, held, m, fixed_uniform=fixed, **kw), None, None)]
            if stream:
                xs_k, ws_k, es_k, so_k = cm.cuda_mjhmc_mm_stream_run(*args, held, 1, m,
                                                                     fixed_uniform=fixed, **kw)
                runs = [(runs[0][0], xs_k, es_k), (so_k, xs_k, es_k)]
            xs_r, _, es_r, r = plain(st[0])
            moved_r = moves(xs_r, st[0], r.x if mj else None) if stream and not nuts else None

            def decisions(run, xs, es, x0, ref=r):
                same = run.evals == ref.evals
                if not stream:
                    return same & (run.back_valid == ref.back_valid)
                same &= (es == es_r).all(dim=0)
                if not nuts:
                    same &= (moves(xs, x0, run.x if mj else None) == moved_r).all(dim=0)
                return same

            def agree(run, xs):
                ok = chains_within(run, r)
                return ok & stream_within(xs, xs_r) if stream else ok

            same = torch.ones(n, dtype=torch.bool, device=DEV)
            within = same.clone()
            for run, xs, es in runs:
                same &= decisions(run, xs, es, st[0])
                within &= agree(run, xs)
            flips, drift = torch.zeros_like(same), torch.zeros_like(same)
            spread = 0.0
            perturbed = [(st[0], eps, 2), (st[0], eps, 4)]
            for to in (float("inf"), float("-inf")):
                e_n = float(torch.nextafter(torch.tensor(eps), torch.tensor(to)))
                perturbed += [(torch.nextafter(st[0], torch.full_like(st[0], to)), eps, 1),
                              (st[0], e_n, 1)]
            for x_n, e, parts in perturbed:
                with split_depth(cm, parts) if parts > 1 else contextlib.nullcontext():
                    xs_n, _, es_n, r_n = plain(x_n, e)
                same_n = decisions(r_n, xs_n, es_n, x_n)
                flips |= ~same_n
                drift |= same_n & ~agree(r_n, xs_n)
                dw = r_n.w.double() - r.w.double()
                wsum = r.w.double().sum()
                spread = max(spread, float(dw.square().sum().sqrt() / wsum),
                             float(dw.sum().abs() / wsum))
            differ, outside = int((~same).sum()), int((same & ~within).sum())
            n_moved = int((flips | drift).sum())
            allow_dec, allow_states = (a + 3 * a**0.5 for a in (
                max(0.001 * n, int(flips.sum())), max(0.001 * n, int(drift.sum()))))
            mode = "fixed-uniform" if fixed else "Philox"
            what = (f"{head}, eps {eps}, beta {beta}, "
                    f"{'max_depth' if nuts else 'M'} {m}, {held} iterations, {mode}"
                    f"{'' if stream else ', run only'})")
            check(deep or n_moved <= INFORMATIVE * n, f"{what}: the perturbed runs move "
                  f"{n_moved} chains, more than {INFORMATIVE:.0%}")
            if fixed and not nuts:
                exact = torch.equal(runs[0][0].evals, r.evals)
                if stream:
                    exact = exact and torch.equal(es_k, es_r) and torch.equal(es_k[-1], so_k.evals)
                check(exact, f"{what}: fixed-uniform counters differ")
            check(differ <= allow_dec, f"{what}: decisions differ on {differ} chains, "
                  f"{allow_dec:.4g} allowed")
            check(deep or outside <= allow_states, f"{what}: {outside} chains with equal "
                  f"decisions outside rtol 1e-4, {allow_states:.4g} allowed")
            k = runs[0][0]
            if variant in ("control", "malt"):
                check(bool((k.w == held).all()) and bool((ws_k == 1).all()), f"{what}: w, ws")
            w_tol = max(1e-4, 2 * spread)
            if mj:
                assert_close(k.w.sum(), r.w.sum(), w_tol, 0.0, f"{what} sum of w")
            ok = same & within
            dx = (k.x - r.x).abs()
            err = float(dx[:, ok].max()) if bool(ok.any()) else float(dx.max())
            if fixed:
                errs[key] = max(errs.get(key, 0.0), err)
            leaves = (f"; {float(r.evals.double().mean()) / held:.4g} leaves/iteration"
                      if nuts else "")
            phase("30 precision kernels", f"{what}: decisions equal on {1 - differ / n:.5f} "
                  f"({differ} differ); x,v,g,u{' and stream xs' if stream else ''} rtol 1e-4 on "
                  f"all but {outside} of the others (max|dx| {err:.3g}"
                  f"{'; reported, deep trees' if deep else ''}); one-ulp nudges of x, eps"
                  f" and the split-depth sums change {int(flips.sum())} "
                  f"chains' decisions and move {int(drift.sum())} more past rtol 1e-4 in the "
                  f"plain version alone (limits {allow_dec:.4g}, {allow_states:.4g})"
                  f"{f'; sum of w rtol {w_tol:.3g}' if mj else ''}{leaves}")
    return errs


def precision_sweep(cm):
    """Phase 31: the precision sweep in process (``bench_mm_precision.main``
    at its defaults: 4,096 chains, 2,000 steps, best of 3), every count set
    to 0 just before; each entry's run-kernel launches are its own."""
    from mjhmc_tpu_torch import bench_mm_precision

    cm.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench_mm_precision.main([])
    seconds = time.perf_counter() - t0
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    keys = [f"{c}/{p}" for c in ("sparse_coding", "product_of_t") for p in cm.PRECISIONS]
    check(rc == 0 and sorted(k for k in rec if k != "device") == sorted(keys),
          f"bench_mm_precision: rc {rc}, keys {sorted(rec)}")
    for k in keys:
        r = rec[k]
        check(r["steps_per_sec"] > 0 and r["launches"] == 1 + bench_mm_precision.TRIALS
              and len(r["var_head"]) == 4 and all(0 < v < 1e6 for v in r["var_head"]),
              f"bench_mm_precision {k}: {r}")
    phase("31 precision sweep", f"{json.dumps(rec)}; {seconds:.4g} s host clock")
    return rec


def precision_variances(cm, rec):
    """Phase 32: sparse coding's dwell-weighted head variances at each
    precision (the sweep's, one seed) against highest's. The noise floor is
    highest against itself with a second seed; bf16x3 and bf16x2 are held
    within the larger of 1% and three times it, default within 2.5% (the
    dwell shift the JAX docstring, pallas_mjhmc.py:469-474, expects) plus
    three times it."""
    from mjhmc_tpu_torch import bench_mm_precision
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    def shift(var):
        ref = rec["sparse_coding/highest"]["var_head"]
        return max(abs(a / b - 1) for a, b in zip(var, ref))

    nb, steps = rec["device"]["nbatch"], rec["device"]["steps"]
    second = bench_mm_precision.time_engine(BENCHMARK_CONFIGS["sparse_coding"], "highest", nb,
                                            steps, "cuda", seed=1)
    floor = shift(second["var_head"])
    limit = max(0.01, 3 * floor)
    limits = {"bf16x3": limit, "bf16x2": limit, "default": 0.025 + 3 * floor}
    got = {p: shift(rec[f"sparse_coding/{p}"]["var_head"]) for p in limits}
    for p, lim in limits.items():
        check(got[p] <= lim, f"sparse_coding {p}: head variances {got[p]:.4g} from highest's, "
              f"limit {lim:.4g}")
    phase("32 precision variances", f"sparse_coding ({nb} chains, {steps} steps after the sweep's "
          f"warm and timed runs): largest |var/var_highest - 1| of the four head dims: seed floor "
          f"(highest, second seed) {floor:.4g}; bf16x3 {got['bf16x3']:.4g}, bf16x2 "
          f"{got['bf16x2']:.4g} (limit {limit:.4g}); default {got['default']:.4g} (limit "
          f"{limits['default']:.4g}); "
          f"highest {rec['sparse_coding/highest']['var_head']}, second seed "
          f"{second['var_head']}")
    return floor, got


def precision_timing(cm, card):
    """Phase 33: ms per iteration (CUDA events) of every bf16 instance, run
    and stream (the sweep's: run), through the engines at the presets'
    widths, each beside its full-f32 twin in the same loop, and the plain
    version at the bf16 precision. The branch instances are timed with a
    mass. Every count is set to 0 just before each engine and read after:
    the launches at the engine's precision. Returns {(config, instance,
    precision): dict(run_ms, stream_ms, plain_ms, plain_stream_ms, grads,
    iters, n, launches=(run, stream))}."""
    rows = {}
    ecls = {"nuts": cm.CudaNUTS, "mjhmc": cm.CudaMJHMC, "control": cm.CudaControlHMC,
            "malt": cm.CudaMALT}
    iters_of = {"product_of_t": {"mjhmc": 300, "control": 300, "malt": 80, "nuts": 20},
                "sparse_coding": {"mjhmc": 60, "control": 60, "malt": 15, "nuts": 3},
                "logreg": {"mjhmc": 300, "control": 300, "malt": 150, "nuts": 40}}
    jax_default, sweep = mm_precisions(cm)
    cases = [(c, key, p, True) for c, p in jax_default.items()
             for key in ("mjhmc", "mjhmc branches", "control", "malt", "nuts", "nuts branches")]
    cases += [(c, "mjhmc", p, False) for c, ps in sweep.items() for p in ps]
    presets = mm_presets()
    for cname, key, prec, stream in cases:
        dist, cfg, mass, nuts_eps = presets[cname]
        body = key.split()[0]
        nuts = body == "nuts"
        n, m = cfg.nbatch, MM_NUTS_DEPTH if nuts else cfg.num_leapfrog_steps
        eps = nuts_eps if nuts else cfg.epsilon
        beta = {"mjhmc": 0.1, "control": 0.2, "malt": 1.0, "nuts": 0.0}[body]
        kw = dict(inv_mass=mass) if key.endswith("branches") else {}
        iters = iters_of[cname][body]
        for p in ("highest", prec):
            if (cname, key, p) in rows:  # the sweep's twin: timed with the default's
                continue
            cm.reset_counts()
            eng = ecls[body](dist, epsilon=eps, beta=beta, num_leapfrog_steps=m, nbatch=n,
                             seed=4, device=DEV, **kw)
            eng.spec = at(eng.spec, p)
            eng.run(2)
            before = eng.grad_evals
            run_ms = events_ms(lambda: eng.run(iters)) / iters
            grads = eng.grad_evals - before
            stream_ms = events_ms(lambda: eng.sample(iters)) / iters if stream else None
            launches = counts(cm, f"{p}_launches", mm=True)
            check(launches[0] > 0 and (launches[1] > 0 or not stream),
                  f"{key} {cname} at {p}: kernels not launched {launches}")
            rows[(cname, key, p)] = dict(run_ms=run_ms, stream_ms=stream_ms, grads=grads,
                                         iters=iters, n=n, launches=launches)
        row = rows[(cname, key, prec)]
        plain_iters = 1 if nuts else 3
        args = (eng.spec, *initial_state(dist, n, seed=5, inv_mass=kw.get("inv_mass")), 99, eps,
                beta)
        pkw = dict(variant=body, **kw)
        cm.run_reference(*args, 1, m, **pkw)
        row["plain_ms"] = events_ms(lambda: cm.run_reference(*args, plain_iters, m, **pkw)) / \
            plain_iters
        row["plain_stream_ms"] = events_ms(
            lambda: cm.stream_reference(*args, plain_iters, 1, m, **pkw)) / plain_iters \
            if stream else None
        twin = rows[(cname, key, "highest")]
        ms = f"run {row['run_ms']:.6g}" + (f", stream {row['stream_ms']:.6g}" if stream else "")
        tw = f"run {twin['run_ms']:.6g}" + (f", stream {twin['stream_ms']:.6g}" if stream else "")
        plain = f"run {row['plain_ms']:.6g}" + (
            f", stream {row['plain_stream_ms']:.6g}" if stream else "")
        phase("33 precision timing", f"{key} {cname} ({n} chains, eps {eps}, beta {beta}, "
              f"{'max_depth' if nuts else 'M'} {m}{', a mass' if kw else ''}): {prec} {ms} "
              f"ms/iteration; highest {tw}; plain version at {prec} {plain}; "
              f"{grads / (n * iters):.5g} {'leaves' if nuts else 'gradients'} per chain and "
              f"iteration; launches {prec} {row['launches']}, highest {twin['launches']} [{card}]")
    return rows


def precision_entries(entry, errs, sweep, rows, ceilings, main_runs):
    """The kernels line's entries of the bf16 instances: every body of each
    matmul preset at its JAX default precision (``_branches``: the BR=true
    instance of MJHMC and NUTS, timed with a mass), run and stream, and the
    sweep's MJHMC runs. Errors from phase 30, times from phase 33 (beside
    ``highest_ms``, the full-f32 twin's in the same loop). Launches, named
    in ``launches_from``: the main path's calls that run the instance
    (``main_runs``: `sample` in phases 6, 19 and 23, ``from_warmup`` in phase
    22), the sweep's runs phase 31's in-process sweep, and phase 33's
    engines only where no such call runs it. ``bound_ms_measured_ceilings``:
    the same work over the FP32 FMA and ``mma.sync`` ceilings measured in
    the dossier (phase 14)."""
    from mjhmc_tpu_torch.bench_mfu import PASSES

    out = []
    variants = {"nuts": NUTS_VARIANT, "mjhmc": MJHMC_VARIANT, "control": CONTROL_VARIANT,
                "malt": MALT_VARIANT}
    shapes = {"product_of_t": (36, 36), "sparse_coding": (128, 64), "logreg": (16, 256)}
    measured = (ceilings["fp32_fma_flops_per_s"], ceilings["tc_bf16_mma_sync_flops_per_s"])
    for (cname, key, prec), row in rows.items():
        if prec == "highest":
            continue
        body = key.split()[0]
        sweep_run = row["stream_ms"] is None
        d, k = shapes[cname]
        twin = rows[(cname, key, "highest")]
        for idx, (suffix, src) in enumerate((("run", MM_RUN_SRC), ("stream", MM_STREAM_SRC))):
            if sweep_run and idx:
                continue
            stream = idx == 1
            ms = "stream_ms" if stream else "run_ms"
            emits = row["iters"] if stream else 0
            args = (cname, body, d, k, row["n"], row["iters"], row["grads"], emits)
            br = dict(mass=key.endswith("branches"))
            main = main_runs.get((cname, key), ((0, 0), ""))
            if sweep_run:
                launches, origin = sweep[f"{cname}/{prec}"]["launches"], "phase 31: the sweep"
            elif main[0][idx] > 0:
                launches, origin = main[0][idx], main[1]
            else:
                launches = row["launches"][idx]
                origin = "phase 33: the engine (no sample or from_warmup call here runs it)"
            name = f"{body}_mm_{suffix}{'_branches' if key.endswith('branches') else ''}"
            out.append(entry(
                f"{name}[{cname}, {prec}]", MM_KERNEL_SRC, src, launches, errs[(cname, prec, key)],
                row[ms], row["plain_stream_ms" if stream else "plain_ms"],
                bound(*args, passes=PASSES[prec], **br), launches_from=origin, precision=prec,
                dot=PRECISION_SRC,
                variant=variants[body], energy=MM_ENERGIES[cname], highest_ms=twin[ms],
                bound_ms_measured_ceilings=bound(*args, passes=PASSES[prec], peaks=measured,
                                                 **br)[0],
                shape=f"{cname}, {row['n']} chains, {'max_depth 8' if body == 'nuts' else 'preset'}"
                      f"{', a mass' if key.endswith('branches') else ''}"
                      f"{', thin 1' if stream else ''}, ms per iteration"))
    return out


def nuts_breakdown(cm, card):
    """Phase 36: the matmul NUTS run's per-leaf phase breakdown, from its
    PROF instance (``cuda_mjhmc.nuts_mm_profile``: clock64() stamps by
    thread 0 and by the last warp's first thread), at the presets' widths
    and settings as phase 33 runs them (the JAX default precision, max_depth
    8, from the engine's state after two iterations). Per preset: the tile
    (chains and threads a block, shared bytes, blocks an SM holds), each
    phase's share of thread 0's cycles and its cycles per leaf step (wall
    time: the SM's other resident blocks issue meanwhile), the share of the
    last warp's cycles spent waiting at barriers, and the PROF run's time
    beside the plain instance's from the same state. Returns {config: that
    record}."""
    names = cm.NUTS_PROF_PHASES
    iters_of = {"product_of_t": 20, "sparse_coding": 3, "logreg": 40}
    out = {}
    for cname, (dist, cfg, _, eps) in mm_presets().items():
        n, iters = cfg.nbatch, iters_of[cname]
        eng = cm.CudaNUTS(dist, epsilon=eps, num_leapfrog_steps=MM_NUTS_DEPTH, nbatch=n,
                          seed=4, device=DEV)
        eng.run(2)
        st = (eng.spec, eng.x, eng.v, eng.g, eng.u)
        chains, threads, smem, resident = cm.nuts_mm_tile(eng.spec, MM_NUTS_DEPTH)
        cm.nuts_mm_profile(*st, 98, eps, 1, MM_NUTS_DEPTH)  # the instance's first launch
        got = {}
        prof_ms = events_ms(lambda: got.update(p=cm.nuts_mm_profile(
            *st, 99, eps, iters, MM_NUTS_DEPTH))) / iters
        z = torch.zeros_like(eng.u)
        run_ms = events_ms(lambda: cm.cuda_mjhmc_mm_run(
            *st, z, z, 99, eps, 0.0, iters, MM_NUTS_DEPTH, variant="nuts")) / iters
        blocks = got["p"].shape[0]
        prof = got["p"].double().sum(dim=0)  # (observer, phase)
        leaves = float(prof[0, -1])
        cyc = prof[:, :-1]
        total = cyc.sum(dim=1)
        check(leaves > 0 and bool((total > 0).all()), f"{cname}: empty PROF record")
        rec = dict(
            chains_per_block=chains, threads=threads, smem_bytes=smem, blocks=blocks,
            resident_blocks_per_sm=resident,
            leaf_steps_per_block_iteration=leaves / (blocks * iters),
            cycles_per_leaf=float(total[0]) / leaves,
            share={nm: round(float(cyc[0, i] / total[0]), 5) for i, nm in enumerate(names[:-1])},
            cycles_per_leaf_by_phase={nm: round(float(cyc[0, i]) / leaves, 1)
                                      for i, nm in enumerate(names[:-1])},
            last_warp_barrier_share=float(cyc[1, names.index("barrier_waits")] / total[1]),
            prof_ms=prof_ms, run_ms=run_ms, iters=iters)
        out[cname] = rec
        phase("36 nuts breakdown", f"{cname} at {eng.spec.precision} ({n} chains, eps {eps}, "
              f"max_depth {MM_NUTS_DEPTH}, {iters} iterations): {json.dumps(rec)} [{card}]")
    return out


def ew_nuts_breakdown(cm, card):
    """Phase 36: the elementwise NUTS run's phase breakdown from its PROF
    instance (``bench_mm_ab.run_ew_profiles``: every chain's clock64()
    stamps on gauss2d, 10,240 chains at ε 0.3, max_depth 7, and the funnel,
    1,024 chains at its preset's ε, max_depth 8, from the state two
    iterations in): each phase's share of the chains' cycles and its cycles
    a leaf, the share of the warps' leaf slots that ran a live leaf (counted
    by one lane a step), the share lanes that ran on at once would keep, the
    longest chain's cycles over the mean, and the PROF run's time beside
    the plain instance's."""
    from mjhmc_tpu_torch.bench_mm_ab import run_ew_profiles

    for key, rec in run_ew_profiles().items():
        check(rec["cycles_per_leaf"] > 0 and 0 < rec["leaf_slot_share"] <= 1,
              f"{key}: empty PROF record")
        phase("36 nuts breakdown", f"elementwise {key} ({rec['chains']} chains, eps {rec['eps']}, "
              f"max_depth {rec['max_depth']}, {rec['iters']} iterations): {json.dumps(rec)} "
              f"[{card}]")


def ew_body_breakdown(cm, card):
    """Phase 36: the elementwise MJHMC, control and MALT runs' phase
    breakdowns from their PROF instances (``bench_mm_ab.run_ew_body_profiles``:
    each body on the rough well, 10,000 chains, and the funnel, 1,024; MJHMC
    and control with a mass on gauss50d, 4,096; every chain's clock64()
    stamps, by the first lane of its group, from the state two iterations
    in): each phase's share of the chains' cycles and its cycles a
    chain-iteration, MJHMC's shares of chain-iterations that began with an
    invalid cache and of those whose warp held one, the lanes a chain and
    threads a block, and the PROF run's time beside the plain instance's."""
    from mjhmc_tpu_torch.bench_mm_ab import ew_nuts_dist, run_ew_body_profiles

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key, rec in run_ew_body_profiles().items():
        _, cname, body, _ = key.split("/")
        dist = ew_nuts_dist(cname)[0]
        lanes = cm.ew_lanes(body, cm.energy_spec_for(dist), dist.ndims)
        check(rec["chain_cycles_mean"] > 0, f"{key}: empty PROF record")
        phase("36 ew breakdown", f"{key} ({rec['chains']} chains, {lanes} lanes a chain, "
              f"{cm.ew_threads(lanes, rec['chains'], sms)} threads a block, eps {rec['eps']}, "
              f"beta {rec['beta']}, {rec['iters']} iterations): {json.dumps(rec)} [{card}]")


def mm_breakdown(cm, card):
    """Phase 36: mm_kernel's per-iteration phase breakdown from its PROF
    instances (``bench_mm_ab.run_profiles``: MJHMC and MALT on sparse coding
    at bf16x3, MALT on logreg at one bf16 pass, the presets' widths, 10
    iterations from the state two iterations in): the tile (chains and
    threads a block, shared bytes, blocks an SM holds), each phase's share
    of thread 0's cycles and its cycles per gradient (wall time: the SM's
    other resident blocks issue meanwhile), the last warp's share of cycles
    at barriers, and the PROF run's time beside the plain instance's."""
    from mjhmc_tpu_torch.bench_mm_ab import run_profiles
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    for key, rec in run_profiles().items():
        cname, body, _ = key.split("/")
        spec = cm.energy_spec_for(BENCHMARK_CONFIGS[cname].make_distribution())
        tile = cm.mm_tile(spec, body, body != "mjhmc")
        check(rec["cycles_per_gradient"] > 0 and rec["gradients_per_block_iteration"] > 0,
              f"{key}: empty PROF record")
        rec = dict(chains_per_block=tile[0], threads=tile[1], smem_bytes=tile[2],
                   resident_blocks_per_sm=tile[3], **rec)
        phase("36 mm breakdown", f"{key} ({BENCHMARK_CONFIGS[cname].nbatch} chains): "
              f"{json.dumps(rec)} [{card}]")


# ---- slice G: the chain-sharded runtime (kernel #7) -------------------------
SHARDED_SRC = "mjhmc_tpu/ops/pallas_mjhmc.py:2068"  # sharded_pallas_mjhmc_run
#: the torch.distributed calls counted around the sharded runs (isend and
#: irecv stay unwrapped: P2POp checks its op against them)
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "broadcast", "all_to_all", "all_to_all_single",
               "barrier", "batch_isend_irecv", "reduce", "gather", "scatter", "send", "recv")
SHARDED_SEED = 2024
RANK_TIMEOUT = 300  # seconds for each process of phase 35


@contextlib.contextmanager
def counting_collectives():
    """Wrap the torch.distributed collectives; yields the names called."""
    import torch.distributed as dist

    calls, saved = [], {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name, fn):
        def counted(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def sharded_cases(cm):
    """(label, distribution, spec, chains, iterations, (ε, β, M)) of the
    sharded runs at the presets' widths: rough_well at 10,000 and 102,400
    chains, sparse coding at 8,192 at its JAX default precision."""
    from mjhmc_tpu_torch.models import RoughWell, SparseCoding

    rw, sc = RoughWell(), SparseCoding()
    spec_sc = cm.energy_spec_for(sc)
    check(spec_sc.precision == "bf16x3", f"sparse coding's default is {spec_sc.precision}")
    return [("rough_well 10,000", rw, cm.energy_spec_for(rw), 10_000, 100, (EPS, BETA, M)),
            ("rough_well 102,400", rw, cm.energy_spec_for(rw), 102_400, 100, (EPS, BETA, M)),
            ("sparse_coding 8,192 bf16x3", sc, spec_sc, 8192, 20, (0.02, 0.1, 10))]


def sharded_world1(cm, card):
    """Phase 34: kernel #7 at world size 1 under NCCL, full width. The
    sharded run as a user calls it (every count 0 just before, read after:
    one launch, no collective) is bit-identical to the direct call on every
    RunOut field; held against its plain version (rough well: fixed-uniform
    evals exact and x, v, g, u within rtol 1e-4 after 5 iterations, Philox
    counters on >= 0.999 of the chains; sparse coding at bf16x3: phase 30's
    contraction check at eps 0). sharded_moments equals CudaMJHMC.moments
    of the same emissions (var rtol 1e-4, mean within 1e-5 of |mean| + sd);
    the adaptive step issues one all_reduce per iteration; the sharded
    checkpoint round trip and its resume are bit-exact; bench_scaling
    --devices 1 prints its line (its launches: the main path of the rough
    well's row); #7 is timed (CUDA events) beside the direct call and its
    plain version. Returns the kernels line's two entries' numbers."""
    import tempfile

    import torch.distributed as dist

    from mjhmc_tpu_torch import bench_scaling
    from mjhmc_tpu_torch.bench_mfu import PASSES
    from mjhmc_tpu_torch.models import RoughWell
    from mjhmc_tpu_torch.parallel.collectives import sharded_moments
    from mjhmc_tpu_torch.parallel.mesh import make_chain_mesh, shard_chain_pytree
    from mjhmc_tpu_torch.parallel.multihost import free_port, initialize
    from mjhmc_tpu_torch.samplers import adaptive_mjhmc_run, da_init
    from mjhmc_tpu_torch.samplers.state import make_mj_state
    from mjhmc_tpu_torch.utils.checkpoint import load_sharded_pytree, save_sharded_pytree

    info = initialize(f"127.0.0.1:{free_port()}", 1, 0, device=DEV)
    check(info["initialized"] and info["backend"] == "nccl" and info["process_count"] == 1,
          f"world size 1 under NCCL: {info}")
    rows = {}
    try:
        mesh = make_chain_mesh(1, device=DEV)
        sharded = cm.sharded_cuda_mjhmc_run
        for label, dist_, spec, n, iters, (eps, beta, m) in sharded_cases(cm):
            fn = wrappers_for(cm, spec)[0]
            st = initial_state(dist_, n, seed=11)
            cm.reset_counts()
            with counting_collectives() as calls:
                out = sharded(mesh, spec, *st, SHARDED_SEED, eps, beta, iters, m)
                torch.cuda.synchronize()
            launches = fn.sharded_launches
            check(launches == 1 and not calls,
                  f"{label}: {launches} launches, collectives {calls} (want 1, none)")
            direct = fn(spec, *st, SHARDED_SEED, eps, beta, iters, m)
            same = [f for f, a, b in zip(cm.RunOut._fields, out, direct) if torch.equal(a, b)]
            check(len(same) == len(cm.RunOut._fields), f"{label}: only {same} bit-identical "
                  "to the direct call")
            # against the plain version
            if spec.__class__.__name__ == "RoughWellSpec":
                args = (spec, *st, SHARDED_SEED, eps, beta)
                k5 = sharded(mesh, *args, 5, m, fixed_uniform=True)
                r5 = cm.run_reference(*args, 5, m, fixed_uniform=True)
                check(torch.equal(k5.evals, r5.evals), f"{label}: fixed-uniform evals differ")
                atol = 1e-4 * float(r5.x.abs().max())
                err = max(assert_close(getattr(k5, f), getattr(r5, f), 1e-4, atol,
                                       f"{label} {f} after 5") for f in ("x", "v", "grad", "u"))
                kp = sharded(mesh, *args, 5, m)
                same_c = float((kp.evals == cm.run_reference(*args, 5, m).evals).double().mean())
                check(same_c >= 0.999, f"{label}: Philox counters equal on {same_c:.5f}")
                held = (f"fixed-uniform evals exact, x v g u rtol 1e-4 after 5 (max abs err "
                        f"{err:.3g}); Philox counters equal on {same_c:.5f} of chains")
            else:
                bad, limit, moved, rel_k, _ = force_check(
                    cm, spec, dist_, n, 0.1, {}, False,
                    run=lambda *a, **k: sharded(mesh, *a, **k))
                check(bad <= limit, f"{label}, eps 0: gradient or energy outside rtol 1e-4 on "
                      f"{bad} chains, {limit:.4g} allowed")
                st0 = initial_state(dist_, n, seed=3)
                k0 = sharded(mesh, spec, *st0, 7, 0.0, 0.1, 1, 1, fixed_uniform=True)
                r0 = cm.run_reference(spec, *st0, 7, 0.0, 0.1, 1, 1, True)
                err = float((k0.grad - r0.grad).abs().max())
                held = (f"eps 0 gradient and energy rtol 1e-4 on all but {bad} chains (limit "
                        f"{limit:.4g}; split-depth sums move {moved}); max abs gradient error "
                        f"{err:.3g}, largest relative {rel_k:.3g}")
            phase("34 sharded world 1", f"{label}: {iters} iterations, Philox, one launch, no "
                  f"collective; every RunOut field bit-identical to the direct call; {held}")
            rows[label] = dict(err=err, launches=launches)

        # timing: #7 beside the direct call, CUDA events, in turns
        for label, dist_, spec, n, _, (eps, beta, m) in sharded_cases(cm):
            if label == "rough_well 102,400":
                continue
            fn = wrappers_for(cm, spec)[0]
            iters = 2000 if n == 10_000 else 200
            st = initial_state(dist_, n, seed=5)
            sharded(mesh, spec, *st, 1, eps, beta, 5, m)
            ms = {"sharded": [], "direct": []}
            for turn in ("sharded", "direct", "direct", "sharded"):
                run = (lambda: sharded(mesh, spec, *st, 3, eps, beta, iters, m)) \
                    if turn == "sharded" else (lambda: fn(spec, *st, 3, eps, beta, iters, m))
                ms[turn].append(events_ms(run) / iters)
            grads = float(sharded(mesh, spec, *st, 3, eps, beta, iters, m).evals.double().sum())
            p_iters = 50 if n == 10_000 else 5
            p_ms = events_ms(
                lambda: cm.run_reference(spec, *st, 3, eps, beta, p_iters, m)) / p_iters
            d, k = (2, 0) if n == 10_000 else (128, 64)
            cname = "rough_well" if n == 10_000 else "sparse_coding"
            passes = PASSES[spec.precision] if hasattr(spec, "precision") else 0
            rows[label].update(ms=min(ms["sharded"]), direct_ms=min(ms["direct"]), plain_ms=p_ms,
                               bound=bound(cname, "mjhmc", d, k, n, iters, grads, passes=passes),
                               iters=iters, n=n)
            phase("34 sharded world 1", f"{label}: #7 {min(ms['sharded']):.6g} ms/iteration, the "
                  f"direct call {min(ms['direct']):.6g} (turns {ms}), plain version "
                  f"{p_ms:.6g} ms/iteration ({iters} iterations) [{card}]")

        # sharded_moments against the engine's accumulators, same emissions
        eng = cm.CudaMJHMC(RoughWell(), nbatch=10_000, seed=6, device=DEV)
        eng.run(100)
        xs, ws = eng.sample(200)
        mean_e, var_e = cm.CudaMJHMC.moments(eng.last_out)
        with counting_collectives() as calls:
            mean_s, var_s = sharded_moments(xs.permute(1, 0, 2).reshape(2, -1), ws.reshape(-1),
                                            mesh)
        check(calls == ["all_reduce"], f"sharded_moments issued {calls}")
        sd = var_e.double().sqrt()
        dm = float(((mean_s - mean_e).double().abs() / (mean_e.double().abs() + sd)).max())
        dv = float(((var_s - var_e).double().abs() / var_e.double().abs()).max())
        check(dm <= 1e-5 and dv <= 1e-4, f"sharded_moments vs CudaMJHMC.moments: mean {dm:.3g} "
              f"(of |mean| + sd), var {dv:.3g}")
        phase("34 sharded world 1", f"sharded_moments of 200 emissions x 10,000 chains: one "
              f"all_reduce; mean within {dm:.3g} of |mean| + sd, var within {dv:.3g} relative "
              f"of CudaMJHMC.moments")

        # the adaptive step under the mesh: one all_reduce per iteration
        rw = RoughWell()
        state = shard_chain_pytree(make_mj_state(rw, torch.Generator().manual_seed(3), 10_000, DEV),
                                   mesh)
        with counting_collectives() as calls:
            _, da, aux = adaptive_mjhmc_run(rw, state, da_init(1.0),
                                            torch.Generator().manual_seed(4), 5, BETA, M,
                                            mesh=mesh)
        check(calls == ["all_reduce"] * 5 and da.step == 5, f"adaptive step: {calls}")
        phase("34 sharded world 1", f"adaptive_mjhmc_run under the mesh (10,000 chains, 5 "
              f"iterations): collectives {calls}; eps {aux['eps_trace'].tolist()}")

        # the sharded checkpoint: round trip and resume, bit-exact
        label, dist_, spec, n, _, (eps, beta, m) = sharded_cases(cm)[1]
        out = sharded(mesh, spec, *initial_state(dist_, n, seed=11), 1, eps, beta, 10, m)
        with tempfile.TemporaryDirectory() as tmp:
            prefix = str(Path(tmp) / "carry")
            save_sharded_pytree(prefix, out, mesh)
            back = load_sharded_pytree(prefix, cm.RunOut(*(torch.zeros_like(t) for t in out)),
                                       mesh)
        check(all(torch.equal(a, b) for a, b in zip(out, back)), "checkpoint round trip")
        resumed = sharded(mesh, spec, *back[:6], 2, eps, beta, 10, m)
        direct = sharded(mesh, spec, *out[:6], 2, eps, beta, 10, m)
        check(all(torch.equal(a, b) for a, b in zip(resumed, direct)), "resume not bit-exact")
        phase("34 sharded world 1", f"save_sharded_pytree / load_sharded_pytree of a {label} "
              "RunOut: round trip and resume bit-exact")

        # bench_scaling on the one card: the rough well's main path, its
        # last run traced (--profile) and the collective share read from the
        # trace's kernels (world size 1: no NCCL kernel, the share 0)
        cm.reset_counts()
        buf = io.StringIO()
        with tempfile.TemporaryDirectory() as prof, contextlib.redirect_stdout(buf):
            check(bench_scaling.main(["--devices", "1", "--profile", prof]) == 0,
                  "bench_scaling failed")
        launches = cm.cuda_mjhmc_run.sharded_launches
        rec, coll = (json.loads(ln) for ln in buf.getvalue().strip().splitlines()[-2:])
        check(rec["metric"] == "leapfrog_steps_per_sec" and rec["devices"] == 1
              and rec["chains"] == 2048 and rec["value"] > 0 and launches == 5,
              f"bench_scaling: {rec}, launches {launches}")
        check(coll["metric"] == "collective_time_fraction" and coll["devices"] == 1
              and coll["unit"] == "fraction" and 0.0 <= coll["value"] <= 1.0
              and coll["total_us"] > 0 and set(coll) == {"metric", "devices", "value", "unit",
                                                          "collective_us", "total_us", "by_op"},
              f"bench_scaling --profile: {coll}")
        rows["bench_scaling"] = dict(launches=launches, rec=rec)
        phase("34 sharded world 1", f"bench_scaling --devices 1 --profile: {json.dumps(rec)}; "
              f"{json.dumps(coll)} (the trace's kernel time); launches {launches} [{card}]")
    finally:
        dist.destroy_process_group()
    return rows


def sharded_two_processes(cm):
    """Phase 35: two processes share cuda:0 under gloo (NCCL refuses two
    ranks on one card). Each runs rough_well at 2 x 51,200 chains and sparse
    coding at 2 x 4,096 (bf16x3) sharded: rank r is bit-identical to a
    direct launch on its block at seed + r·131071 (rank 1: not at the seed
    itself), with no collective in the run; sharded_moments of the run's x
    and w over both ranks (gloo all_reduce of CUDA tensors) is within rtol
    1e-5 (mean, of |mean| + sd) and 1e-4 (var) of the dense float64 moments
    the parent computes from both blocks."""
    import tempfile

    import numpy as np

    from mjhmc_tpu_torch.parallel.multihost import free_port

    addr = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--phase35-rank", str(r), addr, tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"phase 35 rank {r} exited {p.returncode}:\n{log[-4000:]}")
        ranks = [dict(np.load(Path(tmp) / f"rank{r}.npz")) for r in range(2)]
    for label in ("rough_well", "sparse_coding"):
        for r, rk in enumerate(ranks):
            check(bool(rk[f"{label}/identical"]) and int(rk[f"{label}/collectives"]) == 0,
                  f"{label} rank {r}: not bit-identical to its direct launch, or collectives")
        check(bool(ranks[1][f"{label}/unoffset_differs"]), f"{label}: rank 1 ran at the seed")
        x = np.concatenate([rk[f"{label}/x"] for rk in ranks], axis=1).astype(np.float64)
        w = np.concatenate([rk[f"{label}/w"] for rk in ranks]).astype(np.float64)
        m_ref = (w * x).sum(axis=1) / w.sum()
        v_ref = (w * x * x).sum(axis=1) / w.sum() - m_ref**2
        dm = max(float((np.abs(rk[f"{label}/mean"] - m_ref) / (np.abs(m_ref) + np.sqrt(v_ref)))
                       .max()) for rk in ranks)
        dv = max(float((np.abs(rk[f"{label}/var"] - v_ref) / np.abs(v_ref)).max()) for rk in ranks)
        check(dm <= 1e-5 and dv <= 1e-4, f"{label}: sharded_moments over 2 ranks vs dense: "
              f"mean {dm:.3g}, var {dv:.3g}")
        phase("35 sharded two processes", f"{label} ({ranks[0][label + '/n']} chains, 2 ranks on "
              f"cuda:0 under gloo): each rank bit-identical to a direct launch on its block at "
              f"seed + r*131071, no collective in the run; sharded_moments mean within {dm:.3g} "
              f"(of |mean| + sd), var {dv:.3g} relative of the dense moments")


def phase35_rank(rank: int, addr: str, out: str) -> int:
    """One process of phase 35 (``chip_smoke.py --phase35-rank r addr dir``)."""
    import numpy as np

    import torch.distributed as dist

    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm
    from mjhmc_tpu_torch.parallel.collectives import sharded_moments
    from mjhmc_tpu_torch.parallel.mesh import chain_sharding, make_chain_mesh
    from mjhmc_tpu_torch.parallel.multihost import initialize

    info = initialize(addr, 2, rank, device=DEV, backend="gloo")
    check(info["initialized"] and info["process_count"] == 2, f"rank {rank}: {info}")
    res = {}
    try:
        mesh = make_chain_mesh(2, device=DEV)
        check(mesh.device == torch.device("cuda", 0), f"rank {rank} on {mesh.device}")
        cases = {c[0]: c for c in sharded_cases(cm)}
        for label, key in (("rough_well", "rough_well 102,400"),
                           ("sparse_coding", "sparse_coding 8,192 bf16x3")):
            _, dist_, spec, n, iters, (eps, beta, m) = cases[key]
            fn = wrappers_for(cm, spec)[0]
            blk = chain_sharding(mesh, n)
            st = tuple(t[..., blk].contiguous() for t in initial_state(dist_, n, seed=12))
            with counting_collectives() as calls:
                o = cm.sharded_cuda_mjhmc_run(mesh, spec, *st, SHARDED_SEED, eps, beta, iters, m)
                torch.cuda.synchronize()
            d = fn(spec, *st, SHARDED_SEED + rank * cm.RANK_SEED_STRIDE, eps, beta, iters, m)
            res[f"{label}/identical"] = all(torch.equal(a, b) for a, b in zip(o, d))
            res[f"{label}/collectives"] = len(calls)
            if rank == 1:
                u = fn(spec, *st, SHARDED_SEED, eps, beta, iters, m)
                res[f"{label}/unoffset_differs"] = not all(torch.equal(a, b) for a, b in zip(o, u))
            mean, var = sharded_moments(o.x, o.w, mesh)
            res.update({f"{label}/mean": mean.cpu().numpy(), f"{label}/var": var.cpu().numpy(),
                        f"{label}/x": o.x.cpu().numpy(), f"{label}/w": o.w.cpu().numpy(),
                        f"{label}/n": n})
        np.savez(Path(out) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()
    return 0


# ---- phase 38: ESS/s, the autocorrelation experiment, the ladder oracle ----
#: phase 38's bench_ess rows: (config, sampler, extra argv). Split-R-hat
#: needs a few tens of effective samples a chain (a stationary chain with e
#: of them gives about sqrt(1 + 2/e)): at 2,000 iterations the rough well's
#: MJHMC, control and MALT and product of t's MJHMC have 8.6, 12.4, 2.2 and
#: 5.6, so those rows emit every thin-th iteration: a window thin times
#: longer, the same 2,000-sample block
ESS_ROWS = [
    ("rough_well", "mjhmc", ["--thin", "8"]),
    ("rough_well", "control", ["--thin", "8"]),
    ("rough_well", "malt", ["--thin", "25"]),
    ("rough_well", "nuts-engine", []),
    ("product_of_t", "mjhmc", ["--thin", "32"]),
    # the plain NUTS syncs with the host at every leaf: bench_ess's
    # shortest window
    ("gauss2d", "nuts", ["--steps", "100", "--burn", "50"]),
]
ESS_TRIALS = 3  # bench_ess.measure's timed stream calls
#: the autocorrelation experiment's (chains, iterations): the preset's width
AC_CHAINS, AC_STEPS = 10_000, 2000


@contextlib.contextmanager
def recording(owner, name):
    """Wrap ``owner.name`` (a function or method); yields the list of
    (args, result) of each call made inside the block."""
    calls, fn = [], getattr(owner, name)

    @functools.wraps(fn)
    def recorded(*a, **k):
        out = fn(*a, **k)
        calls.append((a, out))
        return out

    setattr(owner, name, recorded)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


def geyer_ess_f64(x, w):
    """The dwell-weighted Geyer ESS of ``diagnostics/autocorr.py``
    recomputed in float64 where the block lies (torch.fft), chains in
    chunks. The lag sums over chains and dims are one inverse transform of
    the summed power spectra."""
    t, d, n = x.shape
    w = torch.ones((t, n), dtype=torch.float64, device=x.device) if w is None else w.double()
    nlags = t // 2
    nfft = 1 << (2 * t - 1).bit_length()
    chunk = max(1, (1 << 25) // (nfft * d))
    spans = [slice(i, i + chunk) for i in range(0, n, chunk)]
    mu = sum(torch.einsum("tdn,tn->d", x[:, :, c].double(), w[:, c]) for c in spans) / w.sum()

    def power(a):
        fa = torch.fft.rfft(a, n=nfft, dim=0)
        return fa.real ** 2 + fa.imag ** 2

    num = sum(power((x[:, :, c].double() - mu[None, :, None]) * w[:, None, c]).sum(dim=(1, 2))
              for c in spans)
    den = sum(power(w[:, c]).sum(dim=1) for c in spans)
    gamma = torch.fft.irfft(num, n=nfft)[:nlags] / (d * torch.fft.irfft(den, n=nfft)[:nlags])
    rho = gamma / gamma[0]
    pair = rho[: 2 * (nlags // 2)].reshape(-1, 2).sum(dim=1)
    positive = torch.cumprod((pair > 0.0).double(), dim=0)
    tau = max(1.0, -1.0 + 2.0 * float((pair * positive).sum()))
    return t * n / tau


def wrapper_counts(cm):
    """{(wrapper, count): n} of every nonzero launch count."""
    return {(fn.__name__, name): getattr(fn, name) for fn in cm.WRAPPERS
            for name in cm.COUNTS if getattr(fn, name)}


def ess_rows(cm, card):
    """Phase 38, the ESS/s rows: ``bench_ess.main`` as a user runs it, one
    row at a time with every count 0 just before, each record held to its
    checks (0 < ESS ≤ raw samples; the same block's ESS in float64 within
    rtol 1e-3; value = ESS / wall; 1 burn run and 1 + trials stream
    launches, none for the plain row; split-R̂ < 1.05 for the engine rows).
    Returns ({kernels-line entry: launches}, {(config, sampler): record})."""
    from mjhmc_tpu_torch import bench_ess
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.diagnostics import potential_scale_reduction

    launches, recs = {}, {}
    for cname, sampler, extra in ESS_ROWS:
        argv = ["--config", cname, "--sampler", sampler, *extra]
        cm.reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with recording(bench_ess, "effective_sample_size") as blocks, \
                contextlib.redirect_stdout(buf):
            rc = bench_ess.main(argv)
        seconds = time.perf_counter() - t0
        counts = wrapper_counts(cm)
        lines = buf.getvalue().strip().splitlines()
        check(rc == 0 and len(lines) == 1, f"bench_ess {argv}: rc {rc}, output {lines}")
        rec = json.loads(lines[0])
        det = rec["detail"]
        what = f"bench_ess {cname} {sampler}"
        check(0 < det["ess_total"] <= det["raw_samples"],
              f"{what}: ess {det['ess_total']} outside (0, {det['raw_samples']}]")
        check(rec["value"] == det["ess_total"] / det["sampling_wall_s"],
              f"{what}: value {rec['value']} is not ess / wall")
        check(len(blocks) == 1, f"{what}: {len(blocks)} ESS calls")
        args = blocks[0][0]
        x, w = args[0], (args[1] if len(args) > 1 else None)
        check(tuple(x.shape) == (det["steps"], x.shape[1], det["chains"]),
              f"{what}: block {tuple(x.shape)}")
        ess64 = geyer_ess_f64(x, w)
        check(abs(det["ess_total"] / ess64 - 1) < 1e-3,
              f"{what}: ess {det['ess_total']} against float64 {ess64}")
        engine = sampler in bench_ess.ENGINE_SAMPLERS
        body = {"nuts-engine": "nuts"}.get(sampler, sampler)
        attr = "launches" if body == "mjhmc" else f"{body}_launches"
        mm = "_mm" if cname == "product_of_t" else ""
        run_fn, stream_fn = f"cuda_mjhmc{mm}_run", f"cuda_mjhmc{mm}_stream_run"
        if engine:
            want = {(run_fn, attr): 1, (stream_fn, attr): 1 + ESS_TRIALS}
            if mm:  # the preset's JAX default precision is counted besides
                prec = cm.energy_spec_for(BENCHMARK_CONFIGS[cname].make_distribution()).precision
                want.update({(run_fn, f"{prec}_launches"): 1,
                             (stream_fn, f"{prec}_launches"): 1 + ESS_TRIALS})
                tag = f"[{cname}, {prec}]"
            else:
                tag = ""
            rhat = float(potential_scale_reduction(x, w).max())
            check(rhat < 1.05, f"{what}: split-R-hat max {rhat}")
            for kind, fn in (("run", run_fn), ("stream", stream_fn)):
                key = f"{body}{mm}_{kind}{tag}"
                launches[key] = launches.get(key, 0) + want[(fn, attr)]
        else:
            want, rhat = {}, None
        check(counts == want, f"{what}: launches {counts}, expected {want}")
        recs[(cname, sampler)] = rec
        phase("38 ess", f"{cname} {sampler}: {rec['value']:.6g} ESS/s (ESS {det['ess_total']:.6g} "
              f"of {det['raw_samples']} raw samples, float64 {ess64:.6g}; {det['chains']} "
              f"chains x {det['steps']} steps in {det['sampling_wall_s']:.6g} s, best of "
              f"{ESS_TRIALS}; split-R-hat max {rhat}; launches {counts}; {seconds:.4g} s host "
              f"clock) {json.dumps(rec)} [{card}]")
    return launches, recs


def ess_oracles(cm, cli, card):
    """Phase 38, the rest of slices B and E on the card: the autocorrelation
    experiment's engine path on the rough well (ρ(0) = 1, a non-decreasing
    evals axis whose slope over the first lags is within 1% of the stream's
    mean evals per iteration), the jump ladder against the eigensolution
    of its rate matrix (TV < 0.02, tests/test_ladder.py:56) and the
    ``diagnostics`` subcommand on a ``sample --save`` file of gauss2d
    (its ESS that of ``sample``'s record, split-R-hat < 1.05). Returns
    {kernels-line entry: launches}."""
    import tempfile

    import numpy as np

    from mjhmc_tpu_torch.experiments import calculate_autocorrelation
    from mjhmc_tpu_torch.models import RoughWell
    from mjhmc_tpu_torch.samplers import algebraic as alg

    # the autocorrelation experiment, the engine at the preset's width
    cm.reset_counts()
    t0 = time.perf_counter()
    with recording(cm.CudaMJHMC, "sample") as samples:
        res = calculate_autocorrelation(RoughWell(), "mjhmc", num_steps=AC_STEPS, nbatch=AC_CHAINS,
                                        nlags=200, burn_steps=500, seed=0, engine="cuda",
                                        device=DEV, epsilon=EPS, beta=BETA, num_leapfrog_steps=M)
    seconds = time.perf_counter() - t0
    counts = wrapper_counts(cm)
    want = {("cuda_mjhmc_run", "launches"): 1, ("cuda_mjhmc_stream_run", "launches"): 1}
    check(counts == want, f"autocorrelation experiment: launches {counts}, expected {want}")
    check(len(samples) == 1, f"autocorrelation experiment: {len(samples)} streams")
    (eng, *_), (_, _, es) = samples[0]
    rate = float(eng.last_out.evals.double().mean()) / AC_STEPS
    check(res.name == "mjhmc[cuda]" and res.rho[0] == 1.0, f"rho(0) {res.rho[0]}, {res.name}")
    check(bool(np.all(np.diff(res.grad_evals) >= 0)), "the evals axis decreases")
    slope = float(np.polyfit(np.arange(20), res.grad_evals[:20], 1)[0])
    check(abs(slope / rate - 1) < 0.01, f"evals axis slope {slope} against the stream's "
          f"{rate} evals an iteration")
    check(es.shape == (AC_STEPS, AC_CHAINS), f"evals counters {tuple(es.shape)}")
    phase("38 ess", f"calculate_autocorrelation(engine='cuda') rough_well ({AC_CHAINS} chains, "
          f"500 + {AC_STEPS} iterations, 200 lags): decay {res.decay_evals:.6g} evals (censored "
          f"{res.censored}), axis slope {slope:.6g} against {rate:.6g} evals an iteration "
          f"({slope / rate - 1:+.2e}), rho[:5] {[round(float(r), 5) for r in res.rho[:5]]}; "
          f"launches {counts}; {seconds:.4g} s host clock [{card}]")
    launches = {"mjhmc_run": 1, "mjhmc_stream": 1}

    # the ladder oracle: the jump chain on the card against the eigensolution
    t0 = time.perf_counter()
    e = alg.random_ladder_energies(torch.Generator().manual_seed(1), 6)
    from mjhmc_tpu_torch.diagnostics import stationary_distribution

    pi = stationary_distribution(alg.continuous_rate_matrix(e, 0.5), continuous=True)
    check(float(np.abs(pi - alg.ladder_stationary(e)).max()) < 1e-10, "ladder eigensolution")
    sim = alg.simulate_jump_ladder(e, 0.5, torch.Generator(device=DEV).manual_seed(42), 4000,
                                   512, device=DEV)
    check(sim.occupation.device.type == "cuda", "the ladder ran off the card")
    tv = 0.5 * float(np.abs(sim.occupation.cpu().numpy() - pi).sum())
    check(tv < 0.02, f"jump ladder TV distance {tv}")
    phase("38 ess", f"simulate_jump_ladder (K 6, beta 0.5, 4,000 steps x 512 chains) on the card: "
          f"TV {tv:.4g} from the eigensolution of continuous_rate_matrix (< 0.02); "
          f"{time.perf_counter() - t0:.4g} s host clock")

    # the diagnostics subcommand on a `sample --save` file
    cm.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "gauss2d.npz")
        rec_s, _, _ = run_cli(cli, ["sample", "--config", "gauss2d", "--engine", "cuda",
                                    "--burn", "200", "--steps", "1000", "--save", path], {})
        counts = wrapper_counts(cm)
        rec_d, _, seconds = run_cli(cli, ["diagnostics", "--file", path], {})
    check(counts == want, f"sample --save: launches {counts}, expected {want}")
    check(rec_d["shape"] == [1000, 2, 100] and rec_d["rho_first_lags"][0] == 1.0
          and rec_d["rhat_max"] < 1.05 and 0 < rec_d["ess"] <= 1000 * 100
          and 0 < rec_d["spectral_gap"] <= 1
          and abs(rec_d["ess"] / rec_s["ess"] - 1) < 1e-6,
          f"diagnostics record {rec_d} (sample's ess {rec_s['ess']})")
    launches = {k: v + 1 for k, v in launches.items()}
    phase("38 ess", f"diagnostics --file (sample --save, gauss2d, 100 chains, 1,000 steps): "
          f"{json.dumps(rec_d)}; {seconds:.4g} s host clock [{card}]")
    return launches


# ---- phase 39: slices D and F: the other samplers and the heads -------------
#: the PT stuck-start run (tests/test_tempering.py:98-123 at full width):
#: the mog preset's mixture, 1,024 chains, T 6, beta_min 0.02, eps 0.4, M 5;
#: 1,500 iterations after the burn (~0.03 round trips a replica an
#: iteration, so ~45 a replica in the window)
PT_CHAINS, PT_TEMPS, PT_BETA_MIN, PT_EPS, PT_M, PT_BURN, PT_STEPS = 1024, 6, 0.02, 0.4, 5, 500, 1500
#: gauss50d's rows (reduced flip, MJHMC's partial refresh): burn, steps;
#: the chains start in the target (Gaussian.init_x), so a short run holds
#: the variances
G50_BURN, G50_STEPS = 100, 300
#: control HMC's burn and steps beside the rough well's reduced flip
CTL_BURN, CTL_STEPS = 200, 500
#: the autocorrelation experiment's burn and steps with reduced flip and PT
AC39_BURN, AC39_STEPS = 100, 500


def _on_card(*tensors):
    check(all(t.device.type == "cuda" for t in tensors),
          f"a result left the card: {[str(t.device) for t in tensors]}")


def _row(msg, seconds, card, rows, key, name="39 samplers and heads"):
    rows[key] = seconds
    phase(name, f"{key}: {msg}; {seconds:.4g} s host clock [{card}]")


def _var_within(var, tgt, rtol, what):
    r = (var / tgt).tolist()
    check(all(abs(x - 1) < rtol for x in r), f"{what}: var/analytic outside 1 +- {rtol}: "
          f"{[round(x, 4) for x in r]}")
    return max(abs(x - 1) for x in r)


def tempering_rows(cli, card, rows):
    """PT from the stuck start, and ``sample --sampler pt --adapt-ladder``."""
    import numpy as np

    from mjhmc_tpu_torch.bench_ess import timed
    from mjhmc_tpu_torch.models import GaussianMixture
    from mjhmc_tpu_torch.samplers import ParallelTempering

    dist = GaussianMixture()  # the mog preset: modes +-4, sigma 0.8
    var = float(dist.analytic_var()[0])

    def stuck_run():
        pt = ParallelTempering(dist, epsilon=PT_EPS, num_leapfrog_steps=PT_M, nbatch=PT_CHAINS,
                               num_temps=PT_TEMPS, beta_min=PT_BETA_MIN, seed=0, device=DEV)
        x0 = torch.full_like(pt.state.x, -4.0)
        u0, g0 = dist.potential_and_grad(x0)
        pt.state = pt.state._replace(x=x0, u=u0, grad=g0)
        pt.burn_in(PT_BURN)
        return pt, pt.sample(PT_STEPS)

    seconds, (pt, out) = timed(stuck_run, 1, DEV)
    _on_card(out["x"], pt.state.x)
    xs = out["x"].cpu().numpy()
    right, mean, rel = float((xs > 0).mean()), float(xs.mean()), abs(float(xs.var()) - var) / var
    check(0.4 < right < 0.6, f"PT: share of x > 0 {right}")
    check(abs(mean) < 0.45 and rel < 0.12, f"PT: mean {mean}, var {xs.var()} against {var}")
    check((pt.swap_rates > 0.2).all() and (pt.accept_rates > 0.5).all(),
          f"PT: swap rates {pt.swap_rates}, accept rates {pt.accept_rates}")
    check(pt.round_trip_rate > 0, f"PT: round-trip rate {pt.round_trip_rate}")
    want = PT_TEMPS * PT_M * PT_STEPS * PT_CHAINS
    check(pt.grad_evals == want, f"PT: grad_evals {pt.grad_evals}, expected T*M*steps*n {want}")
    _row(f"ParallelTempering, every replica stuck at x = -4 (mog, {PT_CHAINS} chains, T "
         f"{PT_TEMPS}, beta_min {PT_BETA_MIN}, eps {PT_EPS}, M {PT_M}, {PT_BURN} + {PT_STEPS}): "
         f"x > 0 on {right:.4f}, mean {mean:.4f}, var {float(xs.var()):.5g} ({rel:+.3%} of "
         f"{var:.4g}), swap rates {np.round(pt.swap_rates, 4).tolist()}, accept rates "
         f"{np.round(pt.accept_rates, 4).tolist()}, round trips {pt.round_trip_rate:.5g} a "
         f"replica an iteration, grad_evals {pt.grad_evals} = T*M*steps*n",
         seconds, card, rows, "pt stuck start")

    rec, _, seconds = run_cli(cli, ["sample", "--config", "mog", "--sampler", "pt",
                                    "--engine", "torch", "--adapt-ladder"], {})
    rel = abs(rec["var"][0] - var) / var
    check(rec["betas"][-1] == 1.0 and len(rec["swap_rates"]) == 5 and rel < 0.15
          and rec["grad_evals"] == 6 * 5 * 1000 * rec["chains"] and rec["round_trip_rate"] > 0,
          f"sample --sampler pt --adapt-ladder: {rec}")
    _row(f"sample --config mog --sampler pt --engine torch --adapt-ladder: {json.dumps(rec)}",
         seconds, card, rows, "pt cli")


def reduced_flip_rows(cli, card, rows):
    """``sample --sampler reduced_flip`` on the rough well beside control
    HMC's rejections, reduced flip on gauss50d, and MJHMC's partial
    refresh on gauss50d."""
    from mjhmc_tpu_torch.bench_ess import timed
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.samplers import ControlHMC, MarkovJumpHMC, ReducedFlipHMC

    cfg = BENCHMARK_CONFIGS["rough_well"]
    with recording(ReducedFlipHMC, "sample") as calls:
        rec, _, seconds = run_cli(cli, ["sample", "--config", "rough_well", "--sampler",
                                        "reduced_flip", "--engine", "torch"], {})
    (s, _), out = calls[0]
    _on_card(out["sel"])
    n, m = rec["chains"], cfg.num_leapfrog_steps
    check(n == cfg.nbatch and rec["grad_evals"] == 2 * m * 1000 * n,
          f"reduced flip: grad_evals {rec['grad_evals']}, expected 2M*steps*n {2 * m * 1000 * n}")
    flip = float((out["sel"] == 1).float().mean())

    def control():
        c = ControlHMC(cfg.make_distribution(), epsilon=cfg.epsilon, beta=cfg.beta,
                       num_leapfrog_steps=m, nbatch=n, seed=0, device=DEV)
        c.burn_in(CTL_BURN)
        return 1.0 - float(c.sample(CTL_STEPS)["accept"].float().mean())

    c_seconds, reject = timed(control, 1, DEV)
    check(flip < reject, f"reduced flip's flip share {flip} not below control's rejections "
          f"{reject}")
    _row(f"sample --config rough_well --sampler reduced_flip --engine torch: {json.dumps(rec)}; "
         f"flip share {flip:.5f} < control HMC's rejection share {reject:.5f} (ControlHMC, the "
         f"same eps, beta, M and chains, {CTL_BURN} + {CTL_STEPS}: {c_seconds:.4g} s)",
         seconds + c_seconds, card, rows, "reduced flip cli")

    g50 = BENCHMARK_CONFIGS["gauss50d"]
    dist = g50.make_distribution()
    tgt = dist.analytic_var().to(DEV)
    kw = dict(epsilon=g50.epsilon, beta=g50.beta, num_leapfrog_steps=g50.num_leapfrog_steps,
              nbatch=g50.nbatch, seed=1, device=DEV)

    def rf50():
        s = ReducedFlipHMC(dist, **kw)
        s.burn_in(G50_BURN)
        return s, s.sample(G50_STEPS)

    seconds, (s, out) = timed(rf50, 1, DEV)
    err = _var_within(out["x"].var(dim=(0, 2)), tgt, 0.10, "reduced flip gauss50d")
    want = 2 * g50.num_leapfrog_steps * G50_STEPS * g50.nbatch
    check(s.grad_evals == want, f"reduced flip gauss50d: grad_evals {s.grad_evals} != {want}")
    _row(f"ReducedFlipHMC gauss50d ({g50.nbatch} chains, eps {g50.epsilon}, beta {g50.beta}, M "
         f"{g50.num_leapfrog_steps}, {G50_BURN} + {G50_STEPS}): variances within {err:.4f} of the "
         f"analytic ones (< 0.10), grad_evals {s.grad_evals} = 2M*steps*n",
         seconds, card, rows, "reduced flip gauss50d")

    def partial():
        s = MarkovJumpHMC(dist, refresh_fraction=0.5, **kw)
        s.burn_in(G50_BURN)
        valid0 = s.state.back_valid.clone()
        return s, valid0, s.sample(G50_STEPS)

    seconds, (s, valid0, out) = timed(partial, 1, DEV)
    w = out["dwell"][:, None, :]
    mean = (w * out["x"]).sum(dim=(0, 2)) / w.sum()
    var = (w * out["x"] ** 2).sum(dim=(0, 2)) / w.sum() - mean * mean
    err = _var_within(var, tgt, 0.10, "MJHMC refresh_fraction 0.5 gauss50d")
    # cost model: M an iteration, M more wherever the backward cache was
    # invalid (the first iteration after a refresh, or the start)
    m = g50.num_leapfrog_steps
    invalid = (~valid0).int() + (out["sel"][:-1] == 2).int().sum(dim=0)
    want = m * G50_STEPS + m * invalid
    check(torch.equal(s.state.grad_evals, want.to(torch.int32)),
          "MJHMC refresh_fraction 0.5: counters off the cost model")
    refreshes = int((out["sel"] == 2).sum())
    _row(f"MarkovJumpHMC(refresh_fraction=0.5) gauss50d ({g50.nbatch} chains, the preset's eps, "
         f"beta, M; {G50_BURN} + {G50_STEPS}): dwell-weighted variances within {err:.4f} (< 0.10); "
         f"counters exact per chain (M*steps + M per invalid cache, {refreshes} refreshes)",
         seconds, card, rows, "mjhmc partial refresh")


def chees_row(card, rows):
    """``chees_hmc_run`` (tests/test_chees.py:51-69 at 4,096 chains)."""
    from mjhmc_tpu_torch.bench_ess import timed
    from mjhmc_tpu_torch.models import Gaussian
    from mjhmc_tpu_torch.samplers import chees_hmc_run, make_hmc_state

    dist = Gaussian(ndims=8, log_conditioning=2.0)

    def run():
        state = make_hmc_state(dist, torch.Generator().manual_seed(4), 4096, DEV)
        return chees_hmc_run(dist, state, torch.Generator().manual_seed(5), 600,
                             max_leapfrog_steps=64, tau0=0.1, eps0=0.3)

    seconds, (state, cs, da, trace) = timed(run, 1, DEV)
    _on_card(state.chain.x, cs.log_tau)
    tau = float(trace["tau"][-50:].mean())
    acc = float(trace["accept"][-100:].mean())
    ratio = state.chain.x.var(dim=1).cpu() / dist.analytic_var()
    check(tau > 1.0 and 0.4 < acc < 0.95 and bool(((ratio > 0.2) & (ratio < 5)).all()),
          f"ChEES: tau {tau}, acceptance {acc}, var/target {ratio.tolist()}")
    _row(f"chees_hmc_run Gaussian(8, 2.0) (4,096 chains, 600 iterations, max 64 steps, tau0 0.1, "
         f"eps0 0.3): tau {tau:.4g} (> 1), acceptance {acc:.4f} (in (0.4, 0.95)), eps "
         f"{float(trace['eps'][-1]):.4g}, var/target in [{float(ratio.min()):.3f}, "
         f"{float(ratio.max()):.3f}] (in (0.2, 5)), {int(state.grad_evals.sum())} gradient "
         f"evaluations", seconds, card, rows, "chees")


def smc_rows(cli, card, rows):
    """``smc_run`` on the Gaussian oracle with both mutations, bit for bit
    under a world-size-1 mesh, and ``smc --config product_of_t``."""
    import numpy as np

    import torch.distributed as dist_

    from mjhmc_tpu_torch.bench_ess import timed
    from mjhmc_tpu_torch.inference import smc_run
    from mjhmc_tpu_torch.models import Gaussian
    from mjhmc_tpu_torch.parallel.mesh import make_chain_mesh
    from mjhmc_tpu_torch.parallel.multihost import free_port, initialize

    target = Gaussian(ndims=4, log_conditioning=1.0)
    var = target.analytic_var().numpy().astype(np.float64)
    log_z_exact = 0.5 * np.sum(np.log(var)) - 0.5 * len(var) * np.log(3.0**2)
    cases = {"hmc": dict(num_leapfrog_steps=5, bound=0.15),
             "chees": dict(num_leapfrog_steps=24, init_tau=0.3, bound=0.2)}

    def run(mutation, mesh=None, stages=16):
        kw = {k: v for k, v in cases[mutation].items() if k != "bound"}
        return smc_run(target, torch.Generator(device=DEV).manual_seed(2), 4096,
                       num_stages=stages, prior_scale=3.0, num_mutation_steps=5,
                       mutation=mutation, mesh=mesh, device=DEV, **kw)

    direct = {}
    for mutation, case in cases.items():
        seconds, (state, trace) = timed(lambda: run(mutation), 1, DEV)
        _on_card(state.x, state.log_z)
        direct[mutation] = (state, trace)
        err = abs(float(state.log_z) - log_z_exact)
        rel = np.abs(state.x.var(dim=1).cpu().numpy() / var - 1).max()
        moved = mutation == "hmc" or abs(float(torch.exp(state.log_tau)) - 0.3) > 1e-3
        check(float(state.lam) == 1.0 and err < case["bound"] and rel < 0.15 and moved,
              f"smc_run {mutation}: lam {float(state.lam)}, |logZ error| {err}, var rel {rel}, "
              f"tau {float(torch.exp(state.log_tau))}")
        _row(f"smc_run Gaussian(4, 1.0) mutation {mutation} (4,096 particles, 16 stages, 5 "
             f"mutations of {case['num_leapfrog_steps']} steps): log Z {float(state.log_z):.5f} "
             f"against {log_z_exact:.5f} (|error| {err:.4f} < {case['bound']}), lambda 1, "
             f"variances within {rel:.4f} (< 0.15), tau {float(torch.exp(state.log_tau)):.4g}, "
             f"accept {np.round(trace['accept'].cpu().numpy(), 3).tolist()}",
             seconds, card, rows, f"smc {mutation}")

    # a stage reads nothing back to the host: a synchronising call raises
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for mutation in cases:
            run(mutation, stages=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _row("smc_run, both mutations, 2 stages under torch.cuda.set_sync_debug_mode('error'): no "
         "synchronising call inside a stage", time.perf_counter() - t0, card, rows, "smc no sync")

    initialize(f"127.0.0.1:{free_port()}", 1, 0, device=DEV)
    try:
        mesh = make_chain_mesh(device=DEV)
        t0 = time.perf_counter()
        for mutation in cases:
            state, trace = run(mutation, mesh)
            d_state, d_trace = direct[mutation]
            check(all(torch.equal(a, b) for a, b in zip(state, d_state))
                  and all(torch.equal(trace[k], d_trace[k]) for k in trace),
                  f"smc_run {mutation} under a world-size-1 mesh differs from the direct call")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        dist_.destroy_process_group()
    _row("smc_run under a world-size-1 chain mesh (NCCL; the ring resample, gathered weights): "
         "both mutations equal the direct call bit for bit", seconds, card, rows, "smc mesh")

    rec, _, seconds = run_cli(cli, ["smc", "--config", "product_of_t"], {})
    check(rec["final_lambda"] == 1.0 and rec["particles"] == 4096
          and np.isfinite(rec["log_evidence"]) and all(np.isfinite(rec["var"])),
          f"smc --config product_of_t: {rec}")
    _row(f"smc --config product_of_t: {json.dumps(rec)}", seconds, card, rows, "smc cli")


def vi_rows(cli, card, rows):
    """``vi --config gauss50d``, full-rank ADVI on the correlated Gaussian
    of tests/test_inference.py:88, and ``vi --config sparse_coding --rank
    16``."""
    import numpy as np

    from mjhmc_tpu_torch.bench_ess import timed
    from mjhmc_tpu_torch.inference import ADVI, q_covariance
    from mjhmc_tpu_torch.models.base import Distribution

    if "torch._dynamo" not in sys.modules:  # torch.optim's first use imports it
        t0 = time.perf_counter()
        importlib.import_module("torch._dynamo")
        _row("import torch._dynamo (torch.optim.Adam's first use pulls it in; once a process)",
             time.perf_counter() - t0, card, rows, "vi torch._dynamo import")

    with recording(ADVI, "fit") as calls:
        rec, _, seconds = run_cli(cli, ["vi", "--config", "gauss50d"], {})
    (head,), (params, elbos) = calls[0]
    _on_card(params.mu, elbos)
    sd = np.sqrt(head.distribution.analytic_var().numpy())
    mu, sigma = params.mu.cpu().numpy(), np.exp(params.omega.cpu().numpy())
    e = elbos.cpu().numpy()
    check(bool((np.abs(mu) < 0.15 * sd + 0.05).all()), f"vi gauss50d: mu {mu} against sd {sd}")
    err = float(np.abs(sigma / sd - 1).max())
    check(err < 0.15 and e[-100:].mean() > e[:100].mean(),
          f"vi gauss50d: sigma/sd - 1 up to {err}, ELBO {e[:100].mean()} -> {e[-100:].mean()}")
    _row(f"vi --config gauss50d: {json.dumps(rec)}; all 50 |mu| < 0.15 sd + 0.05, sigma within "
         f"{err:.4f} of sd (< 0.15), mean ELBO {e[:100].mean():.4f} (first 100) -> "
         f"{e[-100:].mean():.4f} (last 100)", seconds, card, rows, "vi gauss50d")

    cov = np.array([[1.0, 0.8, 0.3], [0.8, 1.5, 0.5], [0.3, 0.5, 0.7]], np.float32)
    prec = torch.as_tensor(np.linalg.inv(cov).astype(np.float32), device=DEV)

    @dataclasses.dataclass(frozen=True)
    class CorrGauss(Distribution):
        ndims: int = 3

        def potential(self, x):
            return self.potential_and_grad(x)[0]

        def potential_and_grad(self, x):
            px = torch.einsum("ij,...jn->...in", prec, x)
            return 0.5 * (x * px).sum(dim=-2), px

    def fit():
        return ADVI(CorrGauss(), num_steps=3000, n_mc=128, learning_rate=0.03, rank=3, seed=0,
                    device=DEV).fit()

    seconds, (params, elbos) = timed(fit, 1, DEV)
    fitted = q_covariance(params).cpu().numpy()
    late, early = float(elbos[-200:].mean()), float(elbos[:200].mean())
    opt = 0.5 * np.linalg.slogdet(2 * np.pi * cov)[1]
    cerr = float(np.abs(fitted - cov).max())
    check(cerr < 0.15 and late > early and abs(late - opt) < 0.1,
          f"full-rank ADVI: cov error {cerr}, ELBO {early} -> {late} (optimum {opt})")
    _row(f"full-rank ADVI, 3-D correlated Gaussian (3,000 steps, n_mc 128, lr 0.03): covariance "
         f"within {cerr:.4f} (< 0.15), ELBO {early:.5f} -> {late:.5f} against the optimum "
         f"{opt:.5f} (within 0.1)", seconds, card, rows, "vi full rank")

    rec, _, seconds = run_cli(cli, ["vi", "--config", "sparse_coding", "--rank", "16"], {})
    check(np.isfinite(rec["final_elbo"]) and all(v > 0 for v in rec["cov_diag"])
          and len(rec["mu"]) == 8, f"vi --config sparse_coding --rank 16: {rec}")
    _row(f"vi --config sparse_coding --rank 16: {json.dumps(rec)}", seconds, card, rows,
         "vi sparse coding")


def autocorr_rows(card, rows):
    """``calculate_autocorrelation`` with reduced flip and PT on the card:
    their evals axes are exact (2M and T*M an iteration)."""
    import numpy as np

    from mjhmc_tpu_torch.bench_ess import timed
    from mjhmc_tpu_torch.experiments import calculate_autocorrelation
    from mjhmc_tpu_torch.models import GaussianMixture, RoughWell

    for sampler, dist, n, kw, per in (
            ("reduced_flip", RoughWell(), 10_000, dict(epsilon=EPS, beta=BETA,
                                                       num_leapfrog_steps=M), 2 * M),
            ("pt", GaussianMixture(), PT_CHAINS,
             dict(epsilon=PT_EPS, num_leapfrog_steps=PT_M, num_temps=PT_TEMPS,
                  beta_min=PT_BETA_MIN), PT_TEMPS * PT_M)):
        seconds, res = timed(lambda: calculate_autocorrelation(
            dist, sampler, num_steps=AC39_STEPS, nbatch=n, nlags=100, burn_steps=AC39_BURN,
            use_cached_init=False, device=DEV, **kw), 1, DEV)
        steps = np.diff(res.grad_evals)
        check(bool(np.all(steps == per)) and res.total_grad_evals == AC39_STEPS * n * per
              and res.rho[0] == 1.0 and np.isfinite(res.rho).all(),
              f"calculate_autocorrelation {sampler}: evals axis steps {np.unique(steps)}, "
              f"total {res.total_grad_evals}, rho[0] {res.rho[0]}")
        _row(f"calculate_autocorrelation(sampler={sampler!r}) {type(dist).__name__} ({n} chains, "
             f"{AC39_BURN} + {AC39_STEPS} iterations, 100 lags): the evals axis {per} an "
             f"iteration exactly ({'2M' if sampler == 'reduced_flip' else 'T*M'}), decay {res.decay_evals:.6g} "
             f"evals (censored {res.censored}), rho[:4] {np.round(res.rho[:4], 4).tolist()}",
             seconds, card, rows, f"autocorr {sampler}")


def heads_bench_row(card, name, rows):
    """``bench_heads.main(["--repeats", "1"])``: its eight rows on the card
    with its name (four SMC sweep points, config 5's anneal, three VI fits)
    and the sharded-path receipt, 8 gloo processes on the host's CPU, which
    phase 41 holds. Returns that receipt."""
    import numpy as np

    from mjhmc_tpu_torch import bench_heads

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench_heads.main(["--repeats", "1"])
    seconds = time.perf_counter() - t0
    recs = [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]
    sharded = recs.pop() if recs else None
    check(rc == 0 and len(recs) == 8 and all(r["device_name"] == name and r["wall_s"] > 0
                                             for r in recs),
          f"bench_heads: rc {rc}, {recs}")
    sweep, anneal, vis = recs[:4], recs[4], recs[5:]
    check(all(np.isfinite(r["logz_abs_err_nats"]) for r in sweep)
          and np.isfinite(anneal["log_z"]) and all(np.isfinite(r["elbo_final"]) for r in vis),
          f"bench_heads: non-finite rows {recs}")
    for r in recs:
        phase("39 samplers and heads", f"bench_heads row {json.dumps(r)}")
    _row(f"bench_heads.main(['--repeats', '1']): 8 rows; SMC gauss50d |logZ error| "
         f"{[round(r['logz_abs_err_nats'], 4) for r in sweep]} at stages "
         f"{[r['num_stages'] for r in sweep]}, stages/s "
         f"{[round(r['stages_per_s'], 2) for r in sweep]}; config 5 anneal "
         f"{anneal['stages_per_s']:.4g} stages/s (lambda 1: {anneal['reached_lambda1']}); VI "
         f"steps/s {[round(r['steps_per_s'], 1) for r in vis]}, gauss50d KL gap "
         f"{vis[0]['kl_gap_nats']:.4g} nats; the sharded receipt (phase 41)", seconds, card,
         rows, "bench_heads")
    return sharded


def samplers_and_heads(cm, cli, card, name):
    """Phase 39, slices D and F on the card at full width: parallel
    tempering, reduced flip, MJHMC's partial refresh, ChEES, SMC (both
    mutations; a world-size-1 mesh), ADVI, their CLI subcommands, the
    autocorrelation experiment and ``bench_heads``. Plain PyTorch on the
    card: every count stays 0 and every result is a CUDA tensor. Returns
    ({row: host seconds}, ``bench_heads``' sharded-path receipt)."""
    cm.reset_counts()
    rows = {}
    tempering_rows(cli, card, rows)
    reduced_flip_rows(cli, card, rows)
    chees_row(card, rows)
    smc_rows(cli, card, rows)
    vi_rows(cli, card, rows)
    autocorr_rows(card, rows)
    sharded = heads_bench_row(card, name, rows)
    counts = wrapper_counts(cm)
    check(not counts, f"phase 39 launched fused-engine kernels: {counts}")
    return rows, sharded


# ---- phase 40: slice H: the searches, the figures, the claim, bench --profile --
#: `search`'s calls (gauss2d): --steps, --nbatch, --iters of the bayes call
SEARCH_STEPS, SEARCH_CHAINS, SEARCH_ITERS = 200, 64, 4
#: one grid point of the efficiency battery (gauss50d at its 128 chains),
#: timed at these M over this many iterations (the battery runs 1,200)
POINT_MS, POINT_STEPS = (5, 50), 200


def _row40(msg, seconds, card, rows, key):
    _row(msg, seconds, card, rows, key, "40 search and figures")


def _cli_out(cli, argv):
    """(stdout, seconds) of an in-process CLI call that ends synchronised."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli(argv)
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def search_rows(cli, card, rows):
    """``search`` with both methods on gauss2d; the GP proposals timed
    one by one. Returns the proposals' seconds."""
    import numpy as np

    from mjhmc_tpu_torch.search import bayes

    propose, times = bayes._propose, []

    def timed_propose(*a):
        t0 = time.perf_counter()
        out = propose(*a)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    bayes._propose = timed_propose
    try:
        for method, extra, n_rows in (("grid", [], 9),
                                      ("bayes", ["--iters", str(SEARCH_ITERS)], 6 + SEARCH_ITERS)):
            out, seconds = _cli_out(cli, ["search", "--config", "gauss2d", "--method", method,
                                          "--steps", str(SEARCH_STEPS), "--nbatch",
                                          str(SEARCH_CHAINS)] + extra)
            rec = json.loads(out.strip().splitlines()[-1])
            best, table = rec["best"], rec["table"]
            if method == "grid":
                inside = (best["epsilon"] in (0.1, 0.3, 1.0) and best["beta"] in (0.05, 0.2, 0.5)
                          and best["num_leapfrog_steps"] == 5)
            else:
                inside = (0.01 <= best["epsilon"] <= 10.0 and 0.02 <= best["beta"] <= 0.9
                          and best["num_leapfrog_steps"] in (5, 10, 20))
            check(len(table) == n_rows and best in table and inside
                  and np.isfinite(best["decay_evals"]) and not best["censored"],
                  f"search --method {method}: {len(table)} rows (want {n_rows}), best {best}")
            gp = f", {len(times)} GP proposals {sum(times):.4g} s" if method == "bayes" else ""
            _row40(f"--config gauss2d --method {method} --steps {SEARCH_STEPS} --nbatch "
                   f"{SEARCH_CHAINS}{' '.join([''] + extra)}: {n_rows} rows, best "
                   f"{json.dumps(best)}; {1e3 * seconds / n_rows:.5g} ms host a grid point{gp}",
                   seconds, card, rows, f"search {method}")
    finally:
        bayes._propose = propose
    check(len(times) == SEARCH_ITERS, f"GP proposals {len(times)}, want {SEARCH_ITERS}")
    phase("40 search and figures", f"GP proposal (150 Adam steps, EI over 2,048 candidates) s: "
          f"{[round(t, 5) for t in times]} [{card}]")
    return times


def battery_iterations():
    """{M: plain sampler iterations} of the efficiency battery's grid
    sweeps (``DEFAULT_TARGETS``, both samplers, the tuned_decay defaults
    where a target sets none); the confirmation runs are not counted."""
    import inspect

    from mjhmc_tpu_torch.experiments import efficiency_claim as ec

    defaults = {k: p.default for k, p in inspect.signature(ec.tuned_decay).parameters.items()
                if p.default is not inspect.Parameter.empty}
    its = {}
    for _, _, kw in ec.DEFAULT_TARGETS:
        c = {**defaults, **kw}
        for m in c["m_grid"]:
            its[m] = its.get(m, 0) + 2 * c["n_eps"] * c["n_beta"] * c["search_steps"]
    return its


def grid_point_rows(card, rows):
    """One grid point on gauss50d at 128 chains, at M 5 and 50; projects
    the battery's sweeps on the eager path from their per-iteration ms
    (linear in M). Returns {M: ms an iteration}."""
    from mjhmc_tpu_torch.models import Gaussian
    from mjhmc_tpu_torch.search import grid_search

    ms = {}
    for m in POINT_MS:
        t0 = time.perf_counter()
        res = grid_search(Gaussian(ndims=50, log_conditioning=4.0), "mjhmc", eps_grid=(0.1,),
                          beta_grid=(0.1,), m_grid=(m,), num_steps=POINT_STEPS, nbatch=128,
                          nlags=60, device=DEV)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ms[m] = 1e3 * seconds / POINT_STEPS
        check(len(res.table) == 1, f"grid point at M {m}: {res.table}")
        _row40(f"grid_search gauss50d mjhmc (128 chains, eps 0.1, beta 0.1, M {m}, "
               f"{POINT_STEPS} iterations): {ms[m]:.5g} ms an iteration, decay "
               f"{res.table[0]['decay_evals']:.6g} evals", seconds, card, rows, f"grid point M {m}")
    (m0, m1) = POINT_MS
    slope = (ms[m1] - ms[m0]) / (m1 - m0)
    its = battery_iterations()
    hours = sum(n * (ms[m0] + slope * (m - m0)) for m, n in its.items()) / 3.6e6
    phase("40 search and figures", f"efficiency battery (DEFAULT_TARGETS, both samplers): "
          f"{sum(its.values()):,} sweep iterations by M {json.dumps(its)}; projected "
          f"{hours:.4g} h on the eager path at gauss50d's ms an iteration for every target "
          f"(linear in M), confirmations not counted; python -m mjhmc_tpu_torch.bench_battery "
          f"times each target [{card}]")
    rows["battery hours (projected)"] = hours
    return ms


def figures_rows(cli, card, rows, tmp):
    """``figures --quick --out tmp``: every .npz held to its checks; the
    .png files rendered only where matplotlib imports."""
    import importlib.util

    import numpy as np

    from mjhmc_tpu_torch.experiments import figures
    from mjhmc_tpu_torch.samplers import algebraic as alg

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    out = Path(tmp) / "figures"
    t0 = time.perf_counter()
    try:
        _cli_out(cli, ["figures", "--quick", "--out", str(out)])
        rendered = "rendered"
    except RuntimeError as e:
        check(not has_mpl and "matplotlib" in str(e), f"figures --quick: {e}")
        rendered = f"not rendered: {e}"
    seconds = time.perf_counter() - t0
    pngs = sorted(p.name for p in out.glob("*.png"))
    check(len(pngs) == (4 if has_mpl else 0), f"figures: .png files {pngs}")
    z = {p.stem: np.load(p) for p in out.glob("*.npz")}
    check(sorted(z) == ["autocorr_overlay", "spectral_gap", "tempering", "trajectory_fan"],
          f"figures: .npz files {sorted(z)}")
    # the gaps recomputed from the figure's own energies (draws d at beta
    # 0.3 by K, draws 100 + d at K 16 by beta), eigenvalues on the host
    def gap_c(a):  # second-smallest |Re lambda| of a generator
        return np.sort(np.abs(np.real(np.linalg.eigvals(a))))[1]

    def gap_d(t):  # 1 - |lambda_2| of a transition matrix
        return 1.0 - np.sort(np.abs(np.linalg.eigvals(t)))[::-1][1]

    s = z["spectral_gap"]
    for axis, values, draw in (("k", s["ks"], lambda d, v: (figures.ladder_energies(d, int(v)),
                                                              0.3)),
                               ("b", s["betas"], lambda d, v: (figures.ladder_energies(100 + d, 16),
                                                               float(v)))):
        for i, v in enumerate(values):
            eb = [draw(d, v) for d in range(3)]
            for key, gap in (("cont", lambda e, b: gap_c(alg.continuous_rate_matrix(e, b))),
                             ("rf", lambda e, b: gap_d(alg.reduced_flip_transition_matrix(e, b))),
                             ("disc", lambda e, b: gap_d(alg.discrete_transition_matrix(e, b)))):
                got, want = s[f"{key}_{axis}"][i], np.mean([gap(e, b) for e, b in eb])
                check(abs(got - want) <= 1e-6 * abs(want), f"spectral_gap {key}_{axis}[{i}] "
                      f"{got} against the eigensolution {want}")
    t = z["tempering"]
    right_pt, right_hmc = float(np.mean(t["pt"] > 0)), float(np.mean(t["hmc"] > 0))
    area = float(np.trapezoid(t["exact"], t["grid"]))
    check(0.3 <= right_pt <= 0.7 and right_hmc < 0.05 and abs(area - 1) < 1e-6,
          f"tempering: PT x > 0 on {right_pt}, HMC on {right_hmc}, density integrates to {area}")
    a = z["autocorr_overlay"]
    rhos = [k for k in a.files if k.endswith("_rho")]
    check(len(rhos) == 12 and all(
        abs(a[k][0] - 1) <= 0.02 and np.isfinite(a[k]).all()
        and np.all(np.diff(a[k.replace("_rho", "_evals")]) > 0) for k in rhos)
        and all(np.isfinite(a[k]).all() for k in a.files),
        f"autocorr_overlay: rho[0] {[float(a[k][0]) for k in rhos]}")
    f = z["trajectory_fan"]
    check(all(f[k].std() > 10 for k in f.files), f"trajectory_fan: std "
          f"{[float(f[k].std()) for k in f.files]}")
    _row40(f"4 .npz held (spectral gaps = the eigensolutions within 1e-6; PT "
           f"x > 0 on {right_pt:.4f}, HMC on {right_hmc:.4f}, density area {area:.7f}; 12 "
           f"overlay curves rho(0) 1, evals increasing; fan std "
           f"{[round(float(f[k].std()), 2) for k in f.files]}); .png {rendered}", seconds, card,
           rows, "figures --quick")


def efficiency_row(cli, card, rows, tmp):
    """``efficiency --quick``: two rows, a finite positive ratio, and each
    row's confirmations run as the protocol sets them (``seed + 7``; lags
    ``nlags * max(1, 10 / M)``, steps at least twice that)."""
    from mjhmc_tpu_torch.experiments import efficiency_claim as ec

    kw = dict(ec.QUICK_TARGETS[0][2])
    out = str(Path(tmp) / "efficiency_claim")
    confirms, run = [], ec.calculate_autocorrelation

    def recorded(dist, **k):
        confirms.append(k)
        return run(dist, **k)

    ec.calculate_autocorrelation = recorded
    t0 = time.perf_counter()
    try:
        _cli_out(cli, ["efficiency", "--quick", "--out", out])
        rendered = "rendered"
    except RuntimeError as e:
        check("matplotlib" in str(e), f"efficiency --quick: {e}")
        rendered = f"not rendered: {e}"
    finally:
        ec.calculate_autocorrelation = run
    seconds = time.perf_counter() - t0
    with open(out + ".json") as fh:
        rec = json.load(fh)
    ratio = rec["ratios"]["rough_well[a=2]"]
    check(len(rec["rows"]) == 2 and math.isfinite(ratio["ratio_control_over_mjhmc"])
          and ratio["ratio_control_over_mjhmc"] > 0 and Path(out + ".npz").exists(),
          f"efficiency --quick: {rec}")
    for c in confirms:
        nl = int(kw["nlags"] * max(1.0, 10.0 / c["num_leapfrog_steps"]))
        check(c["seed"] == 7 and c["nlags"] == nl and c["num_steps"] == max(kw["num_steps"], 2 * nl)
              and c["nbatch"] == kw["nbatch"], f"efficiency --quick confirmation {c}")
    for sampler in ("mjhmc", "control"):
        check(sum(c["sampler"] == sampler for c in confirms) >= 1, f"no {sampler} confirmation")
    # a censored decay is a lower bound: a ratio of two says nothing
    what = ("a ratio of lower bounds, uninformative" if ratio["censored"] else "uncensored")
    _row40(f"rows {json.dumps(rec['rows'])}, ratio {ratio['ratio_control_over_mjhmc']:.5g} "
           f"({what}); {len(confirms)} confirmations at seed 7, lags and steps as the protocol "
           f"sets them; .png {rendered}", seconds, card, rows, "efficiency --quick")


def profile_row(cm, cli, card, rows, tmp):
    """``bench --profile``: the headline under ``torch.profiler``; its
    trace must hold mjhmc_kernel's device events. Returns the run
    wrapper's launches."""
    out = Path(tmp) / "trace"
    cm.reset_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        try:
            cli(["bench", "--profile", str(out)])
        except SystemExit as e:
            check(e.code == 0, f"bench --profile exited {e.code}")
    seconds = time.perf_counter() - t0
    counts = wrapper_counts(cm)
    launches = counts.pop(("cuda_mjhmc_run", "launches"), 0)
    check(launches > 0 and not counts, f"bench --profile: launches {launches}, others {counts}")
    with open(out / "trace.json") as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    mine = [e for e in kernels if "mjhmc_kernel" in e.get("name", "")]
    check(mine, f"bench --profile: no mjhmc_kernel device events among {len(kernels)} kernels")
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e.get("dur", 0) for e in events)
    share = sum(e["dur"] for e in mine) / (hi - lo)
    busy = sum(e["dur"] for e in kernels) / (hi - lo)
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    _row40(f"{rec['value']:.5g} credited steps/s, {len(mine)} mjhmc_kernel "
           f"launches traced ({launches} counted), mjhmc_kernel {100 * share:.4g}% of the traced "
           f"window ({(hi - lo) / 1e6:.4g} s), every kernel {100 * busy:.4g}%", seconds, card,
           rows, "bench --profile")
    rows["mjhmc_kernel busy share"] = share
    return launches


def quickstart_row(card, rows):
    """``examples/quickstart_torch.py`` at its full size on the card, in
    process: the dwell-weighted variance within 10% of the quadrature
    oracle, PT's within 10% of the exact one, both decays finite."""
    import importlib.util

    import numpy as np

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", Path(__file__).resolve().parent / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = mod.main([])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    var_rel = np.abs(res["var"] / res["oracle"] - 1)
    pt_rel = abs(res["pt_var"] / res["pt_exact"] - 1)
    check(len(lines) == 5 and bool((var_rel < 0.1).all()) and pt_rel < 0.1 and all(
        math.isfinite(d) for d, _ in res["decays"].values()), f"quickstart: {lines}")
    _row40(" | ".join(lines) + f" (variance off the oracle by {np.round(var_rel, 4).tolist()}, "
           f"PT's off the exact by {pt_rel:.4f})", seconds, card, rows, "quickstart")


def plain_rows40(cm, cli, card):
    """Phase 40's plain rows, slice H on the card: ``search`` (grid and
    GP-EI), one battery grid point at M 5 and 50, ``figures --quick``,
    ``efficiency --quick`` and the quickstart. Plain PyTorch: they launch
    no fused-engine kernel. Returns {row: host seconds}."""
    import tempfile

    from mjhmc_tpu_torch.utils import init_cache

    rows = {}
    cache = init_cache.DEFAULT_CACHE_DIR
    with tempfile.TemporaryDirectory() as tmp:
        init_cache.DEFAULT_CACHE_DIR = str(Path(tmp) / "init")
        try:
            cm.reset_counts()
            search_rows(cli, card, rows)
            grid_point_rows(card, rows)
            figures_rows(cli, card, rows, tmp)
            efficiency_row(cli, card, rows, tmp)
            quickstart_row(card, rows)
            counts = wrapper_counts(cm)
            check(not counts, f"phase 40's plain rows launched fused-engine kernels: {counts}")
        finally:
            init_cache.DEFAULT_CACHE_DIR = cache
    return rows


#: seconds phase 40's plain rows may take in their own process, from the
#: start of phase 39
PLAIN_ROWS40_TIMEOUT = 900


def start_plain_rows40(workdir, plain_nuts_d8):
    """Phase 40's plain rows and the statistics of phases 42 and 43 in a
    process of their own (``chip_smoke.py --plain-rows40 T0 DIR``), started
    at phase 2's end: it imports torch, ``torch._dynamo`` (which the GP's
    Adam pulls in) and the port while the kernels' phases run, then waits
    for a line on its input, which phase 39 writes as it begins, so that
    its work, like phase 39's, leaves the card to the phases that time
    kernels. Its lines and results go to ``workdir`` (with
    ``plain_nuts_d8``, phase 2's plain NUTS that phase 42's statistics read);
    returns the process."""
    out = Path(workdir)
    (out / "plain_nuts_d8.json").write_text(json.dumps(plain_nuts_d8))
    with open(out / "rows40.out", "w") as fo, open(out / "rows40.err", "w") as fe:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--plain-rows40",
                                 repr(T0_WALL), str(out)],
                                stdin=subprocess.PIPE, stdout=fo, stderr=fe, text=True)
    SPARED.add(proc.pid)
    return proc


def plain_rows40_run(t0_wall: str, workdir: str) -> int:
    """The process of ``start_plain_rows40``: its phase lines are timed from
    the parent's start (``t0_wall``); phase 40's rows, the statistics'
    launches and each part's seconds go to ``workdir``."""
    global T0
    importlib.import_module("torch._dynamo")
    from mjhmc_tpu_torch.__main__ import main as cli
    from mjhmc_tpu_torch.bench import gpu_name_and_power_limit
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    out = Path(workdir)
    plain_nuts_d8 = json.loads((out / "plain_nuts_d8.json").read_text())
    if not sys.stdin.readline().strip():
        return 3  # the parent ended before phase 39
    T0 = time.perf_counter() - (time.time() - float(t0_wall))
    t0 = time.perf_counter()
    name, limit = gpu_name_and_power_limit()
    card = f"{name} @ {limit}"
    rows = plain_rows40(cm, cli, card)
    t1 = time.perf_counter()
    stats42 = any_d_stats(cm, card, plain_nuts_d8)
    t2 = time.perf_counter()
    stats43 = any_mm_stats(cm, cli, card)
    t3 = time.perf_counter()
    (out / "rows40.json").write_text(json.dumps({
        "rows": rows, "seconds": t1 - t0,
        "stats42": {"launches": {k: list(v) for k, v in stats42.items()}, "seconds": t2 - t1},
        "stats43": {"launches": {k: list(v) for k, v in stats43.items()}, "seconds": t3 - t2}}))
    return 0


def go_plain_rows40(proc):
    """Phase 39's start: lets ``start_plain_rows40``'s process run (where
    it has ended already, ``search_and_figures`` reports how)."""
    with contextlib.suppress(BrokenPipeError):
        proc.stdin.write("go\n")
        proc.stdin.close()


def search_and_figures(cm, cli, card, side, workdir):
    """Phase 40, slice H on the card: the lines and rows of its plain rows
    (``plain_rows40``), which ran beside phase 39 in ``side``, a process of
    their own (``start_plain_rows40``; they print host seconds, no kernel's
    time), with the statistics of phases 42 and 43, then ``bench
    --profile``, alone on the card. Returns ({row: host seconds}, the
    profiled run's launches, the side process's results: the plain rows'
    seconds, each statistics' launches and seconds)."""
    import tempfile

    from mjhmc_tpu_torch.utils import init_cache

    out = Path(workdir)
    try:
        rc = side.wait(timeout=PLAIN_ROWS40_TIMEOUT)
    finally:
        SPARED.discard(side.pid)
    sys.stdout.write((out / "rows40.out").read_text())
    sys.stderr.write((out / "rows40.err").read_text())
    sys.stdout.flush()
    check(rc == 0, f"phase 40's plain rows exited {rc}: "
          f"{(out / 'rows40.err').read_text()[-4000:]}")
    res = json.loads((out / "rows40.json").read_text())
    rows = res["rows"]
    cache = init_cache.DEFAULT_CACHE_DIR
    with tempfile.TemporaryDirectory() as tmp:
        init_cache.DEFAULT_CACHE_DIR = str(Path(tmp) / "init")
        try:
            launches = profile_row(cm, cli, card, rows, tmp)
        finally:
            init_cache.DEFAULT_CACHE_DIR = cache
    return rows, launches, res


#: phase 41's one audited grid round: gauss2d MJHMC on the card, 7 × 7 × 4
#: points (the ladder's M ≤ 20) of 20 steps at 32 chains (its 15 lags fit)
TUNE41 = dict(steps=20, nbatch=32, nlags=15, max_rounds=1)
#: JAX's fields of a bench_two_stage row (tools/bench_two_stage.py:75-84)
TWO_STAGE_FIELDS = {"config", "sampler", "integrator", "epsilon", "beta", "num_leapfrog_steps",
                    "ess_per_s", "rel_spread", "repeat_values", "window_steps",
                    "committed_row_value", "committed_row_integrator"}


def _row41(msg, seconds, card, rows, key):
    _row(msg, seconds, card, rows, key, "41 ess table and tune")


def tune_rows(cm, card, rows):
    """``bench_ess._tune`` (one audited round on the card) and
    ``_candidates`` over its table: the grid's size, s a point, the verdict
    and the candidates."""
    import numpy as np

    from mjhmc_tpu_torch import bench_ess
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    cfg = BENCHMARK_CONFIGS["gauss2d"]
    t0 = time.perf_counter()
    best, boundary, table = bench_ess._tune(cfg.make_distribution(), "mjhmc", cfg, **TUNE41)
    seconds = time.perf_counter() - t0
    check(len(table) == 7 * 7 * 4 and best in table
          and (boundary in ("interior", "physical") or boundary.startswith("pinned:")),
          f"_tune: {len(table)} points, boundary {boundary}")
    finite = [r["decay_evals"] for r in table if np.isfinite(r["decay_evals"])]
    check(finite and all(d > 0 for d in finite), "_tune: no finite positive decay")
    _row41(f"_tune gauss2d mjhmc {TUNE41}: {len(table)} grid points, "
           f"{seconds / len(table) * 1e3:.4g} ms a point; best eps {best['epsilon']:.4g}, beta "
           f"{best['beta']:.4g}, M {best['num_leapfrog_steps']}: {best['decay_evals']:.4g} evals "
           f"(censored {best['censored']}); verdict {boundary}", seconds, card, rows, "_tune")
    cands = bench_ess._candidates(best, table, cfg)
    check(cands[0] is best and 1 < len(cands) <= 7, f"_candidates: {len(cands)}")
    phase("41 ess table and tune", "_candidates: " + json.dumps(
        [(round(c["epsilon"], 4), round(c["beta"], 5), c["num_leapfrog_steps"]) for c in cands]))
    # the full table's grids at JAX's defaults (600 steps, rough_well_a3 2,400;
    # mjhmc, control and MALT on every config, two-stage again on the barrier
    # configs), one audit round each (up to five), at this round's rate per
    # grid-point iteration (its per-point work spread over 40 steps: an
    # over-estimate there, on gauss2d's cheap energy an under-estimate elsewhere)
    per_iter = seconds / len(table) / TUNE41["steps"]
    iters = sum((2400 if c == "rough_well_a3" else 600) * len(table)
                * (1 + (c in bench_ess.BARRIER_CONFIGS and s != "malt"))
                for c in bench_ess.TABLE_CONFIGS for s in ("mjhmc", "control", "malt"))
    rows["full --tune grids, one round (projected h)"] = iters * per_iter / 3600
    phase("41 ess table and tune", f"a full bench_ess --table --tune's grids: {iters:,} plain "
          f"iterations a round of the audit, {per_iter * 1e3:.4g} ms an iteration (this round's "
          f"rate): {iters * per_iter / 3600:.4g} h of card time a round, up to 5 rounds, the "
          f"NUTS warmups, arbitrations and repeats besides [{card}]")
    return seconds / len(table)


def nuts_arbitration_row(cm, card, rows):
    """``_arbitrate_nuts`` on product of t's ``nuts-engine`` row at the
    preset ε (its depth grid measured on the engine), then one ``measure``
    at max_depth 12 and one at MM_DEEP_DEPTH, so that the depth-12 kernels
    and the deeper trees run on this path whatever depth wins. Counts set to
    0 just before each ``measure``, read just after: returns the wrappers'
    max_depth 11-12 launches (run, stream) and their launches at
    MM_DEEP_DEPTH."""
    from mjhmc_tpu_torch import bench_ess
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    cfg = BENCHMARK_CONFIGS["product_of_t"]
    a = argparse.Namespace(steps=2000, burn=500, device="cuda")
    cm.reset_counts()
    t0 = time.perf_counter()
    depth, boundary, rates = bench_ess._arbitrate_nuts("product_of_t", "nuts-engine", cfg, a,
                                                       cfg.epsilon, None)
    rec = bench_ess.measure("product_of_t", "nuts-engine", 600, 200, cfg.epsilon, None, 12,
                            trials=1, device="cuda")
    wrappers = (cm.cuda_mjhmc_mm_run, cm.cuda_mjhmc_mm_stream_run)
    deep = tuple(w.deep_nuts_launches for w in wrappers)
    cm.reset_counts()
    rec_deep = bench_ess.measure("product_of_t", "nuts-engine", 600, 200, cfg.epsilon, None,
                                 MM_DEEP_DEPTH, trials=1, device="cuda")
    past12 = tuple(w.deep_nuts_launches for w in wrappers)
    seconds = time.perf_counter() - t0
    check(depth in (4, 6, 8, 10, 12) and set(rates) >= {"d4", "d6", "d8", "d10"}
          and all(v > 0 for v in rates.values()) and rec["value"] > 0
          and rec["detail"]["num_leapfrog_steps"] == 12 and rec_deep["value"] > 0
          and rec_deep["detail"]["num_leapfrog_steps"] == MM_DEEP_DEPTH,
          f"_arbitrate_nuts: depth {depth}, rates {rates}, depth-12 record {rec['value']}, "
          f"depth-{MM_DEEP_DEPTH} record {rec_deep['value']}")
    check(deep[0] >= 1 and deep[1] >= 2, f"the depth-12 kernels did not run: {deep}")
    check(past12[0] >= 1 and past12[1] >= 2, f"the depth-{MM_DEEP_DEPTH} kernels did not run: {past12}")
    _row41(f"_arbitrate_nuts product_of_t nuts-engine (4,096 chains, eps {cfg.epsilon}, "
           f"{cm.energy_spec_for(cfg.make_distribution()).precision}): depth {depth}, "
           f"{boundary}, ESS/s by depth {json.dumps(rates)}; measure(..., m=12) "
           f"{rec['value']:.6g} ESS/s; max_depth 11-12 launches (run, stream) {deep}; "
           f"measure(..., m={MM_DEEP_DEPTH}) {rec_deep['value']:.6g} ESS/s, its launches past "
           f"12 (run, stream) {past12}", seconds, card, rows, "_arbitrate_nuts")
    return deep, past12


def table_rows(cm, card, rows, tmp):
    """``bench_ess.main --table`` on gauss2d's engine rows (the rows printed
    as measured, the windows equalized), then ``bench_two_stage`` on its
    file: every row JAX's fields, leapfrog on the mjhmc and control rows,
    two-stage at (2ε, max(1, M/2)) of each beside its leapfrog twin."""
    from mjhmc_tpu_torch import bench_ess, bench_two_stage

    out, ab = str(Path(tmp) / "ess_rows.json"), str(Path(tmp) / "two_stage.json")
    samplers = ["mjhmc", "control", "malt", "nuts-engine"]
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_ess.main(["--table", "--configs", "gauss2d", "--samplers", ",".join(samplers),
                             "--repeats", "2", "--steps", "400", "--burn", "100",
                             "--json-out", out])
    seconds = time.perf_counter() - t0
    table = json.loads(Path(out).read_text())
    printed = [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]
    check(rc == 0 and [r["detail"]["sampler"] for r in table] == samplers
          and printed[-len(table):] != [] and all(r in printed for r in table),
          f"bench_ess --table: rc {rc}, rows {[r['detail']['sampler'] for r in table]}")
    windows = {r["detail"]["repeats"]["window_steps"] * r["detail"]["repeats"]["thin"]
               for r in table}
    for r in table:
        det = r["detail"]
        check(set(r) == {"metric", "value", "unit", "vs_baseline", "device_name", "power_limit",
                         "detail"} and det["engine"] == "cuda" and det["tuned"] is False
              and det["repeats"]["n"] == 2 and r["value"] > 0
              and ("integrator" in det) == (det["sampler"] in ("mjhmc", "control"))
              and det.get("integrator", "leapfrog") == "leapfrog",
              f"bench_ess --table row {det['sampler']}: {sorted(r)} {sorted(det)}")
    check(len(windows) == 1, f"bench_ess --table: windows not equalized {windows}")
    _row41(f"bench_ess --table gauss2d {samplers} --repeats 2 --steps 400: "
           f"{len(printed)} lines, window {windows.pop()}; ESS/s " + json.dumps(
               {r["detail"]["sampler"]: round(r["value"], 1) for r in table}),
           seconds, card, rows, "bench_ess --table")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = bench_two_stage.main(["--receipts", out, "--out", ab, "--configs", "gauss2d",
                                   "--repeats", "2"])
    seconds = time.perf_counter() - t0
    pairs = json.loads(Path(ab).read_text())
    check(rc == 0 and len(pairs) == 4, f"bench_two_stage: rc {rc}, {len(pairs)} rows")
    for lf, ts in zip(pairs[::2], pairs[1::2]):
        check(set(lf) == set(ts) == TWO_STAGE_FIELDS | {"device_name", "power_limit"}
              and (lf["integrator"], ts["integrator"]) == ("leapfrog", "two_stage")
              and ts["epsilon"] == 2 * lf["epsilon"]
              and ts["num_leapfrog_steps"] == max(1, lf["num_leapfrog_steps"] // 2)
              and lf["ess_per_s"] > 0 and ts["ess_per_s"] > 0,
              f"bench_two_stage rows: {lf} {ts}")
    _row41("bench_two_stage gauss2d --repeats 2 (2,000 steps): " + json.dumps(
        {f"{r['sampler']} {r['integrator']}": round(r["ess_per_s"], 1) for r in pairs}),
        seconds, card, rows, "bench_two_stage")


def sharded_smc_row(card, rec):
    """``bench_heads.sharded_path_receipt()`` at JAX's size, as phase 39's
    ``bench_heads.main`` ran it (its last row, under JAX's key): 8 gloo
    ranks on the CPU, 2,048 particles, 32 stages. A CPU path receipt."""
    check(rec is not None and rec["backend"] == "cpu-gloo-8rank"
          and rec["reached_lambda1"] is True
          and (rec["particles"], rec["num_stages"]) == (2048, 32) and rec["wall_s"] > 0,
          f"sharded_path_receipt: {rec}")
    phase("41 ess table and tune", f"bench_heads.sharded_path_receipt() from phase 39's "
          f"bench_heads.main (a CPU path receipt, not the card's: 8 gloo processes on the "
          f"host): {json.dumps(rec)} [{card}]")


def ess_table_and_tune(cm, card, sharded):
    """Phase 41, slice H part 3 on the card: one ``_tune`` round and
    ``_candidates``; ``_arbitrate_nuts`` with a depth-12 and a depth-14
    ``measure`` (the matmul NUTS kernel at max_depth 12, and past the tile
    depth on its DEEP instances); ``bench_ess --table`` and ``bench_two_stage`` on gauss2d;
    the sharded SMC receipt (``sharded``, from phase 39). Returns ({row:
    host seconds}, (the max_depth 11-12 launches (run, stream), the
    launches past 12))."""
    import tempfile

    rows = {}
    rows["_tune ms a point"] = tune_rows(cm, card, rows) * 1e3
    deep = nuts_arbitration_row(cm, card, rows)
    with tempfile.TemporaryDirectory() as tmp:
        table_rows(cm, card, rows, tmp)
    sharded_smc_row(card, sharded)
    return rows, deep



# ---- the plain NUTS runs of phases 22 and 42, made in phase 2 ----------------
#: label -> (model or preset, its keyword arguments, ε, max_depth, chains,
#: burn, steps): the plain NUTS sampler that phase 22 (product_of_t, as
#: tests/test_pallas_engine.py:892-923) and phase 42 (JAX's NUTS test at
#: Gaussian D 8, :832-866, at its own 50 + 500 iterations) hold CudaNUTS to.
#: The sampler costs a few host operations a leaf, so each runs on the CPU
#: (one thread, ~1 min for D 8) in a process of its own while phase 2
#: builds the kernels; the card would take ~117 s for D 8 alone.
PLAIN_NUTS = {
    "product_of_t": ("product_of_t", {}, 0.12, 7, 512, 20, 100),
    "gaussian d8": ("Gaussian", dict(ndims=8, log_conditioning=2.0), 0.25, 8, 1024, 50, 500),
}
PLAIN_NUTS_TIMEOUT = 600


def plain_nuts_run(label: str) -> int:
    """One process of phase 2 (``chip_smoke.py --plain-nuts label``): the
    plain NUTS of ``PLAIN_NUTS[label]`` on the CPU at seed 1; prints the
    variances of its samples and its leaves an iteration as one JSON
    line."""
    from mjhmc_tpu_torch import models
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.samplers import NUTS

    torch.set_num_threads(1)
    name, kw, eps, depth, n, burn, steps = PLAIN_NUTS[label]
    dist = (BENCHMARK_CONFIGS[name].make_distribution() if name in BENCHMARK_CONFIGS
            else getattr(models, name)(**kw))
    t0 = time.perf_counter()
    ref = NUTS(dist, epsilon=eps, max_depth=depth, nbatch=n, seed=1, device="cpu")
    ref.burn_in(burn)
    o = ref.sample(steps)
    xs = o["x"].double()
    var = (xs**2).mean(dim=(0, 2)) - xs.mean(dim=(0, 2)) ** 2
    ev = o["evals_mean"].double()
    print(json.dumps({"var": var.tolist(), "leaves": float(ev[-1] - ev[0]) / (steps - 1),
                      "seconds": time.perf_counter() - t0, "end": time.time()}))
    return 0


def start_plain_nuts():
    """Phase 2: every ``PLAIN_NUTS`` run, each in a process of its own;
    returns ({label: process}, the wall clock at their start)."""
    return {label: subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                     "--plain-nuts", label], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            for label in PLAIN_NUTS}, time.time()


def plain_nuts_results(started):
    """Waits for ``start_plain_nuts``'s processes; returns {label: {var,
    leaves, seconds (the sampler's), done_s (from their start to the run's
    end, its process's start-up included), what (the run's settings)}}."""
    procs, wall0 = started
    out = {}
    try:
        for label, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=PLAIN_NUTS_TIMEOUT)
            check(proc.returncode == 0, f"the plain NUTS of {label} exited {proc.returncode}:\n"
                  f"{stderr[-4000:]}")
            res = json.loads(stdout.strip().splitlines()[-1])
            _, _, eps, depth, n, burn, steps = PLAIN_NUTS[label]
            res["done_s"] = res["end"] - wall0
            res["what"] = (f"{n:,} chains, eps {eps}, max_depth {depth}, {burn} + {steps}, on the "
                           f"CPU in phase 2, {res['seconds']:.3g} s host clock")
            out[label] = res
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


# ---- phase 42: the elementwise engine at any D --------------------------------
#: on-demand builds at a time (phase 2; the card's host has 8 cores): fewer
#: while the library's own nvcc run beside them, so that its longest sources
#: (phase 2's critical path) are not spread thinner, then as many as cores
ONDEMAND_BESIDE_LIBRARY = 4
ONDEMAND_BUILDERS = 8
ANY_D_CHAINS = 4096
#: the branch cases of phase 42 beside every body at every shape: (shape,
#: body, options); the mass is M⁻¹ from 0.5 to 1.5 over the dims
ANY_D_BRANCHES = (("gaussian d16", "mjhmc", dict(integrator="two_stage", mass=True)),
                  ("funnel d8", "control", dict(integrator="two_stage", mass=True)),
                  ("banana d10", "malt", dict(mass=True)),
                  ("gaussian d128", "nuts", dict(mass=True)),
                  ("mog d2 k10", "mjhmc", dict(mass=True)))
#: (burn, steps) of phase 42's timing: MJHMC, control, MALT; NUTS
ANY_D_TIMING_ITERS = (300, 60)
ANY_D_BETA = {"mjhmc": 0.1, "control": 0.2, "malt": 1.0, "nuts": 0.0}


def any_d_keys(cm, _build):
    """{(shape, body): the on-demand instance (``_build.ew_instance``)} of
    every body at every any-D shape."""
    out = {}
    for label, (dist, _, _) in any_d_dists().items():
        spec = cm.energy_spec_for(dist)
        check(not cm.compiled_ahead(spec, dist.ndims), f"{label} is a preset's shape")
        for body in ZOO_BODIES:
            out[(label, body)] = _build.ew_instance(cm.KERNEL_VARIANTS[body], spec.energy_id,
                                                    dist.ndims, cm.mog_cap(spec))
    return out


def start_ondemand_builds(cm, _build):
    """Phase 2: every on-demand instance of phases 42, 43 and 44, the matmul ones
    (the longest) first, started beside the library's build,
    ONDEMAND_BESIDE_LIBRARY nvcc at a time until the caller releases the
    rest of ONDEMAND_BUILDERS (``gate.release``, once the library is built);
    returns the pool, the gate and ({instance: future of (path, nvcc seconds
    in this run or None where the library was built before, seconds from
    the start to its end)} of phase 42's, of phases 43's and 44's)."""
    import threading

    pool = concurrent.futures.ThreadPoolExecutor(ONDEMAND_BUILDERS)
    gate = threading.Semaphore(ONDEMAND_BESIDE_LIBRARY)
    t0 = time.perf_counter()

    def build(inst):
        with gate:
            path, nvcc_s = _build.build_instance(inst)
        return path, nvcc_s, time.perf_counter() - t0

    # the largest matmul shapes first: their nvcc takes longest
    mm = sorted({*any_mm_instances(cm, _build).values(), *past_instances(cm, _build).values()},
                key=lambda i: -math.prod(int(m.split("=")[1]) for m in i.macros[2:4]))
    mm_futures = {inst: pool.submit(build, inst) for inst in mm}
    ew_futures = {inst: pool.submit(build, inst) for inst in set(any_d_keys(cm, _build).values())}
    return pool, gate, (ew_futures, mm_futures)


def any_d_builds(_build, done, card):
    """Phase 42's build report from phase 2's builds (``done``): each
    on-demand library's nvcc seconds in this run (or that it was reused)
    and its ptxas registers and spills, as its log has them. Returns {key:
    nvcc seconds, None for a reused library}."""
    built = sum(s is not None for _, s, _ in done.values())
    phase("42 any D", f"{len(done)} on-demand libraries from phase 2, {built} built in this run "
          f"and {len(done) - built} reused from the build directory [{card}]")
    seconds = {}
    for key, (path, nvcc_s, _) in sorted(done.items(), key=lambda kv: kv[0].stem):
        seconds[key] = nvcc_s
        ptx = "; ".join(f"{k}: {r} registers, {sp} B spill stores"
                        for k, r, sp in ptxas_report(_build.instance_log(key)))
        took = "reused, not built in this run" if nvcc_s is None else f"nvcc {nvcc_s:.1f} s"
        phase("42 any D", f"{path.name}: {took}; ptxas {ptx}")
    return seconds


def any_d_tiles(cm, card):
    """Each on-demand instance's tile as it reports it against the
    wrappers' mirror: the MJHMC, control and MALT groupings (lanes a chain,
    threads a block) and the NUTS tile (threads, shared bytes, blocks an SM;
    the scratch past 10 dims) at phase 42's chains."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = {}
    for label, (dist, _, _) in any_d_dists().items():
        spec, d, n = cm.energy_spec_for(dist), dist.ndims, ANY_D_CHAINS
        for body in ("mjhmc", "control", "malt"):
            got = cm.ew_tile(body, spec, d, n)
            lanes = cm.ew_lanes(body, spec, d)
            want = (lanes, cm.ew_threads(lanes, n, sms))
            check(got == want, f"{body} grouping of {label}: the instance's {got}, the mirror's "
                  f"{want}")
            tiles[f"{body} {label}"] = got
        for mass in (False, True):
            for depth in (1, CLI_NUTS_DEPTH, 12, 31):
                got = cm.nuts_tile(spec, d, depth, n, mass)
                threads = cm.nuts_threads(d, n, sms)
                want = (threads, cm.nuts_smem_bytes(d, threads, depth))
                check(got[:2] == want and got[2] >= 1, f"NUTS tile of {label} (max_depth {depth}"
                      f"{', a mass' if mass else ''}): the instance's {got}, the mirror's {want}")
                scratch = cm.nuts_tree_scratch(d, depth, n, DEV)
                check((scratch is None) == (d <= cm.NUTS_ON_CHIP_DIMS), f"{label}: scratch rule")
                tiles[f"nuts {label} max_depth {depth}{' mass' if mass else ''}"] = got
    phase("42 any D", f"on-demand tiles on {sms} SMs at {ANY_D_CHAINS} chains (lanes, threads "
          f"a block; NUTS threads, shared bytes a block, blocks an SM), instance = mirror: "
          f"{json.dumps(tiles)} [{card}]")


def any_d_cases():
    """Phase 42's cases for ``case_checks``: every body at every any-D
    shape at ANY_D_CHAINS chains (NUTS at max_depth ZOO_NUTS_DEPTH, 3
    iterations; the others the shape's ε and M, 5), and ANY_D_BRANCHES."""
    rows = []
    dists = any_d_dists()
    for label, (dist, eps, m) in dists.items():
        for body in ZOO_BODIES:
            nuts = body == "nuts"
            rows.append((f"{label} {body}", label, dist, ANY_D_CHAINS, eps, ANY_D_BETA[body],
                         ZOO_NUTS_DEPTH if nuts else m, 3 if nuts else 5, dict(variant=body)))
    for label, body, br in ANY_D_BRANCHES:
        dist, eps, m = dists[label]
        kw = dict(variant=body)
        if "integrator" in br:
            kw["integrator"] = br["integrator"]
        if br.get("mass"):
            kw["inv_mass"] = tuple(float(v) for v in torch.linspace(0.5, 1.5, dist.ndims))
        nuts = body == "nuts"
        tags = [br.get("integrator", ""), "inv_mass" if br.get("mass") else ""]
        rows.append((f"{label} {body} {' '.join(filter(None, tags))}", label, dist, ANY_D_CHAINS, eps,
                     ANY_D_BETA[body], ZOO_NUTS_DEPTH if nuts else m, 3 if nuts else 5, kw))
    return rows


def any_d_stats(cm, card, plain_nuts):
    """Phase 42: the JAX package's six TPU-gated engine checks at their own
    shapes, settings and tolerances (tests/test_pallas_engine.py), on the
    port's engines through on-demand instances: the Gaussian at D 16 with
    M⁻¹ = its variances (:455-490), the funnel at D 8 after
    ``CudaMJHMC.from_warmup`` (:493-513), control (:626-658) and MALT
    (:748-789) at D 4 against the plain samplers, NUTS at D 8 against the
    plain NUTS (:832-866; ``plain_nuts``, its 50 + 500 iterations of 1,024
    chains run on the CPU in phase 2), the NUTS stream at D 4 (:869-889).
    Returns the launches of each engine, counted from 0 just before it."""
    from mjhmc_tpu_torch.models import Funnel, Gaussian
    from mjhmc_tpu_torch.samplers import MALT, ControlHMC, MarkovJumpHMC

    launches = {}

    def var_of(xs):
        xs = xs.double()
        return (xs**2).mean(dim=(0, 2)) - xs.mean(dim=(0, 2)) ** 2

    def counted(key, body, fn):
        cm.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[key] = counts(cm, "launches" if body == "mjhmc" else f"{body}_launches")
        check(sum(launches[key]) > 0, f"{key}: no launch")
        return out, time.perf_counter() - t0

    # (a) D 16, M⁻¹ = the variances, against the plain MJHMC's dwell and evals
    dist = Gaussian(ndims=16, log_conditioning=3.0)
    im = tuple(float(v) for v in dist.variances)

    def mass16():
        eng = cm.CudaMJHMC(dist, epsilon=1.0, beta=0.1, num_leapfrog_steps=10, nbatch=4096,
                           seed=0, inv_mass=im, device=DEV)
        eng.run(300)
        return eng, eng.run(500)
    (eng, out), sec = counted("gaussian d16 inv_mass", "mjhmc", mass16)
    dwell_p = float(out.w.double().sum()) / (eng.nbatch * 500)
    evals_p = float(out.evals.double().mean())
    ratio = (cm.CudaMJHMC.moments(out)[1].double().cpu() / torch.as_tensor(dist.variances))
    ref = MarkovJumpHMC(dist, epsilon=1.0, beta=0.1, num_leapfrog_steps=10, nbatch=4096, seed=1,
                        mass_diag=tuple(1.0 / v for v in im), device=DEV)
    ref.burn_in(300)
    rout = ref.sample(500)
    dwell_x = float(rout["dwell"].double().mean())
    evals_x = float(ref.state.grad_evals.double().mean())
    med = float(ratio.median())
    check(abs(med - 1) < 0.1 and float(ratio.max()) < 1.35 and float(ratio.min()) > 0.65
          and abs(dwell_p - dwell_x) < 0.05 * dwell_x and abs(evals_p - evals_x) < 0.05 * evals_x,
          f"D 16 with a mass: var/analytic {ratio.tolist()}, dwell {dwell_p} vs {dwell_x}, "
          f"evals {evals_p} vs {evals_x}")
    phase("42 any D stats", f"CudaMJHMC Gaussian(16, log_conditioning 3) with M^-1 = the variances "
          f"(4,096 chains, eps 1, beta 0.1, M 10, 300 + 500): median var/analytic {med:.5f} (0.1), "
          f"all in [{float(ratio.min()):.4f}, {float(ratio.max()):.4f}] ((0.65, 1.35)); dwell "
          f"{dwell_p:.5f} vs the plain sampler's {dwell_x:.5f}, evals {evals_p:.6g} vs "
          f"{evals_x:.6g} (5%); engine {sec:.3g} s host clock [{card}]")

    # (b) the funnel at D 8 after the warmup
    funnel = Funnel(ndims=8, sigma_v=2.0)
    t0 = time.perf_counter()
    eng = cm.CudaMJHMC.from_warmup(funnel, seed=0, nbatch=8192, beta=0.2, num_leapfrog_steps=10,
                                   phase1=200, phase2=300, phase3=150, device=DEV)
    warm_s = time.perf_counter() - t0
    check(eng.inv_mass is not None and eng.epsilon > 0, "funnel D 8 warmup")
    out, sec = counted("funnel d8 from_warmup", "mjhmc", lambda: eng.run(3000))
    ratio = cm.CudaMJHMC.moments(out)[1].double().cpu() / funnel.analytic_var().double()
    check(float(ratio.min()) > 0.5 and float(ratio.max()) < 1.6,
          f"funnel D 8 var/analytic {ratio.tolist()}")
    phase("42 any D stats", f"CudaMJHMC.from_warmup(Funnel(ndims=8, sigma_v=2)) (8,192 chains, "
          f"beta 0.2, M 10, phases 200/300/150; warmup {warm_s:.3g} s host clock, eps "
          f"{eng.epsilon:.5g}), 3000 iterations: var/analytic in [{float(ratio.min()):.5f}, "
          f"{float(ratio.max()):.5f}] ((0.5, 1.6)); engine {sec:.3g} s [{card}]")

    # (c), (d) control and MALT at D 4 against the plain samplers
    g4 = Gaussian(ndims=4, log_conditioning=2.0)
    tgt = torch.as_tensor(g4.variances).double()
    for key, ecls, pcls, kw, pkw in (
            ("control", cm.CudaControlHMC, ControlHMC, dict(beta=0.25), dict(beta=0.25)),
            ("malt", cm.CudaMALT, MALT, dict(beta=1.5), dict(gamma=1.5))):
        def engine_run():
            eng = ecls(g4, epsilon=0.15, num_leapfrog_steps=10, nbatch=4096, seed=0,
                       device=DEV, **kw)
            eng.run(400)
            return eng.run(600)
        out, sec = counted(f"gaussian d4 {key}", key, engine_run)
        check(bool((out.w == 600).all()) and bool((out.evals == 6000).all()),
              f"{key} D 4: w and evals exact")
        var_p = cm.CudaMJHMC.moments(out)[1].double().cpu()
        ref = pcls(g4, epsilon=0.15, num_leapfrog_steps=10, nbatch=4096, seed=1, device=DEV,
                   **pkw)
        ref.burn_in(400)
        var_x = var_of(ref.sample(600)["x"]).cpu()
        r_plain, r_tgt = float((var_p / var_x).median()), float((var_p / tgt).median())
        check(abs(r_plain - 1) < 0.12 and abs(r_tgt - 1) < 0.12,
              f"{key} D 4: median var ratio {r_plain}, var/analytic {r_tgt}")
        msg = ""
        if key == "malt":  # γ = 0: full-refresh HMC
            def gamma0():
                eng = cm.CudaMALT(g4, epsilon=0.15, beta=0.0, num_leapfrog_steps=10,
                                  nbatch=4096, seed=2, device=DEV)
                eng.run(400)
                return eng.run(600)
            out0, _ = counted("gaussian d4 malt gamma 0", "malt", gamma0)
            r0 = float((cm.CudaMJHMC.moments(out0)[1].double().cpu() / tgt).median())
            check(abs(r0 - 1) < 0.12, f"MALT gamma 0 D 4: median var/analytic {r0}")
            msg = f"; gamma 0: median var/analytic {r0:.5f} (0.12)"
        phase("42 any D stats", f"{ecls.__name__} Gaussian(4, log_conditioning 2) (4,096 chains, "
              f"eps 0.15, {'beta 0.25' if key == 'control' else 'gamma 1.5'}, M 10, 400 + 600): "
              f"w and evals exact; median var ratio to the plain {pcls.__name__} {r_plain:.5f}, "
              f"median var/analytic {r_tgt:.5f} (0.12){msg}; engine {sec:.3g} s [{card}]")

    # (e) NUTS at D 8 against the plain NUTS: variances and leaves an iteration
    g8 = Gaussian(ndims=8, log_conditioning=2.0)

    def nuts8():
        eng = cm.CudaNUTS(g8, epsilon=0.25, num_leapfrog_steps=8, nbatch=4096, seed=0, device=DEV)
        eng.run(50)
        return eng.run(500)
    out, sec = counted("gaussian d8 nuts", "nuts", nuts8)
    check(bool((out.w == 500).all()), "NUTS D 8: w == steps")
    var_p = cm.CudaMJHMC.moments(out)[1].double().cpu()
    leaves_eng = float(out.evals.double().mean()) / 500
    var_x = torch.as_tensor(plain_nuts["var"], dtype=torch.float64)
    leaves_x = plain_nuts["leaves"]
    tgt = torch.as_tensor(g8.variances).double()
    r_plain, r_tgt = float((var_p / var_x).median()), float((var_p / tgt).median())
    check(abs(r_plain - 1) < 0.12 and abs(r_tgt - 1) < 0.12
          and abs(leaves_eng / leaves_x - 1) < 0.1,
          f"NUTS D 8: median var ratio {r_plain}, var/analytic {r_tgt}, leaves {leaves_eng} vs "
          f"{leaves_x}")
    phase("42 any D stats", f"CudaNUTS Gaussian(8, log_conditioning 2) (4,096 chains, eps 0.25, "
          f"max_depth 8, 50 + 500): median var ratio to the plain NUTS ({plain_nuts['what']}) "
          f"{r_plain:.5f}, median var/analytic {r_tgt:.5f} (0.12); "
          f"leaves an iteration {leaves_eng:.5g} vs {leaves_x:.5g} (10%); engine {sec:.3g} s "
          f"[{card}]")

    # (f) the NUTS stream at D 4 against its own accumulators
    g4b = Gaussian(ndims=4, log_conditioning=1.0)

    def stream4():
        eng = cm.CudaNUTS(g4b, epsilon=0.5, num_leapfrog_steps=6, nbatch=2048, seed=5, device=DEV)
        eng.run(100)
        xs, ws = eng.sample(400)
        return eng, xs, ws, eng.run(400)
    (eng, xs, ws, out), sec = counted("gaussian d4 nuts stream", "nuts", stream4)
    check(tuple(xs.shape) == (400, 4, 2048) and bool((ws == 1).all())
          and int(out.evals.min()) >= 400, "NUTS stream D 4: shapes, weights, leaves")
    ratio = float((xs.double().var(dim=(0, 2)).cpu()
                   / cm.CudaMJHMC.moments(out)[1].double().cpu()).median())
    check(abs(ratio - 1) < 0.2, f"NUTS stream D 4: median var ratio {ratio}")
    phase("42 any D stats", f"CudaNUTS Gaussian(4, log_conditioning 1) stream (2,048 chains, eps "
          f"0.5, max_depth 6, 100 + 400 + 400): ws == 1, leaves >= 1 an iteration, median "
          f"var(stream)/var(accumulators) {ratio:.5f} (0.2); engines {sec:.3g} s [{card}]")
    return launches


def any_d_timing(cm, card):
    """Phase 42: ms per iteration (CUDA events) of every body's on-demand
    instance at every any-D shape, run and stream, through the engines at
    ANY_D_CHAINS chains and the shape's ε and M (NUTS at max_depth 8),
    beside the plain version; each engine's launches counted from 0 just
    before it. Returns {(shape, body): (run ms, stream ms, plain run ms,
    plain stream ms, gradients, iterations, chains, (run, stream)
    launches)}."""
    rows = {}
    ecls = {"nuts": cm.CudaNUTS, "mjhmc": cm.CudaMJHMC, "control": cm.CudaControlHMC,
            "malt": cm.CudaMALT}
    for label, (dist, eps, m0) in any_d_dists().items():
        n = ANY_D_CHAINS
        for body in ZOO_BODIES:
            nuts = body == "nuts"
            m = CLI_NUTS_DEPTH if nuts else m0
            beta = ANY_D_BETA[body]
            iters = ANY_D_TIMING_ITERS[nuts]
            cm.reset_counts()
            eng = ecls[body](dist, epsilon=eps, beta=beta, num_leapfrog_steps=m, nbatch=n,
                             seed=4, device=DEV)
            eng.run(10)
            before = eng.grad_evals
            run_ms = events_ms(lambda: eng.run(iters)) / iters
            grads = eng.grad_evals - before
            stream_ms = events_ms(lambda: eng.sample(iters)) / iters
            launches = counts(cm, "launches" if body == "mjhmc" else f"{body}_launches")
            check(all(v > 0 for v in launches), f"{label} {body}: kernels not launched")
            args = (eng.spec, *initial_state(dist, n, seed=5), 99, eps, beta)
            pkw = dict(variant=body)
            if not nuts:  # a warm call; the plain NUTS's seconds dwarf its first call's cost
                cm.run_reference(*args, 1, m, **pkw)
            plain_ms = events_ms(lambda: cm.run_reference(*args, 1, m, **pkw))
            plain_stream_ms = events_ms(lambda: cm.stream_reference(*args, 1, 1, m, **pkw))
            rows[(label, body)] = (run_ms, stream_ms, plain_ms, plain_stream_ms, grads, iters, n,
                                   launches)
            phase("42 any D timing", f"{body} {label} ({n} chains, eps {eps}, beta {beta}, "
                  f"{'max_depth' if nuts else 'M'} {m}): run {run_ms:.6g} ms/iteration, stream "
                  f"(thin 1) {stream_ms:.6g}; plain version run {plain_ms:.6g}, stream "
                  f"{plain_stream_ms:.6g} ms/iteration; {grads / (n * iters):.5g} "
                  f"{'leaves' if nuts else 'gradients'} per chain and iteration [{card}]")
    return rows


def any_d_energy(dist):
    """(the energy's name as ``bound`` prices it, the mixture's components)."""
    name = type(dist).__name__
    if name == "GaussianMixture":
        return "mog", len(dist.scales)
    return {"Gaussian": "gauss50d", "Funnel": "funnel", "Banana": "banana"}[name], 0


def any_d_entries(entry, errs, ident, rows, seconds, keys):
    """The kernels line's entries of phase 42: every body at every any-D
    shape, run and stream, from its on-demand instance; launches and times
    from phase 42's engines, errors from its fixed-uniform checks, its
    library's nvcc seconds in this run (null where the library was built
    before and reused)."""
    out = []
    variants = {"nuts": NUTS_VARIANT, "mjhmc": MJHMC_VARIANT, "control": CONTROL_VARIANT,
                "malt": MALT_VARIANT}
    for label, (dist, _, _) in any_d_dists().items():
        cname, k = any_d_energy(dist)
        for body in ZOO_BODIES:
            run_ms, stream_ms, plain_ms, plain_stream_ms, grads, iters, n, launches = \
                rows[(label, body)]
            cases = [c for c in errs if c.startswith(f"{label} {body}")]
            for idx, (suffix, src) in enumerate((("run", RUN_SRC), ("stream", STREAM_SRC))):
                stream = idx == 1
                extra = {"variant": variants[body], "instance": "on demand",
                         "nvcc_s": seconds[keys[(label, body)]],
                         "shape": f"{label}, {n} chains, "
                                  f"{'max_depth 8' if body == 'nuts' else 'its eps and M'}"
                                  f"{', thin 1' if stream else ''}, ms per iteration"}
                if body == "nuts":
                    extra["bit_identical_share"] = {c: ident[c] for c in cases}
                out.append(entry(
                    f"{body}_{suffix}[{label}]", ONDEMAND_SRC, src, launches[idx],
                    max(errs[c] for c in cases), stream_ms if stream else run_ms,
                    plain_stream_ms if stream else plain_ms,
                    bound(cname, body, dist.ndims, k, n, iters, grads, iters if stream else 0),
                    **extra))
    return out


def any_d_phase(cm, _build, card, done, stats):
    """Phase 42: the on-demand instances' builds (``done``, phase 2's),
    tiles, every body at every any-D shape against its plain version, the
    timings; JAX's TPU-gated checks at their shapes (``any_d_stats``) ran
    beside phase 39 (``stats``: their launches and seconds). Returns
    (errors, NUTS identical shares, timing rows, nvcc seconds, instance
    keys)."""
    t0 = time.perf_counter()
    seconds = any_d_builds(_build, done, card)
    any_d_tiles(cm, card)
    errs, ident = case_checks(cm, any_d_cases(), ("42 any D fixed-uniform", "42 any D philox"),
                              exact_counters=True)
    t_checks = time.perf_counter()
    rows = any_d_timing(cm, card)
    phase("42 any D", f"phase 42 took {time.perf_counter() - t0:.4g} s: the checks "
          f"{t_checks - t0:.4g}, the timings {time.perf_counter() - t_checks:.4g}; the "
          f"statistics {stats['seconds']:.4g} s beside phase 39, their engines' launches "
          f"{json.dumps(stats['launches'])} [{card}]")
    return errs, ident, rows, seconds, any_d_keys(cm, _build)

# ---- phase 43: the matmul engine at any (d, k) and dot precision -------------
#: the matmul shapes of phase 43 and tests/test_torch_any_mm_shapes.py, label
#: "<config> <d>x<k>" -> (model, its arguments, ε, M): the JAX package's own
#: codegen shapes (tests/test_pallas_engine.py:58, :437; sparse coding on the
#: patch linspace(-1, 1, 64)), an overcomplete product of t, one whose d and
#: k are no multiples of 4, a logreg whose padded observation rows must add no
#: ln 2, sparse coding whose parameter matrix fits on chip with a smaller
#: tile only, and one whose does not fit (it sits in device memory). ε is
#: about one over the energy's stiffest frequency (ε·ω ≤ 1.4)
ANY_MM_SHAPES = {
    "sparse_coding 96x64": ("SparseCoding", dict(patch=64, nbasis=96), 0.02, 10),
    "logreg 16x64": ("LogisticRegression", dict(ndims=16, nobs=64), 0.25, 10),
    "product_of_t 36x72": ("ProductOfT", dict(ndims=36, nbasis=72), 0.12, 10),
    "product_of_t 10x13": ("ProductOfT", dict(ndims=10, nbasis=13), 0.12, 10),
    "logreg 7x100": ("LogisticRegression", dict(ndims=7, nobs=100), 0.25, 10),
    "sparse_coding 200x100": ("SparseCoding", dict(npixels=100, nbasis=200), 0.02, 10),
    "sparse_coding 288x144": ("SparseCoding", dict(npixels=144, nbasis=288), 0.02, 10),
}
#: the dot precisions each shape runs at beyond its spec's JAX default, and
#: a preset shape at a (body, precision) pair the library lacks
ANY_MM_PRECISIONS = {"product_of_t 36x72": ("highest", "bf16x3", "bf16x2")}
ANY_MM_PRESET_PAIRS = (("logreg 16x256", "control", "bf16x3"),)
ANY_MM_CHAINS = 4096
ANY_MM_NUTS_DEPTH = 4  # max_depth of phase 43's two-iteration checks
#: the shapes whose NUTS instance phase 43 also holds at the CLI's max_depth
#: (one fixed-uniform iteration at ANY_MM_DEEP_CHAINS chains: every chain
#: runs the full tree, its rows past depth 4 and, at 288x144, its tree state
#: in the device buffer after the parameter matrix), the plain version on
#: the CPU in ANY_MM_DEEP_WORKERS processes beside the other checks; the
#: timings run at that depth too
ANY_MM_DEEP_NUTS = ("sparse_coding 200x100", "sparse_coding 288x144")
ANY_MM_DEEP_CHAINS = 1024
ANY_MM_DEEP_WORKERS = 6
ANY_MM_BETA = {"mjhmc": 0.1, "control": 0.2, "malt": 1.0, "nuts": 0.0}
#: (iterations held, iterations timed) of phase 43
ANY_MM_ITERS = (2, 20)


def any_mm_model(models, name, kw):
    """A model of ``models`` (this package's or the JAX package's) from its
    ANY_MM_SHAPES entry; ``patch``: ``with_patch`` on linspace(-1, 1, patch)."""
    if "patch" in kw:
        n = kw["patch"]
        patch = [-1.0 + 2.0 * i / (n - 1) for i in range(n)]
        return models.SparseCoding.with_patch(patch, nbasis=kw["nbasis"])
    return getattr(models, name)(**kw)


def any_mm_dists():
    """label -> (distribution, ε, M) of every shape of ANY_MM_SHAPES."""
    from mjhmc_tpu_torch import models

    return {label: (any_mm_model(models, name, kw), eps, m)
            for label, (name, kw, eps, m) in ANY_MM_SHAPES.items()}


def any_mm_cases(cm):
    """(label, distribution, spec, body, ε, M) of every on-demand matmul
    instance of phase 43: the four bodies at every shape at the spec's JAX
    default precision and at ANY_MM_PRECISIONS, and ANY_MM_PRESET_PAIRS."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

    out = []
    for label, (dist, eps, m) in any_mm_dists().items():
        spec = cm.energy_spec_for(dist)
        for prec in (spec.precision, *ANY_MM_PRECISIONS.get(label, ())):
            for body in ZOO_BODIES:
                out.append((label, dist, at(spec, prec), body, eps, m))
    for label, body, prec in ANY_MM_PRESET_PAIRS:
        cfg = BENCHMARK_CONFIGS[label.split()[0]]
        dist = cfg.make_distribution()
        out.append((label, dist, at(cm.energy_spec_for(dist), prec), body, cfg.epsilon,
                    cfg.num_leapfrog_steps))
    return out


def any_mm_instances(cm, _build):
    """{(label, precision, body): the on-demand instance (``_build.Instance``)}
    of every case of ``any_mm_cases``; none is compiled ahead."""
    out = {}
    for label, _, spec, body, _, _ in any_mm_cases(cm):
        check(not cm.mm_compiled_ahead(spec, sweep_run=False),
              f"{label} {body} at {spec.precision} is in the library")
        rule = cm.nuts_mm_tile_rule(spec) if body == "nuts" else cm.mm_tile_rule(spec, body)
        out[(label, spec.precision, body)] = _build.mm_instance(
            cm.KERNEL_VARIANTS[body], spec.energy_id, *cm.mm_shape(spec),
            cm.PRECISIONS.index(spec.precision), rule.off, rule.chunk, rule.xg_off)
    return out


def any_mm_builds(_build, done, card, name="43 any (d, k)"):
    """Phase 43's build report from phase 2's builds: each on-demand
    library's nvcc seconds in this run (or that it was reused) and its
    ptxas registers and spills. Returns {instance: nvcc seconds, None for a
    reused library}."""
    built = sum(s is not None for _, s, _ in done.values())
    phase(name, f"{len(done)} on-demand matmul libraries from phase 2, {built} built "
          f"in this run and {len(done) - built} reused from the build directory [{card}]")
    seconds = {}
    for inst, (path, nvcc_s, _) in sorted(done.items(), key=lambda kv: kv[0].stem):
        seconds[inst] = nvcc_s
        ptx = "; ".join(f"{k}: {r} registers, {sp} B spill stores"
                        for k, r, sp in ptxas_report(_build.instance_log(inst)))
        took = "reused, not built in this run" if nvcc_s is None else f"nvcc {nvcc_s:.1f} s"
        phase(name, f"{path.name}: {took}; ptxas {ptx}")
    return seconds


def any_mm_tiles(cm, card, cases=None, name="43 any (d, k)", chains=None):
    """Each on-demand instance's tile as it reports it against the tile
    rule's mirror: mm_kernel's (chains, threads, shared bytes) with and
    without the branches, NUTS's at max_depth 1, 8, 12 and 31 (past 12 the
    DEEP instance's tile, as those trees run); the blocks an SM
    holds at least 1; of phase 43's (``cases`` None), the parameter matrix
    off chip at (288, 144) only. A tile with a ring (its stages and whether
    it may split, as the instance reports them, against the mirror's): the
    clusters of 2, 4, 8 and 16 CTAs the card holds at once
    (cudaOccupancyMaxActiveClusters) and the cluster size and mode of its
    launch at ``chains[label]`` chains and at one tile (``cm.cluster_of``)."""
    tiles = {}
    for label, _, spec, body, _, _ in any_mm_cases(cm) if cases is None else cases:
        key = f"{label} {spec.precision} {body}"
        if body == "nuts":
            rule = cm.nuts_mm_tile_rule(spec)
            for depth in (1, CLI_NUTS_DEPTH, cm.NUTS_MM_TILE_DEPTH, cm.NUTS_MM_MAX_DEPTH):
                got = cm.nuts_mm_tile(spec, depth)
                want = (rule.chains, rule.threads, cm.nuts_mm_smem_bytes(spec, depth))
                check(got[:3] == want and got[3] >= 1, f"NUTS tile of {key} (max_depth {depth}): "
                      f"the instance's {got}, the mirror's {want}")
                tiles[f"{key} max_depth {depth}"] = got
        else:
            rule = cm.mm_tile_rule(spec, body)
            for br in (True, False) if body == "mjhmc" else (True,):
                got = cm.mm_tile(spec, body, br)
                want = (rule.chains, rule.threads, cm.mm_smem_bytes(spec, body, br))
                check(got[:3] == want and got[3] >= 1, f"mm_kernel tile of {key}"
                      f"{' branches' if br else ''}: the instance's {got}, the mirror's {want}")
                tiles[f"{key}{' branches' if br else ''}"] = got
        check(cases is not None or rule.off == label.endswith("288x144"),
              f"{key}: parameter matrix off chip {rule.off}")
        tiles[f"{key} parameter matrix"] = "device memory" if rule.off else "shared memory"
        if rule.chunk:
            tiles[f"{key} chunk"] = (f"{rule.chunk} rows, X and G in "
                                     f"{'device memory' if rule.xg_off else 'shared memory'}"
                                     + (f", a ring of {rule.stages} stages" if rule.stages else ""))
        for nc in ((chains or {}).get(label, rule.chains), rule.chains) if rule.stages else ():
            cl = cm.cluster_of(spec, body, nc, PAST_DEEP_DEPTH if nc == rule.chains else 12)
            splits = cm.nuts_splits(rule) if body == "nuts" else cm.mm_splits(rule)
            check(cl is not None and cl["stages"] == rule.stages and cl["splits"] == splits
                  and (cl["c"] == 1 or cl["held"][cl["c"]] >= 1), f"{key}: the instance's "
                  f"cluster {cl}, the mirror's {rule.stages} stages, split {splits}")
            tiles[f"{key} cluster at {nc} chains"] = (
                (f"clusters of {cl['c']} CTAs, one tile split over each" if cl['split']
                 else "a CTA a tile") + f", grid {cl['grid']}; clusters the card holds of 2/4/8/16: "
                f"{'/'.join(str(v) for v in cl['held'].values())}")
    phase(name, f"on-demand tiles (chains, threads, shared bytes a block, blocks an "
          f"SM), instance = mirror: {json.dumps(tiles)} [{card}]")


def any_mm_energy_check(cm, dist, spec, body, n, start=initial_state):
    """The contraction and the energy alone: one iteration at ε = 0 leaves
    x where it starts, so the gradient and U that come out are the
    instance's at the plain version's x, on every chain. Returns (largest
    relative U error, largest relative gradient error)."""
    st = start(dist, n, seed=3)
    args = (spec, *st, 7, 0.0, ANY_MM_BETA[body])
    k = cm.cuda_mjhmc_mm_run(*args, 1, 1, fixed_uniform=True, variant=body)
    r = cm.run_reference(*args, 1, 1, True, variant=body)
    check(torch.equal(k.x, st[0]) and torch.equal(r.x, st[0]), "eps 0: x must stay")
    u_rel = float(((k.u - r.u).abs() / r.u.abs().clamp(min=1e-30)).max())
    g_rel = float(((k.grad - r.grad).abs() / (r.grad.abs() + 1e-4 * r.grad.abs().max())).max())
    return u_rel, g_rel


def any_mm_perturbations(bf16):
    """The perturbed plain runs of phase 43, as (x moved one ulp toward,
    ε moved one ulp toward, depth slices of the contractions): x and ε up
    and down and, at the bf16 precisions, the contractions in halves and
    quarters of their depth."""
    inf = float("inf")
    return ([(to, None, 1) for to in (inf, -inf)] + [(None, to, 1) for to in (inf, -inf)]
            + ([(None, None, 2), (None, None, 4)] if bf16 else []))


def any_mm_plain(cm, spec, st, seed, eps, beta, iters, m, fixed, x_to=None, e_to=None,
                 parts=1, **kw):
    """The plain stream of phase 43 from ``st``, perturbed as
    ``any_mm_perturbations`` describes (none by default)."""
    x0 = st[0] if x_to is None else torch.nextafter(st[0], torch.full_like(st[0], x_to))
    e = eps if e_to is None else float(torch.nextafter(torch.tensor(eps), torch.tensor(e_to)))
    with split_depth(cm, parts) if parts > 1 else contextlib.nullcontext():
        return cm.stream_reference(spec, x0, *st[1:], seed, e, beta, iters, 1, m, fixed, **kw)


def any_mm_deep_plain(label, arrays, eps, x_to, e_to, parts):
    """One plain run of an ANY_MM_DEEP_NUTS case on the CPU, a worker
    process's job: from the NumPy start ``arrays``, perturbed as
    ``any_mm_plain``. Returns (xs, es, RunOut's fields) as NumPy arrays."""
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    torch.set_num_threads(1)
    spec = cm.energy_spec_for(any_mm_dists()[label][0])
    st = [torch.from_numpy(a) for a in arrays]
    xs, _, es, r = any_mm_plain(cm, spec, st, 7, eps, 0.0, 1, CLI_NUTS_DEPTH, True, x_to, e_to,
                                parts, variant="nuts")
    return xs.numpy(), es.numpy(), tuple(t.numpy() for t in r)


def start_any_mm_deep(cm):
    """Phase 43's ANY_MM_DEEP_NUTS cases, each NUTS instance at its spec's
    JAX default precision: their starts (ANY_MM_DEEP_CHAINS chains, seed 1)
    and, in a pool of ANY_MM_DEEP_WORKERS processes on the CPU, their plain
    runs and every perturbed one (used only where a count passes its limit,
    as phase 43's others are made). Returns (the pool, {(label, precision,
    "nuts"): (start, {(x toward, ε toward, depth slices): future})}), the
    unperturbed run's key (None, None, 1)."""
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        ANY_MM_DEEP_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    out = {}
    for label, dist, spec, body, eps, _ in any_mm_cases(cm):
        if (body != "nuts" or label not in ANY_MM_DEEP_NUTS
                or spec.precision != cm.energy_spec_for(dist).precision):
            continue
        st = initial_state(dist, ANY_MM_DEEP_CHAINS, seed=1)
        arrays = tuple(t.cpu().numpy() for t in st)
        runs = [(None, None, 1), *any_mm_perturbations(spec.precision != "highest")]
        out[(label, spec.precision, body)] = (st, {
            key: pool.submit(any_mm_deep_plain, label, arrays, eps, *key) for key in runs})
    return pool, out


def any_mm_checks(cm, card, deep, cases=None, n=ANY_MM_CHAINS, held=ANY_MM_ITERS[0],
                  nuts_depth=ANY_MM_NUTS_DEPTH, name="43 any (d, k)", start=initial_state,
                  deeper=None, philox=True, repeat=False):
    """Phase 43: every on-demand instance, run and stream kernels, against
    its plain version on the card at ANY_MM_CHAINS chains, from v ~ N(0, I):
    first U and the gradient at ε = 0 (``any_mm_energy_check``: U to f32
    rounding, rtol 1e-5, where a padded row's softplus(0) would move it by
    k·ln 2), then ANY_MM_ITERS[0] iterations in fixed-uniform and in Philox
    mode (NUTS at max_depth ANY_MM_NUTS_DEPTH) and, for ``deep``'s NUTS
    instances (``start_any_mm_deep``), one fixed-uniform iteration at
    max_depth CLI_NUTS_DEPTH against the plain runs made on the CPU.
    Fixed-uniform counters and
    stream es exact but for NUTS (as phases 21 and 30). Decisions (counters,
    es, and but for NUTS whether x moved each iteration) equal on all but a
    chains, x, v, g, u and every emitted x within rtol 1e-4 (atol 1e-4 of
    the largest) on all but a of the agreeing chains, where a = 0.1% of the
    chains or as many as the perturbed plain runs change: one-ulp nudges of
    x and ε (up, down) and, at the bf16 precisions, the contractions summed
    in halves and quarters of their depth (phase 30's runs); at the bf16
    precisions the limit carries phase 30's Poisson margin, a + 3√a. The
    perturbed runs are made only where a count passes the limit at a = 0.1%
    (the same pass/fail). Control, MALT and NUTS: w = the iterations, ws =
    1; MJHMC: Σw within rtol 1e-4, or twice the largest change a perturbed
    run makes to it (its relative change, or the root sum of squares of its
    per-chain changes over Σw; phase 30's rule) if more, the perturbed runs
    made where Σw passes 1e-4. Returns {(label, precision, body): (max |dx|
    on the held fixed-uniform chains, U error, gradient error)}. Phase 44
    passes its own ``cases`` (default ``any_mm_cases``), chains ``n``,
    iterations ``held``, NUTS depth, phase ``name`` and ``start`` state
    (default ``initial_state``), ``deeper``: {label: NUTS max_depths}
    held on the card in one more fixed-uniform iteration each, and
    ``philox`` (False: the fixed-uniform mode alone) and ``repeat`` (each
    mode's run launched twice: one hash of every output)."""
    out = {}
    for label, dist, spec, body, eps, m0 in any_mm_cases(cm) if cases is None else cases:
        nuts, mj = body == "nuts", body == "mjhmc"
        bf16 = spec.precision != "highest"
        m, beta = (nuts_depth if nuts else m0), ANY_MM_BETA[body]
        kw = dict(variant=body)
        u_rel, g_rel = any_mm_energy_check(cm, dist, spec, body, n, start)
        check(u_rel <= 1e-5, f"{label} {body} at {spec.precision} ({n} chains, eps 0): U off "
              f"by {u_rel:.3g} relative")
        errs = []
        # (fixed-uniform, seed, M or max_depth, iterations, chains, the plain
        # runs made on the CPU or None)
        modes = [(True, 7, m, held, n, None), (False, 12345, m, held, n, None)][:1 + philox]
        if (label, spec.precision, body) in deep:
            modes.append((True, 7, CLI_NUTS_DEPTH, 1, ANY_MM_DEEP_CHAINS,
                          deep[(label, spec.precision, body)]))
        if nuts:
            modes += [(True, 7, depth, 1, n, None) for depth in (deeper or {}).get(label, ())]
        for i, (fixed, seed, m, iters, nc, on_cpu) in enumerate(modes):
            st = start(dist, nc, seed=1 if fixed else 2) if on_cpu is None else on_cpu[0]
            args = (spec, *st, seed, eps, beta)
            k = cm.cuda_mjhmc_mm_run(*args, iters, m, fixed_uniform=fixed, **kw)
            xs_k, ws_k, es_k, so_k = cm.cuda_mjhmc_mm_stream_run(*args, iters, 1, m,
                                                                 fixed_uniform=fixed, **kw)
            if repeat:  # the sums' order is fixed: a launch repeats bit for bit
                again = cm.cuda_mjhmc_mm_run(*args, iters, m, fixed_uniform=fixed, **kw)
                check(all(torch.equal(a, b) for a, b in zip(k, again)),
                      f"{label} {body} at {spec.precision}: two launches differ")

            def plain(x_to=None, e_to=None, parts=1, st=st, seed=seed, m=m, iters=iters,
                      fixed=fixed, on_cpu=on_cpu):
                if on_cpu is None:
                    return any_mm_plain(cm, spec, st, seed, eps, beta, iters, m, fixed, x_to,
                                        e_to, parts, **kw)
                xs, es, r = on_cpu[1][(x_to, e_to, parts)].result()
                return (torch.from_numpy(xs).to(DEV), None, torch.from_numpy(es).to(DEV),
                        cm.RunOut(*(torch.from_numpy(t).to(DEV) for t in r)))
            xs_r, _, es_r, r = plain()
            moved_r = None if nuts else moves(xs_r, st[0], r.x if mj else None)

            def decisions(run, xs, es, x0):
                same = (run.evals == r.evals) & (es == es_r).all(dim=0)
                if not nuts:
                    same &= (moves(xs, x0, run.x if mj else None) == moved_r).all(dim=0)
                return same

            def agree(run, xs):
                return chains_within(run, r) & stream_within(xs, xs_r)

            same = decisions(k, xs_k, es_k, st[0]) & decisions(so_k, xs_k, es_k, st[0])
            within = agree(k, xs_k) & agree(so_k, xs_k)
            differ, outside = int((~same).sum()), int((same & ~within).sum())

            def limit(a):
                return a + 3 * a**0.5 if bf16 else a
            flips, drift = torch.zeros_like(same), torch.zeros_like(same)
            w_rel = float((k.w.double().sum() - r.w.double().sum()).abs() / r.w.double().sum())
            spread = 0.0
            perturbed = max(differ, outside) > limit(0.001 * nc) or (mj and w_rel > 1e-4)
            if perturbed:
                for x_to, e_to, parts in any_mm_perturbations(bf16):
                    xs_n, _, es_n, r_n = plain(x_to, e_to, parts)
                    x_n = st[0] if x_to is None else torch.nextafter(
                        st[0], torch.full_like(st[0], x_to))
                    same_n = decisions(r_n, xs_n, es_n, x_n)
                    flips |= ~same_n
                    drift |= same_n & ~agree(r_n, xs_n)
                    dw = r_n.w.double() - r.w.double()
                    spread = max(spread, float(dw.square().sum().sqrt() / r.w.double().sum()),
                                 float(dw.sum().abs() / r.w.double().sum()))
            allow_dec = limit(max(0.001 * nc, int(flips.sum())))
            allow_states = limit(max(0.001 * nc, int(drift.sum())))
            mode = "fixed-uniform" if fixed else "Philox"
            what = (f"{label} {body} at {spec.precision} ({nc} chains, eps {eps}, "
                    f"{'max_depth' if nuts else 'M'} {m}, {iters} iterations, {mode}"
                    f"{', the plain version on the CPU' if on_cpu else ''})")
            if fixed and not nuts:
                check(torch.equal(k.evals, r.evals) and torch.equal(es_k, es_r)
                      and torch.equal(es_k[-1], so_k.evals), f"{what}: counters differ")
            check(differ <= allow_dec, f"{what}: decisions differ on {differ} chains, "
                  f"{allow_dec:.4g} allowed")
            check(outside <= allow_states, f"{what}: {outside} chains with equal decisions "
                  f"outside rtol 1e-4, {allow_states:.4g} allowed")
            if mj:
                assert_close(k.w.sum(), r.w.sum(), max(1e-4, 2 * spread), 0.0, f"{what} sum of w")
            else:
                check(bool((k.w == iters).all()) and bool((ws_k == 1).all()), f"{what}: w, ws")
            ok = same & within
            dx = (k.x - r.x).abs()
            err = float(dx[:, ok].max()) if bool(ok.any()) else float(dx.max())
            if fixed:
                errs.append(err)
            phase(name, f"{what}: decisions equal on {1 - differ / nc:.5f} ({differ} "
                  f"differ); x,v,g,u and stream xs rtol 1e-4 on all but {outside} of the others "
                  f"(max|dx| {err:.3g}); "
                  + (f"the perturbed plain runs change {int(flips.sum())} chains' decisions and "
                     f"move {int(drift.sum())} more (limits {allow_dec:.4g}, "
                     f"{allow_states:.4g})" if perturbed else "no perturbed runs needed")
                  + (f"; eps 0: U rtol {u_rel:.3g}, gradient {g_rel:.3g}" if i == 0 else "")
                  + ("; two launches, one hash" if repeat else ""))
        out[(label, spec.precision, body)] = (max(errs), u_rel, g_rel)
    return out


def any_mm_stats(cm, cli, card):
    """Phase 43's statistics at new shapes, through the engines and the
    CLI: JAX's logreg Laplace-variance oracle (tests/test_pallas_engine.py:
    548-557: ε 0.25, β 0.15, M 10, 2,048 chains, 400 + 1,500, median ratio
    within 0.25) at (16, 64) and (7, 100); JAX's sparse-coding check
    (:340-370: dwell mass within 5% and the median dwell-weighted variance
    ratio within 0.15 of the plain MJHMC sampler; ε 0.02, β 0.1, M 5, 2,048
    chains, 400 + 600) at (96, 64); and ``sample --config logreg`` with the
    config's model at (16, 64). Returns {key: (run, stream) launches,
    counted from 0 just before}."""
    from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
    from mjhmc_tpu_torch.samplers import MarkovJumpHMC

    dists = any_mm_dists()
    launches = {}
    for label in ("logreg 16x64", "logreg 7x100"):
        dist = dists[label][0]
        cm.reset_counts()
        t0 = time.perf_counter()
        eng = cm.CudaMJHMC(dist, epsilon=0.25, beta=0.15, num_leapfrog_steps=10, nbatch=2048,
                           seed=0, device=DEV)
        eng.run(400)
        out = eng.run(1500)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches[f"{label} laplace"] = counts(cm, "launches", mm=True)
        ratio = (cm.CudaMJHMC.moments(out)[1].double().cpu()
                 / torch.as_tensor(dist.laplace_var(), dtype=torch.float64))
        med = float(ratio.median())
        check(launches[f"{label} laplace"][0] > 0 and abs(med - 1) < 0.25,
              f"{label}: median var/Laplace {med}")
        phase("43 any (d, k) stats", f"CudaMJHMC {label} at {eng.spec.precision} (2,048 chains, "
              f"eps 0.25, beta 0.15, M 10, 400 + 1500): median var/Laplace {med:.5f} (0.25), "
              f"in [{float(ratio.min()):.4f}, {float(ratio.max()):.4f}]; launches "
              f"{launches[f'{label} laplace']}; {sec:.3g} s host clock [{card}]")

    dist = dists["sparse_coding 96x64"][0]
    cm.reset_counts()
    t0 = time.perf_counter()
    eng = cm.CudaMJHMC(dist, epsilon=0.02, beta=0.1, num_leapfrog_steps=5, nbatch=2048, seed=0,
                       device=DEV)
    eng.run(400)
    out = eng.run(600)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches["sparse_coding 96x64 moments"] = counts(cm, "launches", mm=True)
    dwell_p = float(out.w.double().sum()) / (eng.nbatch * 600)
    var_p = cm.CudaMJHMC.moments(out)[1].double().cpu()
    t0 = time.perf_counter()
    ref = MarkovJumpHMC(dist, epsilon=0.02, beta=0.1, num_leapfrog_steps=5, nbatch=2048, seed=1,
                        device=DEV)
    ref.burn_in(400)
    rout = ref.sample(600)
    plain_s = time.perf_counter() - t0
    w = rout["dwell"].double()[:, None, :]
    xs = rout["x"].double()
    mean_x = (w * xs).sum(dim=(0, 2)) / w.sum()
    var_x = ((w * xs**2).sum(dim=(0, 2)) / w.sum() - mean_x**2).cpu()
    dwell_x = float(rout["dwell"].double().mean())
    med = float((var_p / var_x).median())
    check(abs(dwell_p - dwell_x) < 0.05 * dwell_x and abs(med - 1) < 0.15,
          f"sparse_coding 96x64: dwell {dwell_p} vs {dwell_x}, median var ratio {med}")
    phase("43 any (d, k) stats", f"CudaMJHMC sparse_coding 96x64 at {eng.spec.precision} (2,048 "
          f"chains, eps 0.02, beta 0.1, M 5, 400 + 600) against the plain MarkovJumpHMC: dwell "
          f"{dwell_p:.5f} vs {dwell_x:.5f} (5%), median var ratio {med:.5f} (0.15); launches "
          f"{launches['sparse_coding 96x64 moments']}; engine {sec:.3g} s, plain sampler "
          f"{plain_s:.3g} s host clock [{card}]")

    cfg = BENCHMARK_CONFIGS["logreg"]
    BENCHMARK_CONFIGS["logreg"] = dataclasses.replace(
        cfg, dist_kwargs=(("ndims", 16), ("nobs", 64)))
    try:
        cm.reset_counts()
        rec, cl, sec = run_cli(cli, ["sample", "--config", "logreg", "--engine", "cuda",
                                     "--burn", "200", "--steps", "400"],
                               {"mm_run": cm.cuda_mjhmc_mm_run,
                                "mm_stream": cm.cuda_mjhmc_mm_stream_run})
    finally:
        BENCHMARK_CONFIGS["logreg"] = cfg
    launches["cli logreg 16x64"] = (cl["mm_run"], cl["mm_stream"])
    check(cl["mm_run"] > 0 and cl["mm_stream"] > 0 and rec["chains"] == cfg.nbatch
          and rec["grad_evals"] >= cfg.num_leapfrog_steps * 600 * cfg.nbatch
          and all(v > 0 and v == v for v in rec["var"]),
          f"sample --config logreg at (16, 64): {rec}, launches {cl}")
    phase("43 any (d, k) stats", f"sample --config logreg with LogisticRegression(ndims=16, "
          f"nobs=64): {json.dumps(rec)}; launches {cl}; {sec:.4g} s host clock [{card}]")
    return launches


def any_mm_timing(cm, card, cases=None, n=ANY_MM_CHAINS, iters=ANY_MM_ITERS[1],
                  nuts_depth=ANY_MM_NUTS_DEPTH, name="43 any (d, k) timing", start=None):
    """Phase 43: ms an iteration (CUDA events) of every on-demand instance,
    run and stream, through the engines at ANY_MM_CHAINS chains and the
    shape's ε and M (NUTS at max_depth ANY_MM_NUTS_DEPTH: at the CLI's 8 the
    plain NUTS took ~28 s of the phase), beside the plain version (one
    iteration); each engine's launches counted from 0 just before it. Phase 44 passes its own ``cases``, chains, iterations, NUTS
    depth, phase ``name`` and ``start`` state (the engines then start
    there; default their own init and ``initial_state``).
    Returns {(label, precision, body): (run ms, stream ms, plain run ms,
    plain stream ms, gradients, iterations, chains, (run, stream)
    launches)}."""
    rows = {}
    ecls = {"nuts": cm.CudaNUTS, "mjhmc": cm.CudaMJHMC, "control": cm.CudaControlHMC,
            "malt": cm.CudaMALT}
    for label, dist, spec, body, eps, m0 in any_mm_cases(cm) if cases is None else cases:
        nuts = body == "nuts"
        m, beta = (nuts_depth if nuts else m0), ANY_MM_BETA[body]
        cm.reset_counts()
        eng = ecls[body](dist, epsilon=eps, beta=beta, num_leapfrog_steps=m, nbatch=n, seed=4,
                         device=DEV)
        eng.spec = spec
        if start is not None:
            eng.x, eng.v, eng.g, eng.u = start(dist, n, seed=4)[:4]
        eng.run(2)
        before = eng.grad_evals
        run_ms = events_ms(lambda: eng.run(iters)) / iters
        grads = eng.grad_evals - before
        stream_ms = events_ms(lambda: eng.sample(iters)) / iters
        launches = counts(cm, "launches" if body == "mjhmc" else f"{body}_launches", mm=True)
        check(all(v > 0 for v in launches), f"{label} {body}: kernels not launched")
        args = (spec, *(start or initial_state)(dist, n, seed=5), 99, eps, beta)
        pkw = dict(variant=body)
        plain_ms = events_ms(lambda: cm.run_reference(*args, 1, m, **pkw))
        plain_stream_ms = events_ms(lambda: cm.stream_reference(*args, 1, 1, m, **pkw))
        rows[(label, spec.precision, body)] = (run_ms, stream_ms, plain_ms, plain_stream_ms,
                                               grads, iters, n, launches)
        phase(name, f"{body} {label} at {spec.precision} ({n} chains, eps "
              f"{eps}, beta {beta}, {'max_depth' if nuts else 'M'} {m}): run {run_ms:.6g} "
              f"ms/iteration, stream (thin 1) {stream_ms:.6g}; plain version run "
              f"{plain_ms:.6g}, stream {plain_stream_ms:.6g} ms/iteration; "
              f"{grads / (n * iters):.5g} {'leaves' if nuts else 'gradients'} per chain and "
              f"iteration [{card}]")
    return rows


def any_mm_entries(cm, entry, errs, rows, seconds, instances):
    """The kernels line's entries of phase 43: every on-demand matmul
    instance, run and stream; launches and times from phase 43's engines,
    errors from its fixed-uniform checks, its library's nvcc seconds in this
    run (null where it was built before and reused)."""
    from mjhmc_tpu_torch.bench_mfu import PASSES

    out = []
    variants = {"nuts": NUTS_VARIANT, "mjhmc": MJHMC_VARIANT, "control": CONTROL_VARIANT,
                "malt": MALT_VARIANT}
    for label, _, spec, body, _, _ in any_mm_cases(cm):
        key = (label, spec.precision, body)
        run_ms, stream_ms, plain_ms, plain_stream_ms, grads, iters, n, launches = rows[key]
        cname = label.split()[0]
        d, k = cm.mm_shape(spec)
        err, u_rel, g_rel = errs[key]
        for idx, (suffix, src) in enumerate((("run", MM_RUN_SRC), ("stream", MM_STREAM_SRC))):
            stream = idx == 1
            out.append(entry(
                f"{body}_mm_{suffix}[{label}, {spec.precision}]", MM_ONDEMAND_SRC, src,
                launches[idx], err, stream_ms if stream else run_ms,
                plain_stream_ms if stream else plain_ms,
                bound(cname, body, d, k, n, iters, grads, iters if stream else 0,
                      passes=PASSES.get(spec.precision, 0)),
                variant=variants[body], energy=MM_ENERGIES[cname], precision=spec.precision,
                instance="on demand", nvcc_s=seconds[instances[key]],
                parameter_matrix="device memory"
                if "-DMJHMC_MM_OD_OFFCHIP=1" in instances[key].macros else "shared memory", u_rel_err=u_rel, grad_rel_err=g_rel,
                shape=f"{label}, {n} chains, "
                      f"{f'max_depth {ANY_MM_NUTS_DEPTH}' if body == 'nuts' else 'its eps and M'}"
                      f"{', thin 1' if stream else ''}, ms per iteration"))
    return out


def any_mm_phase(cm, cli, _build, card, done, stats):
    """Phase 43: the on-demand matmul instances' builds (``done``, phase
    2's), tiles, every instance against its plain version, the timings; the
    statistics at new shapes (``any_mm_stats``) ran beside phase 39
    (``stats``: their launches and seconds). Returns (errors, timing rows,
    nvcc seconds, instances, the statistics' launches)."""
    t0 = time.perf_counter()
    pool, deep = start_any_mm_deep(cm)
    try:
        seconds = any_mm_builds(_build, done, card)
        any_mm_tiles(cm, card)
        errs = any_mm_checks(cm, card, deep)
    finally:
        pool.shutdown(cancel_futures=True)
        stop_children()  # the spawn pool's resource tracker
    t_checks = time.perf_counter()
    rows = any_mm_timing(cm, card)
    phase("43 any (d, k)", f"phase 43 took {time.perf_counter() - t0:.4g} s: the checks "
          f"{t_checks - t0:.4g}, the timings {time.perf_counter() - t_checks:.4g}; the "
          f"statistics {stats['seconds']:.4g} s beside phase 39, their launches "
          f"{json.dumps(stats['launches'])} [{card}]")
    return errs, rows, seconds, any_mm_instances(cm, _build), stats["launches"]


# ---- phase 44: the matmul engine past one block's shared memory -------------
#: the slice's configurations, label "<config> <d>x<k>" -> (model, its
#: arguments, chains, ε or None, M, NUTS max_depths held beyond
#: PAST_NUTS_DEPTH, NUTS iterations held): logistic regression at LIBSVM a9a's shape (32,561
#: observations, 123 features and an intercept; the repo's seeded synthetic
#: data, nothing downloaded) at the logreg preset's 2,048 chains, ε a quarter
#: of the smallest Laplace standard deviation (``past_eps``); sparse coding on
#: 32 × 32 patches with a 4× overcomplete dictionary (the seeded Gabor bank:
#: no learned Φ exists at this shape) at 1,024 chains, ε from its stiffest
#: frequency ω = σ⁻¹·√λmax(ΦᵀΦ) = 210.9 (ε·ω ≤ 1.4). Both at their specs'
#: JAX default precisions (logreg "default", sparse coding "bf16x3"); the
#: first chunks the k rows with X and G on chip, the second moves X, G and
#: the mass to the device buffer too (the tile rule's xg). Sparse coding's
#: NUTS holds one fixed-uniform iteration: its plain version sums 4,096 dims
#: one row at a time (the kernels' order), ~7.5 s an iteration at max_depth 4
PAST_SHAPES = {
    "logreg 124x32561": ("LogisticRegression", dict(ndims=124, nobs=32561), 2048, None, 10,
                         (8,), 2),
    "sparse_coding 4096x1024": ("SparseCoding",
                                dict(npixels=1024, nbasis=4096, phi_source="gabor"), 1024,
                                0.006, 5, (), 1),
}
PAST_NUTS_DEPTH = 4
#: a split tile at a precision with lo fragments, held one iteration beside
#: the cases above: a9a's control at "bf16x3" (32 columns, split over a
#: cluster at 2,048 chains; its B fragments hi and lo, its A fragments' lo
#: copy in every stage)
PAST_SPLIT = ("logreg 124x32561", "bf16x3", "control")
#: (iterations held, iterations timed) of phase 44
PAST_ITERS = (2, 10)
#: the a9a-shape Laplace oracle (JAX's, tests/test_pallas_engine.py:548-557,
#: at this shape's ε: β 0.15, M 10, 2,048 chains, median var/Laplace within
#: 0.25) and the sparse-coding moments check (phase 43's: dwell within 5% and
#: the median variance ratio within 0.15 of the plain MarkovJumpHMC), as
#: (burn-in, samples) each
PAST_LAPLACE_ITERS = (300, 400)
PAST_MOMENTS_ITERS = (60, 120)
#: the learner on the card at its defaults (400 steps, batch 256) ends within
#: this of the shipped Φ's final reconstruction error (0.27176, from JAX's
#: draws): three CPU seeds of the port's learner end at 0.2691-0.2798 after
#: 100 steps and 0.2718-0.2740 after 400 (PERF.md §6), so 0.02 is about twice
#: the spread at a quarter of the steps
LEARNER_TOL = 0.02


@functools.lru_cache(maxsize=None)
def past_dist(label):
    from mjhmc_tpu_torch import models

    name, kw = PAST_SHAPES[label][:2]
    return getattr(models, name)(**kw)


@functools.lru_cache(maxsize=None)
def past_laplace(label):
    """(MAP, Laplace variances) of a logreg configuration, NumPy float64."""
    dist = past_dist(label)
    return dist.map_estimate(), dist.laplace_var()


def past_eps(label):
    """The configuration's ε: logreg a quarter of the smallest Laplace
    standard deviation (0.0396 at a9a's shape), else PAST_SHAPES's."""
    eps = PAST_SHAPES[label][3]
    return eps if eps is not None else round(0.25 * math.sqrt(past_laplace(label)[1].min()), 4)


def past_state(dist, n, seed, inv_mass=None):
    """A start in the posterior's bulk for logreg (the MAP plus N(0, the
    Laplace variances), so the held iterations run where the sampler does),
    else ``initial_state``."""
    from mjhmc_tpu_torch.models import LogisticRegression

    if not isinstance(dist, LogisticRegression):
        return initial_state(dist, n, seed, inv_mass)
    import numpy as np

    label = next(lab for lab in PAST_SHAPES if past_dist(lab) == dist)
    theta, var = past_laplace(label)
    rng = np.random.default_rng(seed)
    x = theta[:, None] + np.sqrt(var)[:, None] * rng.standard_normal((dist.ndims, n))
    x = torch.as_tensor(x, dtype=torch.float32, device=DEV).contiguous()
    v = torch.as_tensor(rng.standard_normal((dist.ndims, n)), dtype=torch.float32, device=DEV)
    u, g = dist.potential_and_grad(x)
    z = torch.zeros(n, device=DEV)
    return x, v, g.contiguous(), u.contiguous(), z, z.clone()


def past_cases(cm):
    """(label, distribution, spec, body, ε, M) of phase 44: the four bodies
    at each configuration at its spec's JAX default precision."""
    out = []
    for label, (_, _, _, _, m, _, _) in PAST_SHAPES.items():
        dist = past_dist(label)
        for body in ZOO_BODIES:
            out.append((label, dist, cm.energy_spec_for(dist), body, past_eps(label), m))
    return out


def past_split_case(cm):
    """PAST_SPLIT as a ``past_cases`` entry."""
    label, precision, body = PAST_SPLIT
    dist = past_dist(label)
    spec = dataclasses.replace(cm.energy_spec_for(dist), precision=precision)
    return label, dist, spec, body, past_eps(label), PAST_SHAPES[label][4]


def past_instances(cm, _build):
    """{(label, precision, body): the on-demand instance} of phase 44 and
    PAST_SPLIT's: every one chunked (and xg at sparse coding), none compiled
    ahead (a9a's NUTS instance also runs ``past_deep_check``'s tree past
    12)."""
    out = {}
    for label, _, spec, body, _, _ in [*past_cases(cm), past_split_case(cm)]:
        check(not cm.mm_compiled_ahead(spec, sweep_run=False), f"{label} is in the library")
        rule = cm.nuts_mm_tile_rule(spec) if body == "nuts" else cm.mm_tile_rule(spec, body)
        check(rule.off and rule.chunk > 0 and rule.xg_off == label.startswith("sparse"),
              f"{label} {body}: tile {rule}")
        out[(label, spec.precision, body)] = _build.mm_instance(
            cm.KERNEL_VARIANTS[body], spec.energy_id, *cm.mm_shape(spec),
            cm.PRECISIONS.index(spec.precision), rule.off, rule.chunk, rule.xg_off)
    return out


def past_deep_plain(arrays, seed, eps, depth, nudge=0.0):
    """One plain run of ``past_deep_check``'s case on the card, a worker
    process's job: ``arrays`` the (x, v, g, u, h_back, valid) NumPy start,
    x moved one ulp toward ``nudge`` (±inf) where it is not 0. Returns
    (RunOut's fields as NumPy arrays, host ms of the synchronised run)."""
    from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

    torch.set_num_threads(1)
    spec = cm.energy_spec_for(past_dist("logreg 124x32561"))
    st = [torch.from_numpy(a).to(DEV) for a in arrays]
    if nudge:
        st[0] = torch.nextafter(st[0], torch.full_like(st[0], nudge))
    t0 = time.perf_counter()
    r = cm.run_reference(spec, *st, seed, eps, 0.0, 1, depth, variant="nuts")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return tuple(t.cpu().numpy() for t in r), ms


def start_past_deep(cm):
    """Phase 44 past the tile depth, its plain runs: CudaNUTS at a9a's shape
    (its chunked tile) at PAST_DEEP_DEPTH and PAST_DEEP_EPS, one tile of
    chains, one iteration from the posterior's bulk (``past_state``). The
    plain run and the two one-ulp-nudged ones (a few ms of host time a leaf,
    8,191 leaves) start at once, each in a process of its own on the card,
    to run beside phase 44's checks, statistics and learner; no kernel is
    timed beside them. Returns what ``past_deep_check`` takes: the engine,
    its start and seed, the pool and the runs."""
    import multiprocessing

    dist = past_dist("logreg 124x32561")
    n = cm.nuts_mm_tile_rule(cm.energy_spec_for(dist)).chains
    eng = cm.CudaNUTS(dist, epsilon=PAST_DEEP_EPS, num_leapfrog_steps=PAST_DEEP_DEPTH, nbatch=n,
                      seed=11, device=DEV)
    eng.x, eng.v, eng.g, eng.u, eng.h_back, eng.back_valid = past_state(dist, n, seed=5)
    st = tuple(t.clone() for t in (eng.x, eng.v, eng.g, eng.u, eng.h_back, eng.back_valid))
    gen = torch.Generator()
    gen.set_state(eng._seed_gen.get_state())
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen))
    arrays = tuple(t.cpu().numpy() for t in st)
    pool = concurrent.futures.ProcessPoolExecutor(
        3, mp_context=multiprocessing.get_context("spawn"))
    runs = [pool.submit(past_deep_plain, arrays, seed, PAST_DEEP_EPS, PAST_DEEP_DEPTH, to)
            for to in (0.0, math.inf, -math.inf)]
    return dict(eng=eng, seed=seed, pool=pool, runs=runs, t0=time.perf_counter())


def past_deep_check(cm, card, started):
    """Phase 44 past the tile depth, held: ``start_past_deep``'s plain runs
    awaited, then the engine's launch (its chunked tile's DEEP instance)
    timed alone, against the plain run from the same state and
    seed, with phase 21's allowances (leaf counts equal on all but 0.1% of
    the chains, or as many as one-ulp nudges of x change in the plain
    version alone; x, v, g, u within rtol 1e-4 on those, all but 0.1% or as
    many as the nudges move; the nudged runs read only where the counts or
    states pass 0.1% of the chains). Fails unless some tree began round
    PAST_DEEP_DEPTH. The engine's call is the main path: the counts from 0
    just before, read just after. Returns the kernels line's numbers."""
    from mjhmc_tpu_torch.bench_mfu import PASSES

    t0 = time.perf_counter()
    label = "logreg 124x32561"
    eng, seed = started["eng"], started["seed"]
    spec = eng.spec
    rule = cm.nuts_mm_tile_rule(spec)
    n, depth, eps = rule.chains, PAST_DEEP_DEPTH, PAST_DEEP_EPS
    tiles = {}
    for dd in (13, 14, 31):  # the tile past 12 against the mirror
        got = cm.nuts_mm_tile(spec, dd)
        want = (rule.chains, rule.threads, cm.nuts_mm_smem_bytes(spec, dd))
        check(got[:3] == want and got[3] >= 1, f"NUTS tile of {label} at max_depth {dd}: "
              f"the instance's {got}, the mirror's {want}")
        tiles[dd] = got
    with started["pool"]:
        (r, plain_ms), *nudged = (f.result() for f in started["runs"])
    stop_children()  # the spawn pool's resource tracker
    t_plain = time.perf_counter()
    got = {}
    cm.reset_counts()
    ms = events_ms(lambda: got.update(o=eng.run(1)))
    launched = cm.cuda_mjhmc_mm_run.deep_nuts_launches
    check(launched == 1, f"CudaNUTS {label} max_depth {depth}: {launched} launches past "
          "max_depth 10")
    k = got["o"]
    r = cm.RunOut(*(torch.from_numpy(t).to(DEV) for t in r))
    same = k.evals == r.evals
    within = chains_within(k, r)
    differ, outside = int((~same).sum()), int((same & ~within).sum())
    flips, drift = torch.zeros_like(same), torch.zeros_like(same)
    nudges_run = max(differ, outside) > 0.001 * n
    for r_n, _ in nudged if nudges_run else ():
        r_n = cm.RunOut(*(torch.from_numpy(t).to(DEV) for t in r_n))
        same_n = r_n.evals == r.evals
        flips |= ~same_n
        drift |= same_n & ~chains_within(r_n, r)
    what = f"CudaNUTS {label} at {spec.precision} ({n} chains, eps {eps}, max_depth {depth})"
    allow_counts = max(0.001 * n, int(flips.sum()))
    allow_states = max(0.001 * n, int(drift.sum()))
    check(differ <= allow_counts, f"{what}: leaf counts differ on {differ} chains, "
          f"{allow_counts:g} allowed")
    check(outside <= allow_states, f"{what}: {outside} chains with equal counts outside rtol "
          f"1e-4, {allow_states:g} allowed")
    began = float((r.evals >= 2**(depth - 1)).double().mean())
    cap = float((r.evals == 2**depth - 1).double().mean())
    check(began > 0, f"{what}: no tree began round {depth}: the deepest rounds went untested")
    ok = same & within
    dx = (k.x - r.x).abs()
    err = float(dx[:, ok].max()) if bool(ok.any()) else float(dx.max())
    d, kk = cm.mm_shape(spec)
    bnd = bound("logreg", "nuts", d, kk, n, 1, int(r.evals.sum()),
                passes=PASSES.get(spec.precision, 0))
    phase("44 past one block", f"{what}, run, 1 iteration, {float(r.evals.double().mean()):.5g} "
          f"leaves a chain: leaf counts equal on {1 - differ / n:.5f} of chains; x,v,g,u rtol "
          f"1e-4 on all but {outside} of those (max|dx| {err:.3g}); "
          + (f"one-ulp nudges of x change {int(flips.sum())} chains' counts and move "
             f"{int(drift.sum())} more past rtol 1e-4 in the plain version alone; "
             if nudges_run else "the nudged runs not needed (within 0.1%); ")
          + f"trees that began round {depth} {began:.4f}, ran the {2**depth - 1}-leaf cap "
          f"{cap:.4f}; kernel {ms:.6g} ms, plain version {plain_ms:.6g} ms (host clock, "
          f"beside the two nudged runs and phase 44's checks, statistics and learner), bound "
          f"{bnd[0]:.4g} ms ({bnd[1]}); the tile at max_depth 13/14/31 (chains, threads, "
          f"shared bytes, blocks an SM) = mirror: {json.dumps(tiles)}; the plain runs took "
          f"{t_plain - started['t0']:.3g} s from their start, {t_plain - t0:.3g} s of it "
          f"awaited here, the rest {time.perf_counter() - t_plain:.3g} s [{card}]")
    return dict(launches=launched, err=err, ms=ms, plain_ms=plain_ms, bound=bnd, n=n, eps=eps,
                precision=spec.precision, leaves=float(r.evals.double().mean()))


def learner_row(card):
    """The dictionary learner on the card at its defaults (400 steps, batch
    256; ``python -m mjhmc_tpu_torch.models.dictionary_learning --out TMP``):
    its error falls below 0.8× the first step's, Φ's columns are unit-norm,
    and its last error is within LEARNER_TOL of the shipped Φ's. Returns its
    seconds (host clock, the write included)."""
    import tempfile

    import numpy as np

    from mjhmc_tpu_torch.models import dictionary_learning as dl

    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = dl.main(["--out", tmp])
        sec = time.perf_counter() - t0
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        with np.load(rec["path"]) as art:
            norms = np.linalg.norm(art["phi"], axis=0)
            shape = art["phi"].shape
        with np.load(dl._phi_path(64, 128)) as shipped:
            ship_err = float(shipped["meta_final_recon_err"])
    first, last = rec["recon_err_first"], rec["recon_err_last"]
    check(rc == 0 and rec["device"] == "cuda" and shape == (64, 128) and last < 0.8 * first
          and float(np.abs(norms - 1).max()) < 1e-4 and abs(last - ship_err) <= LEARNER_TOL,
          f"the learner on the card: {rec}, column norms in [{norms.min()}, {norms.max()}], "
          f"the shipped Φ's last error {ship_err}")
    phase("44 past one block", f"dictionary_learning --out TMP (64 x 128, 400 steps, batch 256) "
          f"on the card: {sec:.4g} s host clock; error {first:.5f} -> {last:.5f} (below 0.8x; "
          f"the shipped Φ's {ship_err:.5f}, within {LEARNER_TOL}); active share "
          f"{rec['code_l0_last']:.4f}; column norms within {float(np.abs(norms - 1).max()):.2g} "
          f"of 1 [{card}]")
    return sec


def past_stats(cm, card):
    """Phase 44's statistics (beside a9a's deep plain runs, not beside
    phase 39): JAX's
    logreg Laplace oracle at a9a's shape (CudaMJHMC from the model's init, ε
    from the Laplace variances, β 0.15, M 10, 2,048 chains,
    PAST_LAPLACE_ITERS; median var/Laplace within 0.25) and phase 43's
    sparse-coding moments check at 1,024 × 4,096 (1,024 chains, ε 0.006, β
    0.1, M 5, PAST_MOMENTS_ITERS; dwell within 5% and the median variance
    ratio within 0.15 of the plain MarkovJumpHMC). Returns {key: (run,
    stream) launches, counted from 0 just before}."""
    from mjhmc_tpu_torch.samplers import MarkovJumpHMC

    launches = {}
    label = "logreg 124x32561"
    dist, eps, (burn, keep) = past_dist(label), past_eps(label), PAST_LAPLACE_ITERS
    cm.reset_counts()
    t0 = time.perf_counter()
    eng = cm.CudaMJHMC(dist, epsilon=eps, beta=0.15, num_leapfrog_steps=10, nbatch=2048, seed=0,
                       device=DEV)
    eng.run(burn)
    out = eng.run(keep)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches[f"{label} laplace"] = counts(cm, "launches", mm=True)
    ratio = (cm.CudaMJHMC.moments(out)[1].double().cpu()
             / torch.as_tensor(past_laplace(label)[1].copy(), dtype=torch.float64))
    med = float(ratio.median())
    check(launches[f"{label} laplace"][0] > 0 and abs(med - 1) < 0.25,
          f"{label}: median var/Laplace {med}")
    phase("44 past one block stats", f"CudaMJHMC {label} at {eng.spec.precision} (2,048 chains, "
          f"eps {eps}, beta 0.15, M 10, {burn} + {keep} from the model's init): median "
          f"var/Laplace {med:.5f} (0.25), in [{float(ratio.min()):.4f}, "
          f"{float(ratio.max()):.4f}]; launches {launches[f'{label} laplace']}; {sec:.3g} s "
          f"host clock [{card}]")

    label = "sparse_coding 4096x1024"
    dist, eps, (burn, keep) = past_dist(label), past_eps(label), PAST_MOMENTS_ITERS
    n = PAST_SHAPES[label][2]
    cm.reset_counts()
    t0 = time.perf_counter()
    eng = cm.CudaMJHMC(dist, epsilon=eps, beta=0.1, num_leapfrog_steps=5, nbatch=n, seed=0,
                       device=DEV)
    eng.run(burn)
    out = eng.run(keep)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches[f"{label} moments"] = counts(cm, "launches", mm=True)
    dwell_p = float(out.w.double().sum()) / (eng.nbatch * keep)
    var_p = cm.CudaMJHMC.moments(out)[1].double().cpu()
    t0 = time.perf_counter()
    ref = MarkovJumpHMC(dist, epsilon=eps, beta=0.1, num_leapfrog_steps=5, nbatch=n, seed=1,
                        device=DEV)
    ref.burn_in(burn)
    rout = ref.sample(keep)
    plain_s = time.perf_counter() - t0
    w = rout["dwell"].double()[:, None, :]
    xs = rout["x"].double()
    mean_x = (w * xs).sum(dim=(0, 2)) / w.sum()
    var_x = ((w * xs**2).sum(dim=(0, 2)) / w.sum() - mean_x**2).cpu()
    dwell_x = float(rout["dwell"].double().mean())
    med = float((var_p / var_x).median())
    check(abs(dwell_p - dwell_x) < 0.05 * dwell_x and abs(med - 1) < 0.15,
          f"{label}: dwell {dwell_p} vs {dwell_x}, median var ratio {med}")
    phase("44 past one block stats", f"CudaMJHMC {label} at {eng.spec.precision} ({n:,} chains, "
          f"eps {eps}, beta 0.1, M 5, {burn} + {keep}) against the plain MarkovJumpHMC: dwell "
          f"{dwell_p:.5f} vs {dwell_x:.5f} (5%), median var ratio {med:.5f} (0.15); launches "
          f"{launches[f'{label} moments']}; engine {sec:.3g} s, plain sampler {plain_s:.3g} s "
          f"host clock [{card}]")
    return launches


def past_entries(cm, entry, errs, rows, seconds, instances):
    """The kernels line's entries of phase 44: every instance, run and
    stream; launches and times from phase 44's engines, errors from its
    fixed-uniform checks, nvcc seconds (null where reused)."""
    from mjhmc_tpu_torch.bench_mfu import PASSES

    out = []
    variants = {"nuts": NUTS_VARIANT, "mjhmc": MJHMC_VARIANT, "control": CONTROL_VARIANT,
                "malt": MALT_VARIANT}
    for label, _, spec, body, _, _ in past_cases(cm):
        key = (label, spec.precision, body)
        run_ms, stream_ms, plain_ms, plain_stream_ms, grads, iters, n, launches = rows[key]
        cname = label.split()[0]
        d, k = cm.mm_shape(spec)
        err, u_rel, g_rel = errs[key]
        rule = cm.nuts_mm_tile_rule(spec) if body == "nuts" else cm.mm_tile_rule(spec, body)
        for idx, (suffix, src) in enumerate((("run", MM_RUN_SRC), ("stream", MM_STREAM_SRC))):
            stream = idx == 1
            out.append(entry(
                f"{body}_mm_{suffix}[{label}, {spec.precision}]", MM_ONDEMAND_SRC, src,
                launches[idx], err, stream_ms if stream else run_ms,
                plain_stream_ms if stream else plain_ms,
                bound(cname, body, d, k, n, iters, grads, iters if stream else 0,
                      passes=PASSES.get(spec.precision, 0)),
                variant=variants[body], energy=MM_ENERGIES[cname], precision=spec.precision,
                instance="on demand", nvcc_s=seconds[instances[key]],
                parameter_matrix="device memory", chunk_rows=rule.chunk,
                x_and_g="device memory" if rule.xg_off else "shared memory",
                u_rel_err=u_rel, grad_rel_err=g_rel,
                shape=f"{label}, {n} chains, "
                      f"{f'max_depth {PAST_NUTS_DEPTH}' if body == 'nuts' else 'its eps and M'}"
                      f"{', thin 1' if stream else ''}, ms per iteration"))
    return out


def past_phase(cm, _build, card, done):
    """Phase 44: the chunked instances' builds (``done``, phase 2's), their
    tiles against the mirror, every instance against its plain version at
    the configurations' widths (``any_mm_checks`` with phase 43's
    allowances, from ``past_state``; NUTS at max_depth 4, logreg also at 8),
    the timings (first, alone on the card), the statistics (``past_stats``;
    not beside phase 39: their kernels slowed its rows) and the learner, and
    a9a's tree past the tile depth, whose plain runs (``start_past_deep``)
    run beside the checks, the statistics and the learner. Returns (errors,
    timing rows, nvcc seconds, instances, the statistics' launches, the
    tree past the tile depth's numbers)."""
    t0 = time.perf_counter()
    cases = past_cases(cm)
    seconds = any_mm_builds(_build, done, card, "44 past one block")
    split = past_split_case(cm)
    any_mm_tiles(cm, card, [*cases, split], "44 past one block",
                 {label: spec[2] for label, spec in PAST_SHAPES.items()})
    deeper = {label: spec[5] for label, spec in PAST_SHAPES.items()}
    rows = {}
    for label in PAST_SHAPES:
        rows.update(any_mm_timing(cm, card, [c for c in cases if c[0] == label],
                                  PAST_SHAPES[label][2], PAST_ITERS[1], PAST_NUTS_DEPTH,
                                  "44 past one block timing", past_state))
    t_timing = time.perf_counter()
    started = start_past_deep(cm)
    errs = {}
    for label, (_, _, n, _, _, _, nuts_held) in PAST_SHAPES.items():
        for nuts in (False, True):
            errs.update(any_mm_checks(
                cm, card, {}, [c for c in cases if c[0] == label and (c[3] == "nuts") == nuts],
                n, nuts_held if nuts else PAST_ITERS[0], PAST_NUTS_DEPTH, "44 past one block",
                past_state, deeper, philox=not nuts or nuts_held > 1, repeat=True))
    errs.update(any_mm_checks(cm, card, {}, [split], PAST_SHAPES[split[0]][2], 1,
                              PAST_NUTS_DEPTH, "44 past one block", past_state, {}, repeat=True))
    t_checks = time.perf_counter()
    stats = past_stats(cm, card)
    t_stats = time.perf_counter()
    learner_row(card)
    t_learner = time.perf_counter()
    deep = past_deep_check(cm, card, started)
    phase("44 past one block", f"phase 44 took {time.perf_counter() - t0:.4g} s: the timings "
          f"{t_timing - t0:.4g}, then beside the plain runs of the tree past the tile depth "
          f"the checks {t_checks - t_timing:.4g}, the statistics {t_stats - t_checks:.4g} "
          f"(launches {json.dumps(stats)}) and the learner {t_learner - t_stats:.4g}, then "
          f"that tree {time.perf_counter() - t_learner:.4g} [{card}]")
    return errs, rows, seconds, past_instances(cm, _build), stats, deep


T0 = time.perf_counter()
T0_WALL = time.time()
DEV = "cuda"


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
          f"{[ln for ln in nvcc if 'release' in ln][0]}; {len(os.sched_getaffinity(0))} "
          f"cores; host probe (fixed Python work on one core) {host_probe():.3f} s")

    # ---- 2. build --------------------------------------------------------
    # the build waits on nvcc; meanwhile this thread imports torch._dynamo,
    # which torch.optim.Adam's first use (phase 39's ADVI) pulls in; phases
    # 42's and 43's on-demand instances build beside it (start_ondemand_builds),
    # and the plain NUTS runs of phases 22 and 42 run on the CPU, each in a
    # process of its own. All of them end within this phase, before the
    # first timing. The CPU seconds of its processes over the cores (the
    # least it could take) are printed beside its length.
    t0 = time.perf_counter()
    cpu0 = cpu_seconds()
    plain_procs = start_plain_nuts()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        built = pool.submit(_build.load)
        od_pool, gate, (od_builds, mm_builds) = start_ondemand_builds(cm, _build)
        importlib.import_module("torch._dynamo")
        t_import = time.perf_counter() - t0
        built.result()
    t_lib = time.perf_counter() - t0
    gate.release(ONDEMAND_BUILDERS - ONDEMAND_BESIDE_LIBRARY)
    od_done = {key: fut.result() for key, fut in od_builds.items()}
    mm_done = {key: fut.result() for key, fut in mm_builds.items()}
    od_pool.shutdown()
    plain_nuts = plain_nuts_results(plain_procs)
    cpu = cpu_seconds() - cpu0
    cores = len(os.sched_getaffinity(0))
    phase("2 build", f"{t_lib:.1f} s -> {_build.library_path().name} (import torch._dynamo "
          f"beside it: {t_import:.1f} s); beside it {len(od_done)} elementwise and "
          f"{len(mm_done)} matmul on-demand libraries, {ONDEMAND_BESIDE_LIBRARY} nvcc at a "
          f"time until the library was built, then {ONDEMAND_BUILDERS}, the last done "
          f"{max(t for _, _, t in [*od_done.values(), *mm_done.values()]):.1f} s after the "
          f"build began, and the plain NUTS runs on the CPU, done "
          f"{json.dumps({k: round(v['done_s'], 1) for k, v in plain_nuts.items()})} s after it "
          f"began; phase 2 ends {time.perf_counter() - t0:.1f} s after it began, and no build "
          f"or run of it goes on into the timed phases. Its processes took {cpu:.1f} CPU "
          f"seconds: {cpu / cores:.1f} s on the {cores} cores at the least")
    log = _build.build_log()
    for kernel, regs, spill in ptxas_report(log):
        phase("2 build", f"ptxas {kernel}: {regs} registers, {spill} bytes spill stores")
    phase("2 build", "sources, one nvcc each (seconds from the start of the build): " + "; ".join(
        ln[len("nvcc "):] for ln in log.splitlines() if re.match(r"nvcc \S+\.cu: ", ln)))
    # the contraction: hand-written mma.sync in every bf16 instance, FP32 FMA
    # only in the full-f32 ones; each instance's SASS digest, to hold the
    # library's kernels to another build's (mm_sass)
    sass = mm_sass(_build)
    hmma = {k: c for k, (c, _) in sass.items()}
    phase("2 build", f"HMMA instructions in the SASS of each matmul instance: {json.dumps(hmma)}")
    phase("2 build", "SASS digest of each matmul instance (its instructions, not its name): "
          + json.dumps({k: dg for k, (_, dg) in sass.items()}))
    # the NUTS kernel's tiles as the library reports them, against the mirror
    # the wrappers read (chains a block for the grid, the scratch rule)
    tiles = {}
    for dist in (ProductOfT(), SparseCoding(), BENCHMARK_CONFIGS["logreg"].make_distribution()):
        spec = cm.energy_spec_for(dist)
        for prec in ("highest", spec.precision):
            for depth in NUTS_TILE_DEPTHS:
                got = cm.nuts_mm_tile(at(spec, prec), depth)
                want = (*cm.nuts_mm_tile_rule(at(spec, prec))[:2],
                        cm.nuts_mm_smem_bytes(at(spec, prec), depth))
                check(got[:3] == want and got[3] >= 1, f"NUTS tile of {type(spec).__name__} at "
                      f"{prec}, max_depth {depth}: the library's {got}, the mirror's {want}")
                tiles[f"{type(spec).__name__} {prec} max_depth {depth}"] = got
    phase("2 build", f"NUTS tiles (chains, threads, shared bytes a block; blocks an SM holds), "
          f"library = mirror: {json.dumps(tiles)}")
    # mm_kernel's tiles, every run instance (MJHMC with and without the
    # branches, control and MALT with), against the mirror the wrappers read
    tiles = {}
    for spec_cls, precs in cm.MM_KERNEL_PRECISIONS.items():
        dist = {cm.ProductOfTSpec: ProductOfT(), cm.SparseCodingSpec: SparseCoding(),
                cm.LogregSpec: BENCHMARK_CONFIGS["logreg"].make_distribution()}[spec_cls]
        for p, what in precs.items():
            spec = at(cm.energy_spec_for(dist), p)
            every = what == cm.ALL_BODIES
            for body, br in (("mjhmc", False), ("mjhmc", True), ("control", True),
                             ("malt", True)) if every else (("mjhmc", False),):
                got = cm.mm_tile(spec, body, br)
                want = (*cm.mm_tile_rule(spec, body)[:2], cm.mm_smem_bytes(spec, body, br))
                check(got[:3] == want and got[3] >= 1, f"mm_kernel tile of {spec_cls.__name__} "
                      f"{body} at {p}{' branches' if br else ''}: the library's {got}, the "
                      f"mirror's {want}")
                tiles[f"{spec_cls.__name__} {body} {p}{' branches' if br else ''}"] = got
    phase("2 build", f"mm_kernel tiles (chains, threads, shared bytes a block; blocks an SM "
          f"holds), library = mirror: {json.dumps(tiles)}")
    # the elementwise NUTS kernel's tiles at the presets' chains, every
    # instance with and without a mass, against the mirror the wrappers read
    # (threads a block from the dims, the chains and the card's SMs; the
    # tree rows' shared memory or, past 10 dims, none: the scratch)
    from mjhmc_tpu_torch.bench_mm_ab import EW_NUTS, ew_nuts_dist

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = {}
    ew = [(c, ew_nuts_dist(c)[0], EW_NUTS[c][0]) for c in EW_NUTS]
    ew.append(("rough_well d50", RoughWell(ndims=50), 4096))
    for cname, dist, n in ew:
        spec, d = cm.energy_spec_for(dist), dist.ndims
        for mass in (False, True):
            for depth in NUTS_TILE_DEPTHS:
                got = cm.nuts_tile(spec, d, depth, n, mass)
                threads = cm.nuts_threads(d, n, sms)
                want = (threads, cm.nuts_smem_bytes(d, threads, depth))
                check(got[:2] == want and got[2] >= 1, f"elementwise NUTS tile of "
                      f"{cname} ({n} chains, max_depth {depth}{', a mass' if mass else ''}): the "
                      f"library's {got}, the mirror's {want}")
                tiles[f"{cname} {n} max_depth {depth}{' mass' if mass else ''}"] = got
    phase("2 build", f"elementwise NUTS tiles (threads, shared bytes a block; blocks an SM "
          f"holds) on {sms} SMs, library = mirror: "
          f"{json.dumps(tiles)}")
    # the MJHMC, control and MALT bodies' grouping at the presets' chains
    # (lanes a chain, threads a block) as the library reports it, against
    # the mirror
    tiles = {}
    ew += [("rough_well 10,000", RoughWell(), 10_000), ("rough_well 102,400", RoughWell(), 102_400)]
    for cname, dist, n in ew:
        spec, d = cm.energy_spec_for(dist), dist.ndims
        for body in ("mjhmc", "control", "malt"):
            got = cm.ew_tile(body, spec, d, n)
            lanes = cm.ew_lanes(body, spec, d)
            want = (lanes, cm.ew_threads(lanes, n, sms))
            check(got == want, f"{body} grouping of {cname} ({n} chains): the library's {got}, "
                  f"the mirror's {want}")
            tiles[f"{body} {cname} {n}"] = got
    phase("2 build", f"elementwise MJHMC, control and MALT grouping (lanes a chain, threads a "
          f"block) on {sms} SMs, library = mirror: {json.dumps(tiles)}")
    # the rough well's MALT force and energy take one sincosf: its bits
    # against sinf's and cosf's over the arguments x k1 reaches and past them
    for lo, hi in ((-4.0, 4.0), (-200.0, 200.0), (-1e5, 1e5)):
        o = cm.sincos_probe(torch.linspace(lo, hi, 4_000_001, device=DEV))
        phase("2 build", f"sincosf on 4,000,001 floats in [{lo:g}, {hi:g}]: the sine differs from "
              f"sinf's on {int((o[0] != o[2]).sum())}, the cosine from cosf's on "
              f"{int((o[1] != o[3]).sum())}")
    # 12 instances (4 bodies, run and stream, MJHMC and NUTS with and without
    # the branches) and NUTS's 2 DEEP ones (run and stream) per preset at two
    # precisions, the stub, the sweep's 4, the NUTS run's PROF instance per
    # preset at its JAX default and mm_kernel's 3 (MJHMC and MALT on sparse
    # coding, MALT on logreg)
    check(len(hmma) == 3 * 2 * (12 + 2) + 1 + 4 + 3 + 3 and all(
        (c > 0) != label.endswith("highest") for label, c in hmma.items()),
        "every bf16 matmul instance must run HMMA and no full-f32 one")
    # phase 40's plain rows: their process imports beside phases 3-38 and
    # runs its rows beside phase 39
    import tempfile

    side_dir = tempfile.TemporaryDirectory()
    side40 = start_plain_rows40(side_dir.name, plain_nuts["gaussian d8"])

    # ---- 3. kernels vs plain version, fixed-uniform mode -----------------
    rw = RoughWell()
    spec = cm.energy_spec_for(rw)
    st = initial_state(rw, 4096, seed=1)
    args = (spec, *st, 7, EPS, BETA)
    k100 = cm.cuda_mjhmc_run(*args, 100, M, fixed_uniform=True)
    r100 = cm.run_reference(*args, 100, M, fixed_uniform=True)
    check(bool((k100.evals == M * 100 + M).all()) and bool((r100.evals == M * 100 + M).all()),
          "fixed-uniform evals must be exactly M*100 + M on every chain")
    # Σw over all chains: single chains may drift apart over 100 chaotic
    # iterations (x/scale2 reaches ~100 rad, where sin turns ulps into states)
    assert_close(k100.w.sum(), r100.w.sum(), 1e-4, 0.0, "sum of w after 100 iterations")
    w_rel = float(((k100.w - r100.w).abs() / r100.w).max())
    k5 = cm.cuda_mjhmc_run(*args, 5, M, fixed_uniform=True)
    r5 = cm.run_reference(*args, 5, M, fixed_uniform=True)
    atol = 1e-4 * float(r5.x.abs().max())
    run_err = assert_close(k5.x, r5.x, 1e-4, atol, "x after 5")
    for fname in ("v", "grad", "u"):
        assert_close(getattr(k5, fname), getattr(r5, fname), 1e-4, atol, f"{fname} after 5")
    xs_k, ws_k, es_k, so_k = cm.cuda_mjhmc_stream_run(*args, 5, 1, M, fixed_uniform=True)
    xs_r, ws_r, es_r, _ = cm.stream_reference(*args, 5, 1, M, fixed_uniform=True)
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
    r50 = cm.run_reference(*args50, 5, M, fixed_uniform=True)
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
    rp = cm.run_reference(*args, 5, M)
    same = float((kp.evals == rp.evals).double().mean())
    rebuilt = float((rp.evals > 6 * M).double().mean())
    check(same >= 0.999, f"Philox-mode counters match on {same:.5f} of chains (< 0.999)")
    check(rebuilt > 0.01, f"only {rebuilt:.4f} of chains refreshed: draws not exercised")
    phase("4 philox", f"counters equal on {same:.5f} of chains; "
          f"{rebuilt:.3f} of chains refreshed at least once")
    args50 = (spec50, *initial_state(g50, 4096, seed=7), 12345, 0.1, BETA)
    same50 = float((cm.cuda_mjhmc_run(*args50, 5, M).evals
                    == cm.run_reference(*args50, 5, M).evals).double().mean())
    check(same50 >= 0.999, f"gauss50d Philox-mode counters match on {same50:.5f} (< 0.999)")
    phase("4 philox", f"gauss50d (D=50): counters equal on {same50:.5f} of chains")
    for c in mm_cases:
        mm_philox_checks(cm, *c)

    # ---- 5. statistics through CudaMJHMC ---------------------------------
    grads_per_iter = {}  # gradients per chain and iteration of the runs below
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
        grads_per_iter[cname] = float(eng.evals.double().mean()) / 2200
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

    mm_cli_s = {}
    mm_cli = {"product_of_t": (500, 1000), "sparse_coding": (200, 200)}  # burn, steps
    jax_default, _ = mm_precisions(cm)
    # the bf16 instances' launches on the main paths: {(config, instance):
    # ((run, stream) at the preset's JAX default precision, the calls)}
    main_runs = {}

    def drove(key, c, origin):
        before, was = main_runs.get(key, ((0, 0), ""))
        main_runs[key] = (tuple(a + b for a, b in zip(before, c)),
                          origin if origin in was.split("; ") else "; ".join(filter(None, (
                              was, origin))))
    for cname, (burn, steps) in mm_cli.items():
        cfg = BENCHMARK_CONFIGS[cname]
        cm.reset_counts()
        rec, launches, mm_cli_s[cname] = run_cli(
            cli, ["sample", "--config", cname, "--engine", "cuda", "--burn", str(burn),
                  "--steps", str(steps)], counters)
        # the preset's JAX default precision, as the CLI runs it
        at_prec = counts(cm, f"{jax_default[cname]}_launches", mm=True)
        check(launches["mm_run"] > 0 and launches["mm_stream"] > 0 and at_prec == (
            launches["mm_run"], launches["mm_stream"]),
              f"{cname}: matmul kernels not launched at {jax_default[cname]}: {launches}, "
              f"{at_prec}")
        drove((cname, "mjhmc"), at_prec, "phase 6: sample")
        m, n = cfg.num_leapfrog_steps, cfg.nbatch
        ge = rec["grad_evals"]
        check(rec["chains"] == n and rec["steps"] == steps and rec["ess"] > 0
              and ge >= m * (burn + steps) * n and ge % m == 0
              and all(v > 0 and v == v for v in rec["var"])
              and all(abs(x) < 1e6 for x in rec["mean"]), f"{cname}: bad CLI record {rec}")
        phase("6 cli", f"{cname}: {json.dumps(rec)}; launches {launches}, all at "
              f"{jax_default[cname]}; {mm_cli_s[cname]:.4g} s host clock")

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
    cm.run_reference(*args, 5, M)
    plain_ms = events_ms(lambda: cm.run_reference(*args, 300, M)) / 300
    plain_stream_ms = events_ms(lambda: cm.stream_reference(*args, 300, 1, M)) / 300
    phase("7 timing", f"plain version on the card, rough_well, 10,000 chains: "
          f"run {plain_ms:.6g} ms/iteration, stream {plain_stream_ms:.6g} ms/iteration "
          f"[{card}]")

    mm_ms = {}
    for cname, cfg, dist, n in mm_cases:
        m = cfg.num_leapfrog_steps
        iters = 2000 if cname == "product_of_t" else 500
        rate = bench_cuda(cfg, nbatch=n, steps_per_call=iters, precision="highest")
        k_ms = n * m / rate * 1e3
        eng = cm.CudaMJHMC(dist, epsilon=cfg.epsilon, beta=cfg.beta, num_leapfrog_steps=m,
                           nbatch=n, seed=4, device="cuda")
        eng.spec = at(eng.spec)
        eng.sample(20)
        s_ms = events_ms(lambda: eng.sample(iters)) / iters
        grads_per_iter[cname] = float(eng.evals.double().mean()) / eng.steps_total
        args = (eng.spec, *initial_state(dist, n, seed=5), 99, cfg.epsilon, BETA)
        cm.run_reference(*args, 5, m)
        p_ms = events_ms(lambda: cm.run_reference(*args, 50, m)) / 50
        ps_ms = events_ms(lambda: cm.stream_reference(*args, 50, 1, m)) / 50
        mm_ms[cname] = (k_ms, s_ms, p_ms, ps_ms)
        phase("7 timing", f"matmul kernel, {cname}, {n} chains, full f32: run {k_ms:.6g} "
              f"ms/iteration ({rate:.6g} credited steps/s), stream (thin 1) {s_ms:.6g} "
              f"ms/iteration; plain version run {p_ms:.6g}, stream {ps_ms:.6g} ms/iteration "
              f"[{card}]")

    # ---- 8-12. ceiling probes, NUTS and the stub vs their plain versions --
    fma_err, fma_plain_ms, tc_err, tc_plain_ms = ceiling_checks(ce)
    nuts_run_err, nuts_stream_err, ew_deep = nuts_checks(cm)
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

    # ---- 15-20. control, MALT, two-stage and inverse mass ------------------
    slice_err = slice_kernel_checks(cm)
    nuts_mass_checks(cm)
    mass_res = slice_stats(cm, card)
    cli_res = slice_cli(cm, cli)
    slice_ms = slice_timing(cm, card)
    for (sampler, cname, integrator), (_, c, _) in cli_res.items():
        if "precision" in c:  # control and MALT have one instance each
            key = "mjhmc branches" if sampler == "mjhmc" else sampler
            drove((cname, key), c["precision"], "phase 19: sample")

    # ---- 21-24. slice K: NUTS and logreg on the matmul kernel ---------------
    # (the logreg bodies and branches are held in phases 15-16)
    # the depth-12 cases' plain runs on the CPU beside the other checks
    deep_err, deep_times, mm_nuts_err = mm_nuts_deep_checks(cm, lambda: mm_nuts_checks(cm))
    deep_preset = mm_nuts_deep_timing(cm, card)
    for key, c in slice_k_stats(cm, plain_nuts["product_of_t"]).items():
        drove(key, c, "phase 22: from_warmup, then run and sample")
    for (sampler, cname, engine), (_, c, _) in slice_k_cli(cm, cli).items():
        if engine == "cuda" and cname in jax_default:
            drove((cname, sampler), c, "phase 23: sample")
    k_ms = slice_k_timing(cm, card)

    # ---- 25-29. slice L: the zoo energies on the elementwise kernel ---------
    zoo_err, zoo_ident = zoo_kernel_checks(cm)
    zoo_stat_launches = zoo_stats(cm)
    zoo_cli_res = zoo_cli(cm, cli)
    zoo_ms = zoo_timing(cm, card)
    phase("29 zoo timing", f"the rough well beside the zoo's vector step (its per-dim step "
          f"kept): run kernel {run_ms:.6g} ms/iteration at 10,000 chains (phase 7; 0.0027542 "
          f"before slice L, PERF.md section 6) [{card}]")

    # ---- 30-33. the matmul kernel's dot precisions ---------------------------
    t_prec = time.perf_counter()
    prec_err = precision_kernel_checks(cm)
    sweep = precision_sweep(cm)
    precision_variances(cm, sweep)
    prec_ms = precision_timing(cm, card)
    phase("33 precision timing", f"phases 30-33 took {time.perf_counter() - t_prec:.4g} s")

    # ---- 34-35. slice G: the chain-sharded runtime (kernel #7) ---------------
    t_sh = time.perf_counter()
    sh = sharded_world1(cm, card)
    sharded_two_processes(cm)
    phase("35 sharded two processes", f"phases 34-35 took {time.perf_counter() - t_sh:.4g} s")

    # ---- 36. the kernels' phase breakdowns ------------------------------------
    nuts_breakdown(cm, card)
    ew_nuts_breakdown(cm, card)
    ew_body_breakdown(cm, card)
    mm_breakdown(cm, card)

    # ---- 38. slices B and E: ESS/s, the autocorrelation experiment, oracles --
    t_ess = time.perf_counter()
    ess_launches, ess_recs = ess_rows(cm, card)
    for key, n in ess_oracles(cm, cli, card).items():
        ess_launches[key] = ess_launches.get(key, 0) + n
    phase("38 ess", f"phase 38 took {time.perf_counter() - t_ess:.4g} s; ESS/s " + json.dumps(
        {f"{c} {s}": rec["value"] for (c, s), rec in ess_recs.items()}) + f" [{card}]")

    # ---- 39. slices D and F: the other samplers and the heads -----------------
    # phase 40's plain rows run beside it, in the process started at phase 2's end
    t_39 = time.perf_counter()
    go_plain_rows40(side40)
    rows39, sharded = samplers_and_heads(cm, cli, card, name)
    phase("39 samplers and heads", f"phase 39 took {time.perf_counter() - t_39:.4g} s (phase "
          f"40's plain rows beside it); rows "
          + json.dumps({k: round(v, 4) for k, v in rows39.items()}) + f" [{card}]")

    # ---- 40. slice H: the searches, the figures, the claim, bench --profile --
    t_40 = time.perf_counter()
    rows40, profile_launches, side = search_and_figures(cm, cli, card, side40, side_dir.name)
    side_dir.cleanup()
    phase("40 search and figures", f"phase 40 took {time.perf_counter() - t_40:.4g} s after "
          f"phase 39 (its plain rows {side['seconds']:.4g} s and the statistics of phases 42 "
          f"and 43 {side['stats42']['seconds']:.4g} and {side['stats43']['seconds']:.4g} s in "
          f"their own process, begun with phase 39); rows "
          + json.dumps({k: round(v, 4) for k, v in rows40.items()}) + f" [{card}]")

    # ---- 41. slice H part 3: bench_ess --tune/--table, two-stage, sharded SMC --
    t_41 = time.perf_counter()
    rows41, deep_launches = ess_table_and_tune(cm, card, sharded)
    phase("41 ess table and tune", f"phase 41 took {time.perf_counter() - t_41:.4g} s; rows "
          + json.dumps({k: round(v, 4) for k, v in rows41.items()}) + f" [{card}]")

    # ---- 42. the elementwise engine at any D: on-demand instances -----------
    any_d = any_d_phase(cm, _build, card, od_done, side["stats42"])

    # ---- 43. the matmul engine at any (d, k) and dot precision ---------------
    past = set(past_instances(cm, _build).values())
    any_mm = any_mm_phase(cm, cli, _build, card,
                          {k: v for k, v in mm_done.items() if k not in past}, side["stats43"])

    # ---- 44. the matmul engine past one block's shared memory -----------------
    past44 = past_phase(cm, _build, card, {k: v for k, v in mm_done.items() if k in past})

    # ---- the kernels' record ----------------------------------------------
    from mjhmc_tpu_torch.ops.ceilings import tc_chain_lanes, tc_flops_per_iteration

    def entry(kname, source, replaces, launches, err, ms, plain_ms, bnd, **extra):
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None, **extra}

    shapes = {"rough_well": (2, 0), "gauss50d": (50, 0), "gauss2d": (2, 0),
              "product_of_t": (36, 36), "sparse_coding": (128, 64), "logreg": (16, 256)}

    def mjhmc_bound(cname, n, emit, iters=1000):
        d, k = shapes[cname]
        return bound(cname, "mjhmc", d, k, n, iters, grads_per_iter[cname] * n * iters,
                     iters if emit else 0)

    def slice_entry(kname, key, cnames, src, replaces, launches, err, stream, variant, **more):
        run_ms, stream_ms, plain_ms, plain_stream_ms, grads, iters, n = slice_ms[(key, cnames[-1])]
        d, k = shapes[cnames[-1]]
        body = {"two_stage": "mjhmc", "inv_mass": "mjhmc"}.get(key, key)
        bnd = bound(cnames[-1], body, d, k, n, iters, grads, iters if stream else 0)
        extra = {"variant": variant, "shape": f"{cnames[-1]}, {n} chains, ms per iteration",
                 **more}
        if len(cnames) > 1:
            extra["per_config_ms"] = {c: {"ms": slice_ms[(key, c)][1 if stream else 0],
                                          "plain_ms": slice_ms[(key, c)][3 if stream else 2]}
                                      for c in cnames}
        return entry(kname, src, replaces, launches, err,
                     stream_ms if stream else run_ms, plain_stream_ms if stream else plain_ms,
                     bnd, **extra)

    def cli_counts(sampler, cnames, attr, integrator="leapfrog", idx=0):
        return sum(cli_res[(sampler, c, integrator)][1][attr][idx] for c in cnames)

    # the matmul kernel's full-f32 instances (the rows of PRs 2-5): the CLI
    # runs the presets' JAX default precisions now, so their launches are
    # phase 33's engine runs at precision "highest"
    def highest_launches(cnames, key, idx=0):
        return sum(prec_ms[(c, key, "highest")]["launches"][idx] for c in cnames)

    def mm_entry(kname, src, launches, idx_ms, idx_plain, err_idx):
        sc = mm_ms["sparse_coding"]
        return entry(kname, MM_KERNEL_SRC, src, launches,
                     max(e[err_idx] for e in mm_err.values()), sc[idx_ms], sc[idx_plain],
                     mjhmc_bound("sparse_coding", 8192, idx_ms == 1),
                     precision="highest", shape="sparse_coding, 8192 chains",
                     per_config_ms={c: {"ms": v[idx_ms], "plain_ms": v[idx_plain]}
                                    for c, v in mm_ms.items()})

    tc_lanes = tc_chain_lanes(128)
    nuts_leaves = nuts_ms[4]
    nuts_bound = bound("gauss2d", "nuts", 2, 0, 10_240, 1000, nuts_leaves * 10_240 * 1000)
    kernels = [
        entry("mjhmc_run", KERNEL_SRC, RUN_SRC, rw_launches["run"], run_err, run_ms, plain_ms,
              mjhmc_bound("rough_well", 10_000, False)),
        entry("mjhmc_stream", KERNEL_SRC, STREAM_SRC, rw_launches["stream"], stream_err,
              stream_ms, plain_stream_ms, mjhmc_bound("rough_well", 10_000, True)),
        mm_entry("mjhmc_mm_run", MM_RUN_SRC, highest_launches(("product_of_t", "sparse_coding"), "mjhmc"), 0, 2, 0),
        mm_entry("mjhmc_mm_stream", MM_STREAM_SRC,
                 highest_launches(("product_of_t", "sparse_coding"), "mjhmc", 1), 1, 3, 1),
        entry("fma_chain", CEIL_SRC, FMA_SRC, dossier["launches"]["fma_chain.launches"],
              fma_err, dossier["fma_ms"], fma_plain_ms,
              (2.0 * 256 * 1024 * 4 / FP32_PEAK * 1e3, "operations"),
              shape="(256, 1024) x 4 chains, ms per iteration"),
        entry("tc_chain", CEIL_SRC, TC_SRC, dossier["launches"]["tc_chain.launches"], tc_err,
              dossier["tc_ms"], tc_plain_ms,
              (tc_flops_per_iteration(128, tc_lanes) / BF16_PEAK * 1e3, "operations"),
              shape="depth 128 x 4 chains, ms per iteration"),
        entry("nuts_run", KERNEL_SRC, RUN_SRC, nuts_launches["nuts_run"], nuts_run_err,
              nuts_ms[0], nuts_ms[2], nuts_bound, variant=NUTS_VARIANT,
              shape="gauss2d, 10,240 chains, max_depth 7, ms per iteration"),
        entry("nuts_stream", KERNEL_SRC, STREAM_SRC, nuts_launches["nuts_stream"],
              nuts_stream_err, nuts_ms[1], nuts_ms[3],
              bound("gauss2d", "nuts", 2, 0, 10_240, 1000, nuts_leaves * 10_240 * 1000, 1000),
              variant=NUTS_VARIANT,
              shape="gauss2d, 10,240 chains, max_depth 7, thin 1, ms per iteration"),
        entry("mjhmc_mm_run_stub", MM_KERNEL_SRC, MM_RUN_SRC,
              dossier["launches"]["cuda_mjhmc_mm_run.stub_launches"], stub_err,
              dossier["stub_ms"], stub_plain_ms,
              bound("product_of_t", "mjhmc", 36, 36, 4096, 1000, 10 * 4096 * 1000, stub=True),
              variant=STUB_VARIANT, shape="product_of_t, 4,096 chains, M 10, ms per iteration"),
    ]

    def control_branches(stream):
        """Phase 20's control branch instances on the elementwise kernel:
        two-stage on the rough well, a mass on gauss50d, each with its bound."""
        out = {}
        for key, cname, mass in (("control two_stage", "rough_well", False),
                                 ("control inv_mass", "gauss50d", True)):
            run_ms, stream_ms, plain_ms, plain_stream_ms, grads, iters, n = slice_ms[(key, cname)]
            d, k = shapes[cname]
            tag = key.split()[1]
            out[f"{tag}_ms"] = stream_ms if stream else run_ms
            out[f"{tag}_plain_ms"] = plain_stream_ms if stream else plain_ms
            out[f"{tag}_bound_ms"], out[f"{tag}_bound_by"] = bound(
                cname, "control", d, k, n, iters, grads, iters if stream else 0, mass=mass)
        return out

    mm = ("product_of_t", "sparse_coding")
    for body, variant in (("control", CONTROL_VARIANT), ("malt", MALT_VARIANT)):
        err = slice_err[f"rough_well {body}"]
        mm_err_b = max(slice_err[f"{c} {body}"] for c in mm)
        for idx, (suffix, src) in enumerate((("run", RUN_SRC), ("stream", STREAM_SRC))):
            more = control_branches(idx == 1) if body == "control" else {}
            kernels.append(slice_entry(
                f"{body}_{suffix}", body, ("rough_well",), KERNEL_SRC, src,
                cli_counts(body, ("rough_well",), "body", idx=idx), err, idx == 1, variant,
                **more))
        for idx, (suffix, src) in enumerate((("run", MM_RUN_SRC), ("stream", MM_STREAM_SRC))):
            kernels.append(slice_entry(
                f"{body}_mm_{suffix}", body, mm, MM_KERNEL_SRC, src,
                highest_launches(mm, body, idx), mm_err_b, idx == 1, variant,
                precision="highest"))
    kernels += [
        slice_entry("mjhmc_run_two_stage", "two_stage", ("rough_well",), KERNEL_SRC, RUN_SRC,
                    sum(cli_counts(s, ("rough_well",), "two_stage", "two_stage")
                        for s in ("mjhmc", "control")),
                    max(slice_err["rough_well mjhmc two_stage"],
                        slice_err["rough_well control two_stage"]), False, TWO_STAGE_BRANCH),
        slice_entry("mjhmc_mm_run_two_stage", "two_stage", ("product_of_t",), MM_KERNEL_SRC,
                    MM_RUN_SRC, highest_launches(("product_of_t",), "mjhmc branches"),
                    max(slice_err[c] for c in (
                        "product_of_t mjhmc two_stage", "product_of_t control two_stage inv_mass",
                        "sparse_coding control two_stage inv_mass")), False, TWO_STAGE_BRANCH,
                    precision="highest"),
        slice_entry("mjhmc_run_inv_mass", "inv_mass", ("gauss50d",), KERNEL_SRC, RUN_SRC,
                    mass_res["gauss50d"][0][0],
                    max(slice_err[f"gauss50d {b} inv_mass"] for b in ("mjhmc", "control", "malt")),
                    False, MASS_BRANCH),
        slice_entry("mjhmc_mm_run_inv_mass", "inv_mass", ("product_of_t",), MM_KERNEL_SRC,
                    MM_RUN_SRC, highest_launches(("product_of_t",), "mjhmc branches"),
                    max(slice_err[c] for c in (
                        "product_of_t control two_stage inv_mass", "sparse_coding mjhmc inv_mass",
                        "sparse_coding control two_stage inv_mass")), False, MASS_BRANCH,
                    precision="highest"),
    ]
    # slice K: the NUTS body on each matmul energy, the logreg MJHMC,
    # control and MALT bodies
    for body, cname in (("nuts", "product_of_t"), ("nuts", "sparse_coding"), ("nuts", "logreg"),
                        ("mjhmc", "logreg"), ("control", "logreg"), ("malt", "logreg")):
        run_ms, stream_ms, plain_ms, plain_stream_ms, grads, iters, n, share = k_ms[(body, cname)]
        d, k = shapes[cname]
        err = mm_nuts_err[cname] if body == "nuts" else slice_err[f"logreg {body}"]
        variant = {"nuts": NUTS_VARIANT, "mjhmc": "mjhmc (_make_step, "
                   "mjhmc_tpu/ops/pallas_mjhmc.py:714)", "control": CONTROL_VARIANT,
                   "malt": MALT_VARIANT}[body]
        for idx, (suffix, src) in enumerate((("run", MM_RUN_SRC), ("stream", MM_STREAM_SRC))):
            stream = idx == 1
            extra = {"variant": variant, "energy": MM_ENERGIES[cname], "precision": "highest",
                     "shape": f"{cname}, {n} chains, {'max_depth 8' if body == 'nuts' else 'preset'}"
                              f"{', thin 1' if stream else ''}, ms per iteration"}
            if body == "nuts":
                extra["leaf_slots_live"] = share
            kernels.append(entry(f"{body}_mm_{suffix}[{cname}]", MM_KERNEL_SRC, src,
                                 highest_launches((cname,), body, idx), err,
                                 stream_ms if stream else run_ms,
                                 plain_stream_ms if stream else plain_ms,
                                 bound(cname, body, d, k, n, iters, grads, iters if stream else 0),
                                 **extra))
    # the matmul NUTS kernel past round 10: max_depth 12 on the instance
    # every shallower tree runs, MM_DEEP_DEPTH on the DEEP one;
    # launched on phase 41's NUTS arbitration and measures; held and timed
    # (16 chains, with the plain version) in phase 21, and timed at the
    # preset's 4,096 chains at MM_DEEP_TIMED's depths
    from mjhmc_tpu_torch.bench_mfu import PASSES

    deep12, past12 = deep_launches
    for depth, launches in ((12, deep12), (MM_DEEP_DEPTH, past12)):
        run16, stream16, plain_ms, leaves, n16, eps16 = deep_times[depth]
        pre = deep_preset[depth]
        cases = {key: v for key, v in deep_err.items() if key.endswith(f" max_depth {depth}")}
        deeper = depth > cm.NUTS_MM_TILE_DEPTH
        for idx, (suffix, src) in enumerate((("run", MM_RUN_SRC), ("stream", MM_STREAM_SRC))):
            kernels.append(entry(
                f"nuts_mm_{suffix}[product_of_t, default, max_depth {depth}]", MM_KERNEL_SRC,
                src, launches[idx], max(cases.values()), (run16, stream16)[idx], plain_ms,
                bound("product_of_t", "nuts", 36, 36, n16, 1, int(leaves * n16), idx,
                      passes=PASSES["default"]),
                launches_from=f"phase 41: _arbitrate_nuts and measure(..., m={depth}), "
                              "product_of_t nuts-engine"
                              + (" (the launches past 12)" if deeper else ""),
                variant=NUTS_VARIANT, energy=MM_ENERGIES["product_of_t"], precision="default",
                instance=("the library's DEEP instance (the branches; stack rows and span slots "
                          "past 12 in the device buffer)" if deeper else "the library's"),
                max_abs_err_by_case=cases,
                shape=f"product_of_t, {n16} chains, max_depth {depth}, eps {eps16}, Philox, 1 "
                      f"iteration, {leaves:.5g} leaves a chain; ms per launch; plain_ms the "
                      "plain stream's, on the CPU",
                preset_ms=pre["ms"], preset_bound_ms=pre["bound"][0],
                preset_ms_by_depth={dd: deep_preset[dd]["ms"] for dd in MM_DEEP_TIMED},
                preset_shape=f"product_of_t, {pre['n']} chains, eps {pre['eps']}, 1 iteration, "
                             f"{pre['leaves']:.5g} leaves a chain",
                blocks_per_sm_by_depth=pre["blocks"]))
    # the elementwise NUTS kernel past 12 (the same instance at every
    # depth): CudaNUTS on gauss2d, bit-identical to the plain version
    for key, src in (("run", RUN_SRC), ("stream", STREAM_SRC)):
        rec = ew_deep[key]
        kernels.append(entry(
            f"nuts_{key}[gauss2d, max_depth {rec['depth']}]", KERNEL_SRC, src, rec["launches"],
            rec["err"], rec["ms"], rec["plain_ms"],
            bound("gauss2d", "nuts", 2, 0, 1024, 1, rec["leaves"], int(key == "stream")),
            variant=NUTS_VARIANT,
            launches_from=f"phase 10: CudaNUTS.{'sample' if key == 'stream' else 'run'}",
            shape=f"gauss2d, 1024 chains, max_depth {rec['depth']}, eps {EW_DEEP_EPS}, Philox, 1 "
                  "iteration, ms per launch; bit-identical to the plain version on the card"))
    # the chunked tile past 12 (a9a's shape, on demand): CudaNUTS.run
    pd = past44[5]
    deep_inst = past44[3][("logreg 124x32561", pd["precision"], "nuts")]
    kernels.append(entry(
        f"nuts_mm_run[logreg 124x32561, {pd['precision']}, max_depth {PAST_DEEP_DEPTH}]",
        MM_ONDEMAND_SRC, MM_RUN_SRC, pd["launches"], pd["err"], pd["ms"], pd["plain_ms"],
        pd["bound"], variant=NUTS_VARIANT, energy=MM_ENERGIES["logreg"],
        precision=pd["precision"], instance="on demand, its DEEP instance",
        nvcc_s=past44[2][deep_inst],
        launches_from="phase 44: CudaNUTS.run", parameter_matrix="device memory",
        chunk_rows=cm.nuts_mm_tile_rule(cm.energy_spec_for(past_dist("logreg 124x32561"))).chunk,
        shape=f"logreg 124x32561, {pd['n']} chains (one tile), max_depth {PAST_DEEP_DEPTH}, eps "
              f"{pd['eps']}, Philox, 1 iteration, {pd['leaves']:.5g} leaves a chain, ms per "
              "launch; plain_ms the plain run's on the card"))
    kernels += zoo_entries(entry, zoo_err, zoo_ident, zoo_cli_res, zoo_ms)
    kernels += precision_entries(entry, prec_err, sweep, prec_ms, dossier["ceilings"],
                                 main_runs)
    kernels += any_d_entries(entry, *any_d)
    kernels += any_mm_entries(cm, entry, *any_mm[:4])
    kernels += past_entries(cm, entry, *past44[:4])
    rw_sh, sc_sh = sh["rough_well 10,000"], sh["sparse_coding 8,192 bf16x3"]
    kernels += [
        entry("sharded_mjhmc_run", KERNEL_SRC, SHARDED_SRC, sh["bench_scaling"]["launches"],
              max(rw_sh["err"], sh["rough_well 102,400"]["err"]), rw_sh["ms"],
              rw_sh["plain_ms"], rw_sh["bound"], direct_ms=rw_sh["direct_ms"],
              launches_from="bench_scaling --devices 1 --profile (2,048 chains, 200 steps, 4 "
                            "runs and the traced one)",
              shape="rough_well, 10,000 chains, world size 1 (NCCL), ms per iteration"),
        entry("sharded_mjhmc_mm_run[sparse_coding, bf16x3]", MM_KERNEL_SRC, SHARDED_SRC,
              sc_sh["launches"], sc_sh["err"], sc_sh["ms"], sc_sh["plain_ms"], sc_sh["bound"],
              direct_ms=sc_sh["direct_ms"], precision="bf16x3",
              launches_from="phase 34: sharded_cuda_mjhmc_run, 8,192 chains, 20 iterations",
              shape="sparse_coding, 8,192 chains, world size 1 (NCCL), ms per iteration"),
    ]
    phase("29 zoo timing", f"statistics engines' launches (phase 27): {zoo_stat_launches}")
    for kern in kernels:  # phase 38's launches beside each main path's
        if kern["name"] in ess_launches:
            kern["ess_launches"] = ess_launches.pop(kern["name"])
    check(not ess_launches, f"phase 38 launched kernels the kernels line lacks: {ess_launches}")
    kernels[0]["profile_launches"] = profile_launches  # phase 40's bench --profile
    check(all(kern["launches"] > 0 for kern in kernels),
          f"kernels not launched on their main paths: "
          f"{[kern['name'] for kern in kernels if not kern['launches'] > 0]}")
    stray = stop_children()
    check(not stray, f"processes still running at the end, now stopped: {stray}")
    phase("37 total", f"{time.perf_counter() - T0:.4g} s since start [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase35-rank"]:
        sys.exit(phase35_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--plain-nuts"]:
        sys.exit(plain_nuts_run(sys.argv[2]))
    if sys.argv[1:2] == ["--plain-rows40"]:
        sys.exit(plain_rows40_run(sys.argv[2], sys.argv[3]))
    try:
        sys.exit(main())
    finally:
        SPARED.clear()
        stop_children()
