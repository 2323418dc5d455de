"""Build the engine's CUDA library from ``csrc/`` with nvcc and load it with
ctypes.

The library has a plain C interface, so nvcc compiles it without PyTorch's
headers. Every ``.cu`` source of ``csrc/`` is compiled to an object by its
own nvcc, all started together (the kernels are templates in the ``.cuh``
headers, and the slow D=50 instances have sources of their own), and one
more nvcc links the objects into one shared library, refusing undefined
symbols. The compiler's report and each source's wall time go to the
build's ``.log``. It is built at first use into ``build/mjhmc_tpu_torch/``
beside the package, under a name keyed by a hash of the sources and flags,
so an edited source builds anew and an unchanged one is reused.

The library holds the elementwise engine at the presets' D only
(``cuda_mjhmc.KERNEL_DIMS``) and the matmul engine at the presets' (d, k)
and precisions only (``cuda_mjhmc.MM_KERNEL_SHAPES``,
``MM_KERNEL_PRECISIONS``). Any other key is compiled on demand, as a Pallas
kernel is traced at the shape it is called at: ``load_instance`` compiles an
``Instance`` (``ew_instance``: ``csrc/ondemand/ew_instance.cu`` at a (body,
energy, D, mixture cap); ``mm_instance``: ``csrc/ondemand/mm_instance.cu``
at a (body, energy, d, k, precision, parameter-matrix mode)) with the same
flags and the instance's ``-D`` macros into a library of its own beside the
main one, keyed by a hash of that source, the headers, the flags and the
macros, with its compiler report in a ``.log`` beside it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: the compiled sources, one object each, and every file the build reads
KERNEL_SOURCES = tuple(sorted(p.name for p in CSRC.glob("*.cu")))
SOURCES = KERNEL_SOURCES + tuple(sorted(p.name for p in CSRC.glob("*.cuh")))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mjhmc_tpu_torch"
# no --use_fast_math: the rough well's sin/cos arguments reach ~100 rad, and
# the Kahan sums need IEEE arithmetic
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STATE_AND_RUN = (
    [_P] * 6  # x, v, g, u, h_back, valid
    + [_P] * 10  # xo, vo, go, uo, hbo, valido, w, wx, wx2, evals
    + [_P] * 3  # xs, ws, es
    + [_I] * 4  # n, num_iters, thin, m
    + [ctypes.c_uint, _F, _F, _I, _P]  # seed, eps, beta, fixed_uniform, stream
)
#: argument types of ``mjhmc_engine_launch`` (csrc/mjhmc_engine.cu)
LAUNCH_ARGTYPES = (
    [_I, _I, _I, _P] + [_F] * 5  # variant, ndims, energy, params, k0..k4
    + [_P, _I, _P]  # mass, two_stage, scratch (NUTS)
    + _STATE_AND_RUN
)
#: argument types of ``mjhmc_mm_engine_launch`` (csrc/mjhmc_mm_engine.cu)
MM_LAUNCH_ARGTYPES = (
    # energy, ndims, krows, stub, variant, precision, p0, p1, k0..k3
    [_I, _I, _I, _I, _I, _I, _P, _P] + [_F] * 4
    + [_P, _I, _P]  # mass, two_stage, scratch (NUTS)
    + _STATE_AND_RUN
)
#: argument types of ``mjhmc_nuts_profile``, ``mjhmc_ew_profile``,
#: ``mjhmc_mm_nuts_profile`` and ``mjhmc_mm_profile``: the launch's, then the
#: PROF instance's output
#: buffer; of ``mjhmc_nuts_tile``, ``mjhmc_mm_nuts_tile`` and ``mjhmc_mm_tile``
PROFILE_ARGTYPES = LAUNCH_ARGTYPES + [_P]
MM_PROFILE_ARGTYPES = MM_LAUNCH_ARGTYPES + [_P]
NUTS_TILE_ARGTYPES = [_I, _I, _I, _I, _I, _P]  # ndims, energy, mass, max_depth, n, out
EW_TILE_ARGTYPES = [_I, _I, _I, _I, _P]  # variant, ndims, energy, n, out
MM_NUTS_TILE_ARGTYPES = [_I, _I, _I, _P]  # energy, precision, max_depth, out
MM_TILE_ARGTYPES = [_I, _I, _I, _I, _P]  # energy, precision, variant, branches, out
#: argument types of the ceiling probes (csrc/ceilings.cu)
FMA_CHAIN_ARGTYPES = [_P, _P, _P, _I, ctypes.c_longlong, _I, _P]  # a, b, out, n, iters, sin, stream
TC_CHAIN_ARGTYPES = [_P, _P, _P, _I, _I, _I, _F, _P]  # w, b, out, depth, lanes, iters, c, stream


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA engine is built from mjhmc_tpu_torch/csrc "
        "with the CUDA toolkit"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmjhmc_engine_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source hash is already built; the
    compiler's output (``-Xptxas -v``: registers, spills) goes to a .log."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = path.parent / f"{path.name}.{os.getpid()}"
    objs = [Path(f"{stem}.{name}.o") for name in KERNEL_SOURCES]
    logs = [obj.with_suffix(".log") for obj in objs]
    t0 = time.perf_counter()
    procs = []
    for name, obj, lg in zip(KERNEL_SOURCES, objs, logs):
        with open(lg, "w") as f:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
                stdout=f, stderr=subprocess.STDOUT))
    seconds = {}
    while len(seconds) < len(procs):
        for i, proc in enumerate(procs):
            if i not in seconds and proc.poll() is not None:
                seconds[i] = time.perf_counter() - t0
        time.sleep(0.1)
    log = ""
    for i, (name, lg) in enumerate(zip(KERNEL_SOURCES, logs)):
        log += lg.read_text() + f"nvcc {name}: {seconds[i]:.1f} s\n"
        lg.unlink()
    rcs = [p.returncode for p in procs]
    if not any(rcs):
        tmp = Path(f"{stem}.tmp")
        # an instance a header declares and no source compiles fails here
        link = subprocess.run([nvcc, "-shared", "-Xlinker", "--no-undefined", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        log += link.stdout + link.stderr
        rcs.append(link.returncode)
    for obj in objs:
        obj.unlink(missing_ok=True)
    path.with_suffix(".log").write_text(log)
    if any(rcs):
        raise RuntimeError(f"nvcc failed with exit codes {rcs}:\n{log}")
    os.replace(tmp, path)
    return path


def build_log() -> str:
    """The compiler's report of the current build."""
    return library_path().with_suffix(".log").read_text()


#: the on-demand instances' sources, the headers they read, and the names in
#: their libraries' names
EW_SOURCE = CSRC / "ondemand" / "ew_instance.cu"
MM_SOURCE = CSRC / "ondemand" / "mm_instance.cu"
HEADERS = tuple(sorted(p.name for p in CSRC.glob("*.cuh")))
VARIANT_NAMES = ("mjhmc", "nuts", "control", "malt")
ENERGY_NAMES = ("rough_well", "gaussian", "funnel", "banana", "mog", "eight_schools",
                "eight_schools_nc")
MM_ENERGY_NAMES = ("product_of_t", "sparse_coding", "logreg")
PRECISION_NAMES = ("highest", "bf16x3", "bf16x2", "default")
#: argument types of the on-demand instances' entries (ondemand/*_instance.cu)
EW_ENTRIES = (("mjhmc_od_launch", tuple(LAUNCH_ARGTYPES)),
              ("mjhmc_od_ew_tile", tuple(EW_TILE_ARGTYPES)),
              ("mjhmc_od_nuts_tile", tuple(NUTS_TILE_ARGTYPES)))
MM_ENTRIES = (("mjhmc_mm_od_launch", tuple(MM_LAUNCH_ARGTYPES)),
              ("mjhmc_mm_od_tile", tuple(MM_TILE_ARGTYPES)),
              ("mjhmc_mm_od_nuts_tile", tuple(MM_NUTS_TILE_ARGTYPES)))


class Instance(NamedTuple):
    """One on-demand instance: the source one nvcc compiles, its ``-D``
    macros, the stem of its library's name and its C entries with their
    argument types."""

    source: Path
    macros: tuple
    stem: str
    entries: tuple


def ew_instance(variant: int, energy: int, ndims: int, mog_cap: int) -> Instance:
    """The elementwise instance of step body ``variant`` on energy
    ``energy`` (the kernel's ids) at ``ndims`` dims, mixtures of at most
    ``mog_cap`` components."""
    return Instance(
        EW_SOURCE,
        (f"-DMJHMC_OD_VARIANT={variant}", f"-DMJHMC_OD_ENERGY={energy}",
         f"-DMJHMC_OD_DIMS={ndims}", f"-DMJHMC_MOG_MAX_COMPONENTS={mog_cap}"),
        f"libmjhmc_ew_{VARIANT_NAMES[variant]}_{ENERGY_NAMES[energy]}_d{ndims}_k{mog_cap}",
        EW_ENTRIES)


def mm_instance(variant: int, energy: int, ndims: int, krows: int, precision: int,
                offchip: bool, chunk: int = 0, xg_off: bool = False) -> Instance:
    """The matmul instance of step body ``variant`` on energy ``energy``
    (the kernel's ids) at (``ndims``, ``krows``) and dot ``precision``, the
    parameter matrix in a device buffer where ``offchip``; a chunked tile
    (``chunk`` rows of the intermediate at a time) also names its chunk and
    whether X and G live in the device buffer (``xg_off``)."""
    chunked = (f"-DMJHMC_MM_OD_CHUNK={chunk}", f"-DMJHMC_MM_OD_XG={int(xg_off)}") if chunk else ()
    return Instance(
        MM_SOURCE,
        (f"-DMJHMC_MM_OD_VARIANT={variant}", f"-DMJHMC_MM_OD_ENERGY={energy}",
         f"-DMJHMC_MM_OD_DIMS={ndims}", f"-DMJHMC_MM_OD_KROWS={krows}",
         f"-DMJHMC_MM_OD_PRECISION={precision}", f"-DMJHMC_MM_OD_OFFCHIP={int(offchip)}",
         *chunked),
        f"libmjhmc_mm_{VARIANT_NAMES[variant]}_{MM_ENERGY_NAMES[energy]}_d{ndims}_k{krows}_"
        f"{PRECISION_NAMES[precision]}{'_off' if offchip else ''}"
        f"{f'_kc{chunk}' if chunk else ''}{'_xg' if xg_off else ''}",
        MM_ENTRIES)


def instance_path(inst: Instance) -> Path:
    """Where the on-demand instance's library lives: named by its key,
    keyed by a hash of its source, the headers, the flags and the macros."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + inst.macros).encode())
    h.update(inst.source.read_bytes())
    for name in HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{inst.stem}_{h.hexdigest()[:16]}.so"


def instance_command(inst: Instance, out: Path) -> list:
    """The one nvcc that compiles and links the on-demand instance into
    ``out``, refusing undefined symbols."""
    return [_nvcc(), *NVCC_FLAGS, *inst.macros, "-shared", "-Xlinker", "--no-undefined", "-o",
            str(out), str(inst.source)]


_INSTANCE_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()


def build_instance(inst: Instance) -> tuple[Path, float | None]:
    """Compile the on-demand instance unless it is built; one build of a
    key at a time in a process. Returns (the library, the seconds nvcc took
    in this call, or None where the library was built before and reused).
    The compiler's report goes to the library's ``.log``; a failed nvcc
    raises ``RuntimeError``."""
    path = instance_path(inst)
    with _LOCKS_GUARD:
        lock = _INSTANCE_LOCKS.setdefault(path, threading.Lock())
    with lock:
        if path.exists():
            return path, None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(instance_command(inst, tmp), capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr + f"nvcc {path.name}: {seconds:.1f} s\n"
        path.with_suffix(".log").write_text(log)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode} on the on-demand "
                               f"instance {path.name}:\n{log}")
        os.replace(tmp, path)
    return path, seconds


def instance_log(inst: Instance) -> str:
    """The compiler's report of an on-demand instance's build."""
    return instance_path(inst).with_suffix(".log").read_text()


@functools.cache
def load_instance(inst: Instance) -> ctypes.CDLL:
    """Build (first use) and load the on-demand instance; typed entries. A
    failed build or load raises ``RuntimeError``."""
    path, _ = build_instance(inst)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"loading the on-demand instance {path.name} failed: {e}") from e
    for name, argtypes in inst.entries:
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first use) and load the library; typed launch functions."""
    lib = ctypes.CDLL(str(build()))
    for fn, argtypes in ((lib.mjhmc_engine_launch, LAUNCH_ARGTYPES),
                         (lib.mjhmc_nuts_profile, PROFILE_ARGTYPES),
                         (lib.mjhmc_ew_profile, PROFILE_ARGTYPES),
                         (lib.mjhmc_nuts_tile, NUTS_TILE_ARGTYPES),
                         (lib.mjhmc_ew_tile, EW_TILE_ARGTYPES),
                         (lib.mjhmc_sincos_probe, [_P, _P, _I, _P]),
                         (lib.mjhmc_mm_engine_launch, MM_LAUNCH_ARGTYPES),
                         (lib.mjhmc_mm_nuts_profile, MM_PROFILE_ARGTYPES),
                         (lib.mjhmc_mm_profile, MM_PROFILE_ARGTYPES),
                         (lib.mjhmc_mm_nuts_tile, MM_NUTS_TILE_ARGTYPES),
                         (lib.mjhmc_mm_tile, MM_TILE_ARGTYPES),
                         (lib.fma_chain_launch, FMA_CHAIN_ARGTYPES),
                         (lib.tc_chain_launch, TC_CHAIN_ARGTYPES),
                         (lib.tc_chain_lanes, [_I])):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
