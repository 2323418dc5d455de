"""Build the engine's CUDA library from ``csrc/`` with nvcc and load it with
ctypes.

The library has a plain C interface, so nvcc compiles it in seconds (no
PyTorch headers). It is built at first use into ``build/mjhmc_tpu_torch/``
beside the package, under a name keyed by a hash of the sources and flags,
so an edited source builds anew and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("mjhmc_engine.cu", "philox.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mjhmc_tpu_torch"
# no --use_fast_math: the rough well's sin/cos arguments reach ~100 rad
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: argument types of ``mjhmc_engine_launch`` (csrc/mjhmc_engine.cu)
LAUNCH_ARGTYPES = (
    [_I, _I, _P] + [_F] * 5  # ndims, energy, params, k0..k4
    + [_P] * 6  # x, v, g, u, h_back, valid
    + [_P] * 10  # xo, vo, go, uo, hbo, valido, w, wx, wx2, evals
    + [_P] * 3  # xs, ws, es
    + [_I] * 4  # n, num_iters, thin, m
    + [ctypes.c_uint, _F, _F, _I, _P]  # seed, eps, beta, fixed_uniform, stream
)


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
    tmp = path.parent / f"{path.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "mjhmc_engine.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    path.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{log}")
    os.replace(tmp, path)
    return path


def build_log() -> str:
    """The compiler's report of the current build."""
    return library_path().with_suffix(".log").read_text()


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first use) and load the library; typed ``mjhmc_engine_launch``."""
    lib = ctypes.CDLL(str(build()))
    lib.mjhmc_engine_launch.argtypes = LAUNCH_ARGTYPES
    lib.mjhmc_engine_launch.restype = ctypes.c_int
    return lib
