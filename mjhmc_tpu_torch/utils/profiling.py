"""Tracing and debug instrumentation (counterpart of
``mjhmc_tpu.utils.profiling``).

- ``trace(...)``: ``torch.profiler`` around a block (CPU, and the card's
  kernels where there is one), writing a Chrome trace into a directory.
- ``debug_mode(...)``: raise ``FloatingPointError`` at the first torch
  operation whose output holds a NaN, the counterpart of
  ``jax_debug_nans`` (a NaN in a sampler raises where it is made instead of
  propagating silently through the masked blends).
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
from torch.overrides import TorchFunctionMode

from mjhmc_tpu_torch.utils.pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile everything inside the block; yields the profiler, and writes
    ``<log_dir>/trace.json`` (Chrome/Perfetto) on exit (``log_dir``
    defaults to ``mjhmc_trace`` in the temporary directory)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "mjhmc_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _NanCheck(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(t.isnan().any()):
                raise FloatingPointError(f"NaN produced by {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Debug context: with ``nans``, raise at the operation that makes a NaN."""
    with _NanCheck() if nans else contextlib.nullcontext():
        yield
