"""Tracing and debug instrumentation (counterpart of
``mjhmc_tpu.utils.profiling``).

- ``trace(...)``: ``torch.profiler`` around a block (CPU, and the card's
  kernels where there is one), writing a Chrome trace into a directory.
- ``debug_mode(...)``: raise ``FloatingPointError`` at the first torch
  operation whose output holds a NaN, the counterpart of
  ``jax_debug_nans`` (a NaN in a sampler raises where it is made instead of
  propagating silently through the masked blends).
- ``parse_trace_collectives(...)``: the share of a ``trace(...)``'s time
  spent in collectives (the receipt behind the scaling bound).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
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


#: name prefixes (lower case) of the collectives in a torch profiler trace:
#: NCCL's device kernels (``ncclDevKernel_AllReduce...``) and host ops
#: (``nccl:all_reduce``), gloo's (``gloo:all_reduce``) and the c10d
#: dispatcher's (``c10d::allreduce_``)
_COLLECTIVE_PREFIXES = ("nccl", "gloo:", "c10d")


def _is_collective(name: str) -> bool:
    return name.lower().startswith(_COLLECTIVE_PREFIXES)


def _outermost(events: list) -> list:
    """The events of one thread that no other of them contains (the torch
    trace nests a CPU op's children inside it)."""
    out, end = [], -float("inf")
    for ev in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        if ev["ts"] >= end:
            out.append(ev)
            end = ev["ts"] + ev["dur"]
    return out


def parse_trace_collectives(log_dir: str) -> dict:
    """Communication accounting from a ``trace(...)`` directory (counterpart
    of JAX's, on the torch profiler's Chrome trace).

    Reads the newest ``trace.json`` under ``log_dir`` (searched
    recursively: ``trace()`` of a sharded run writes ``DIR/rank<r>/``).
    Where the trace holds device kernels (``"cat": "kernel"``), the total
    and the collective time are summed over those kernels alone, the NCCL
    kernels being the collectives; otherwise over the CPU ops and
    annotations, the gloo, c10d and NCCL ops being the collectives. On the
    CPU only the outermost events of each thread count (and of the
    collectives the outermost collective), since the trace nests ops
    inside one another and JAX's rule, every complete event, would count
    the same time twice. Returns ``{total_us, collective_us, fraction,
    by_op (the ten largest), trace}``."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*trace.json*"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        return {"total_us": 0.0, "collective_us": 0.0, "fraction": 0.0, "by_op": {},
                "trace": None}
    path = paths[-1]
    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
        events = [ev for ev in json.load(f).get("traceEvents", [])
                  if ev.get("ph") == "X" and ev.get("dur") is not None]
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    if kernels:
        counted, colls = kernels, [ev for ev in kernels if _is_collective(str(ev["name"]))]
    else:
        threads: dict = {}
        for ev in events:
            if ev.get("cat") in ("cpu_op", "user_annotation"):
                threads.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
        counted, colls = [], []
        for evs in threads.values():
            counted += _outermost(evs)
            colls += _outermost([ev for ev in evs if _is_collective(str(ev["name"]))])
    by_op: dict = {}
    for ev in colls:
        by_op[str(ev["name"])] = by_op.get(str(ev["name"]), 0.0) + float(ev["dur"])
    total = float(sum(float(ev["dur"]) for ev in counted))
    coll = float(sum(by_op.values()))
    return {"total_us": total, "collective_us": coll, "fraction": coll / total if total else 0.0,
            "by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:10]), "trace": path}
