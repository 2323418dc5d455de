"""Benchmark timing helpers (counterpart of ``mjhmc_tpu.utils.timing``).

PyTorch returns before the card finishes, so every timing synchronises
the devices of its values (``torch.cuda.synchronize`` where JAX has
``block_until_ready``): asynchronous launches cannot fake throughput.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from mjhmc_tpu_torch.utils.pytree import tree_leaves


def block_until_ready(value):
    """Wait for the CUDA devices holding ``value``'s tensors; returns it."""
    for dev in {t.device for t in tree_leaves(value) if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return value


class Timer:
    """Context manager: wall clock with a device sync on exit."""

    def __init__(self, sync_value=None):
        self._sync_value = sync_value
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync_value is not None:
            block_until_ready(self._sync_value)
        self.elapsed = time.perf_counter() - self._t0
        return False


def steps_per_second(fn: Callable, *args, warmup: int = 1, iters: int = 3, **kw):
    """Time ``fn(*args, **kw)`` (which must return its tensors); returns
    (best_seconds, last_result). Warmup runs absorb the kernels' build
    and first launch."""
    result = None
    for _ in range(warmup):
        result = block_until_ready(fn(*args, **kw))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        result = block_until_ready(fn(*args, **kw))
        best = min(best, time.perf_counter() - t0)
    return best, result
