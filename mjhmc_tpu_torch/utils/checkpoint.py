"""Checkpoint / resume of full sampler state (counterpart of
``mjhmc_tpu.utils.checkpoint``).

A checkpoint holds the *entire* carry: chain states, caches, counters,
adaptation state and the ``torch.Generator``s (the counterpart of JAX's
PRNG-key leaves), so a resumed run is bit-exact. Plain ``.npz``; tensors
come to the host once (checkpointing is rare and off the hot path).

Trees are NamedTuples, tuples, lists and dicts (``utils.pytree``). The
structure is not stored: restoring takes an example tree of the same
structure (a fresh state) and refills its leaves, on the example's
devices and dtypes.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from mjhmc_tpu_torch.utils.pytree import tree_leaves, tree_unflatten

Tensor = torch.Tensor


def _host(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, Tensor) else np.asarray(leaf)


def _restore(arr: np.ndarray, like):
    """``arr`` as a leaf of ``like``'s kind: a tensor on its device and
    dtype, or a scalar of its type."""
    if isinstance(like, Tensor):
        return torch.from_numpy(np.array(arr)).to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.generic):
        return type(like)(arr.item())
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return arr


def _generator(state: np.ndarray, like: torch.Generator) -> torch.Generator:
    gen = torch.Generator(device=like.device)
    gen.set_state(torch.from_numpy(np.array(state)))
    return gen


def _write(path: str, arrays: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def save_pytree(path: str, tree: Any) -> None:
    """Save every leaf of a tree to ``path`` (.npz)."""
    arrays = {}
    for i, leaf in enumerate(tree_leaves(tree)):
        if isinstance(leaf, torch.Generator):
            arrays[f"leaf_{i}__rng"] = leaf.get_state().numpy()
        else:
            arrays[f"leaf_{i}"] = _host(leaf)
    _write(path, arrays)


def load_pytree(path: str, example: Any) -> Any:
    """Load leaves saved by ``save_pytree`` into ``example``'s structure."""
    data = np.load(path)
    leaves = []
    for i, leaf in enumerate(tree_leaves(example)):
        if f"leaf_{i}__rng" in data:
            leaves.append(_generator(data[f"leaf_{i}__rng"], leaf))
        else:
            leaves.append(_restore(data[f"leaf_{i}"], leaf))
    return tree_unflatten(example, leaves)


# ---------------------------------------------------------------------------
# Multi-process checkpoints. Each rank holds only its block of the chains
# (``parallel.mesh``) and writes exactly that, with the block's index in
# the global arrays; resume reads the rank's file and matches every block
# BY INDEX, so restoring under another sharding fails loudly.
# ---------------------------------------------------------------------------
def _shard_file(path_prefix: str) -> str:
    return f"{path_prefix}.proc{dist.get_rank()}of{dist.get_world_size()}.npz"


def _block_index(leaf, mesh) -> np.ndarray:
    """[[start, stop], ...] of a leaf in the global arrays: a tensor's last
    axis is this rank's block of the chains, every other axis and every
    scalar is whole."""
    shape = tuple(leaf.shape) if isinstance(leaf, Tensor) else np.shape(leaf)
    idx = np.zeros((len(shape), 2), np.int64)
    idx[:, 1] = shape
    if shape:
        r, n = mesh.axis_index(), shape[-1]
        idx[-1] = (r * n, (r + 1) * n)
    return idx


def save_sharded_pytree(path_prefix: str, tree: Any, mesh) -> str:
    """Per-process save of this rank's blocks; returns the file's path,
    ``<prefix>.proc<i>of<n>.npz``. Every tensor of ``tree`` is taken for
    this rank's block of the chain axis of a ("chains",) ``mesh``, as
    ``parallel.mesh.shard_chain_pytree`` leaves a sampler state;
    generators are stored as they are (each rank its own)."""
    arrays: dict[str, np.ndarray] = {}
    for i, leaf in enumerate(tree_leaves(tree)):
        if isinstance(leaf, torch.Generator):
            arrays[f"leaf_{i}__rng"] = leaf.get_state().numpy()
            continue
        arrays[f"leaf_{i}"] = _host(leaf)
        arrays[f"leaf_{i}__idx"] = _block_index(leaf, mesh)
    path = _shard_file(path_prefix)
    _write(path, arrays)
    return path


def load_sharded_pytree(path_prefix: str, example: Any, mesh) -> Any:
    """Rebuild this rank's blocks from its shard file. ``example`` supplies
    structure, devices, dtypes and block shapes (a fresh state, sharded
    under the same mesh); a block the file does not hold at the example's
    index raises ``KeyError``."""
    data = np.load(_shard_file(path_prefix))
    leaves = []
    for i, leaf in enumerate(tree_leaves(example)):
        if f"leaf_{i}__rng" in data:
            leaves.append(_generator(data[f"leaf_{i}__rng"], leaf))
            continue
        idx = _block_index(leaf, mesh)
        if not np.array_equal(data[f"leaf_{i}__idx"], idx):
            raise KeyError(f"checkpoint {path_prefix!r} has no block {idx.tolist()} for "
                           f"leaf {i}: saved under a different sharding?")
        leaves.append(_restore(data[f"leaf_{i}"], leaf))
    return tree_unflatten(example, leaves)
