"""Carry distributions and chain states across from the JAX package.

Both directions go through plain Python and NumPy, so this module imports
no JAX: the JAX side hands over ``dist.config_dict()`` and ``np.asarray``
of its arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from mjhmc_tpu_torch.models import Gaussian, ProductOfT, RoughWell, SparseCoding
from mjhmc_tpu_torch.samplers.state import ChainState, MJState

_PORTED = {
    "RoughWell": RoughWell,
    "Gaussian": Gaussian,
    "ProductOfT": ProductOfT,
    "SparseCoding": SparseCoding,
}


def distribution_from_jax(config_dict: dict):
    """The port's distribution for a JAX distribution's ``config_dict()``."""
    cfg = dict(config_dict)
    name = cfg.pop("__class__")
    if name not in _PORTED:
        raise NotImplementedError(
            f"distribution {name} is not ported yet: the zoo models (Funnel, "
            "Banana, GaussianMixture, EightSchools, LogisticRegression) come "
            "with slice D (ROADMAP.md, 'Modules to port')"
        )
    if cfg.get("custom_patch") is not None:  # config_dict makes tuples lists
        cfg["custom_patch"] = tuple(cfg["custom_patch"])
    return _PORTED[name](**cfg)


def _chains_last(a, per_dim: bool) -> np.ndarray:
    """Undo the Pallas engine's (d, 8, L) / (8, L) fold, row-major, exactly
    as ``PallasMJHMC.__post_init__`` made it from (d, n) / (n,)."""
    a = np.asarray(a)
    return a.reshape(a.shape[0], -1) if per_dim else a.reshape(-1)


def state_from_jax(x, v, grad, u, h_back=None, back_valid=None,
                   grad_evals=None, dwell_sum=None, device="cpu") -> MJState:
    """Turn NumPy arrays of a JAX chain state into the port's ``MJState``.

    Takes either JAX layout: ``MJState``'s (d, n) / (n,) or the Pallas
    engine's (d, 8, L) / (8, L). Missing cache and counters start empty.
    """
    f32 = np.float32
    n = _chains_last(x, True).shape[1]

    def state(a):
        return torch.as_tensor(_chains_last(a, True).astype(f32), device=device)

    def scalar(a, dtype):
        a = np.zeros((n,)) if a is None else _chains_last(a, False)
        return torch.as_tensor(a.astype(dtype), device=device)

    chain = ChainState(x=state(x), v=state(v), u=scalar(u, f32), grad=state(grad))
    return MJState(
        chain=chain,
        h_back=scalar(h_back, f32),
        back_valid=scalar(back_valid, bool),
        grad_evals=scalar(grad_evals, np.int32),
        dwell_sum=scalar(dwell_sum, f32),
    )
