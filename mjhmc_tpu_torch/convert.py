"""Carry distributions and chain states across from the JAX package.

Both directions go through plain Python and NumPy, so this module imports
no JAX: the JAX side hands over ``dist.config_dict()`` and ``np.asarray``
of its arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from mjhmc_tpu_torch.models import (
    Banana,
    EightSchools,
    Funnel,
    Gaussian,
    GaussianMixture,
    LogisticRegression,
    ProductOfT,
    RoughWell,
    SparseCoding,
)
from mjhmc_tpu_torch.samplers.state import ChainState, HMCState, MJState

_PORTED = {
    "RoughWell": RoughWell,
    "Gaussian": Gaussian,
    "ProductOfT": ProductOfT,
    "SparseCoding": SparseCoding,
    "LogisticRegression": LogisticRegression,
    "Funnel": Funnel,
    "Banana": Banana,
    "GaussianMixture": GaussianMixture,
    "EightSchools": EightSchools,
}


def _tupled(v):
    """A (nested) list as (nested) tuples: ``config_dict`` turns the
    distributions' tuple fields into lists, and the frozen dataclasses
    hash only with tuples."""
    return tuple(_tupled(e) for e in v) if isinstance(v, (list, tuple)) else v


def distribution_from_jax(config_dict: dict):
    """The port's distribution for a JAX distribution's ``config_dict()``."""
    cfg = dict(config_dict)
    name = cfg.pop("__class__")
    if name not in _PORTED:
        raise KeyError(f"no distribution {name!r} in the port; it has {sorted(_PORTED)}")
    return _PORTED[name](**{k: _tupled(v) for k, v in cfg.items()})


def _chains_last(a, per_dim: bool) -> np.ndarray:
    """Undo the Pallas engine's (d, 8, L) / (8, L) fold, row-major, exactly
    as ``PallasMJHMC.__post_init__`` made it from (d, n) / (n,)."""
    a = np.asarray(a)
    return a.reshape(a.shape[0], -1) if per_dim else a.reshape(-1)


def _chain_from_jax(x, v, grad, u, device):
    f32 = np.float32

    def state(a):
        return torch.as_tensor(_chains_last(a, True).astype(f32), device=device)

    return ChainState(x=state(x), v=state(v),
                      u=torch.as_tensor(_chains_last(u, False).astype(f32), device=device),
                      grad=state(grad))


def _scalar(a, n, dtype, device):
    a = np.zeros((n,)) if a is None else _chains_last(a, False)
    return torch.as_tensor(a.astype(dtype), device=device)


def state_from_jax(x, v, grad, u, h_back=None, back_valid=None,
                   grad_evals=None, dwell_sum=None, device="cpu") -> MJState:
    """Turn NumPy arrays of a JAX chain state into the port's ``MJState``.

    Takes either JAX layout: ``MJState``'s (d, n) / (n,) or the Pallas
    engine's (d, 8, L) / (8, L). Missing cache and counters start empty.
    """
    n = _chains_last(x, True).shape[1]
    return MJState(
        chain=_chain_from_jax(x, v, grad, u, device),
        h_back=_scalar(h_back, n, np.float32, device),
        back_valid=_scalar(back_valid, n, bool, device),
        grad_evals=_scalar(grad_evals, n, np.int32, device),
        dwell_sum=_scalar(dwell_sum, n, np.float32, device),
    )


def hmc_state_from_jax(x, v, grad, u, grad_evals=None, n_accept=None,
                       device="cpu") -> HMCState:
    """Turn NumPy arrays of a JAX ``HMCState`` (control HMC, MALT) into the
    port's ``HMCState``; missing counters start at 0."""
    n = _chains_last(x, True).shape[1]
    return HMCState(
        chain=_chain_from_jax(x, v, grad, u, device),
        grad_evals=_scalar(grad_evals, n, np.int32, device),
        n_accept=_scalar(n_accept, n, np.int32, device),
    )
