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
from mjhmc_tpu_torch.inference.smc import SMCState
from mjhmc_tpu_torch.inference.vi import ADVIParams, LowRankADVIParams
from mjhmc_tpu_torch.samplers.chees import CheesState
from mjhmc_tpu_torch.samplers.state import ChainState, HMCState, MJState
from mjhmc_tpu_torch.samplers.tempering import PTState

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


def _tensor(a, dtype, device):
    return torch.as_tensor(np.asarray(a).astype(dtype), device=device)


def pt_state_from_jax(x, u, grad, grad_evals, n_accept, n_swap_acc, n_swap_try, replica_id,
                      seen_hot, round_trips, n_iter=0, device="cpu") -> PTState:
    """Turn NumPy arrays of a JAX ``PTState`` (fields in its order; a
    missing ``n_iter`` is 0) into the port's ``PTState``."""
    f, i = np.float32, np.int32
    return PTState(
        x=_tensor(x, f, device), u=_tensor(u, f, device), grad=_tensor(grad, f, device),
        grad_evals=_tensor(grad_evals, i, device), n_accept=_tensor(n_accept, i, device),
        n_swap_acc=_tensor(n_swap_acc, i, device), n_swap_try=_tensor(n_swap_try, i, device),
        replica_id=_tensor(replica_id, i, device), seen_hot=_tensor(seen_hot, bool, device),
        round_trips=_tensor(round_trips, i, device),
        n_iter=_tensor(0 if n_iter is None else n_iter, i, device),
    )


def chees_state_from_jax(log_tau, m_adam, v_adam, step, device="cpu") -> CheesState:
    """Turn a JAX ``CheesState``'s scalars into the port's."""
    f = np.float32
    return CheesState(log_tau=_tensor(log_tau, f, device), m_adam=_tensor(m_adam, f, device),
                      v_adam=_tensor(v_adam, f, device), step=_tensor(step, np.int32, device))


def smc_state_from_jax(x, log_w, lam, log_z, eps, key=None, log_tau=0.0, chees_m=0.0,
                       chees_v=0.0, chees_step=0, device="cpu") -> SMCState:
    """Turn NumPy arrays of a JAX ``SMCState`` (fields in its order) into
    the port's; the JAX state's ``key`` has no counterpart (the port draws
    from a ``torch.Generator`` passed beside the state) and is dropped."""
    f = np.float32
    return SMCState(x=_tensor(x, f, device), log_w=_tensor(log_w, f, device),
                    lam=_tensor(lam, f, device), log_z=_tensor(log_z, f, device),
                    eps=_tensor(eps, f, device), log_tau=_tensor(log_tau, f, device),
                    chees_m=_tensor(chees_m, f, device), chees_v=_tensor(chees_v, f, device),
                    chees_step=_tensor(chees_step, np.int32, device))


def advi_params_from_jax(mu, omega, device="cpu") -> ADVIParams:
    """Turn a JAX ``ADVIParams``'s arrays into the port's."""
    return ADVIParams(mu=_tensor(mu, np.float32, device), omega=_tensor(omega, np.float32, device))


def lowrank_advi_params_from_jax(mu, omega, b, device="cpu") -> LowRankADVIParams:
    """Turn a JAX ``LowRankADVIParams``'s arrays into the port's."""
    f = np.float32
    return LowRankADVIParams(mu=_tensor(mu, f, device), omega=_tensor(omega, f, device),
                             b=_tensor(b, f, device))
