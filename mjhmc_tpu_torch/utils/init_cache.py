"""Shared burned-in initial states, cached to disk (counterpart of
``mjhmc_tpu.utils.init_cache``).

All samplers for a given distribution start from the same burned-in chain
states so comparisons are fair. States are generated once with a long
control-HMC burn-in (dual-averaged ε) and cached as ``.npz`` under the JAX
package's key, the distribution's stable hash + batch size + burn length +
seed. The cache directory is the port's own: its draws differ from JAX's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution
from mjhmc_tpu_torch.samplers.state import checked_device

DEFAULT_CACHE_DIR = os.path.join(
    os.path.expanduser("~"), ".cache", "mjhmc_tpu_torch", "init"
)


def burned_in_init(
    dist: Distribution,
    nbatch: int,
    cache_dir: str | None = None,
    burn_steps: int = 1000,
    epsilon: float | None = None,
    seed: int = 1234,
    refresh: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Return (ndims, nbatch) burned-in positions on ``device``, generating
    and caching them once. ``cache_dir`` defaults to ``DEFAULT_CACHE_DIR``,
    read when called."""
    device = checked_device(device, "burned_in_init")
    cache_dir = DEFAULT_CACHE_DIR if cache_dir is None else cache_dir
    key = f"{dist.stable_hash()}_n{nbatch}_b{burn_steps}_s{seed}"
    path = os.path.join(cache_dir, key + ".npz")
    if not refresh and os.path.exists(path):
        with np.load(path) as data:
            return torch.as_tensor(data["x"], device=device)

    from mjhmc_tpu_torch.samplers import make_hmc_state
    from mjhmc_tpu_torch.samplers.adaptation import adaptive_hmc_run, da_init

    state = make_hmc_state(dist, torch.Generator().manual_seed(seed), nbatch, device)
    da = da_init(epsilon if epsilon is not None else 0.5)
    state, da, _ = adaptive_hmc_run(dist, state, da, torch.Generator().manual_seed(seed + 1),
                                    burn_steps, 1.0, 10, 0.8)
    x = state.chain.x.cpu().numpy()
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(path, x=x)
    return state.chain.x
