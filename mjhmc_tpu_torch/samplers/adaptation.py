"""Dual-averaging step-size adaptation and Stan-style warmup, plain PyTorch
(counterpart of ``mjhmc_tpu.samplers.adaptation``; Hoffman & Gelman,
arXiv:1111.4246 §3.2).

The sampler steps run on the chains' device; each iteration's acceptance
statistic is averaged over all chains and fed to Nesterov dual averaging
on log ε. The dual-averaging state is a handful of host float32 scalars,
updated with the JAX package's float32 arithmetic in its order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution
from mjhmc_tpu_torch.samplers.hmc import hmc_step
from mjhmc_tpu_torch.samplers.malt import malt_step
from mjhmc_tpu_torch.samplers.mjhmc import MomentAccumulator, mjhmc_step
from mjhmc_tpu_torch.samplers.nuts import NUTSState, make_nuts_state, nuts_step
from mjhmc_tpu_torch.samplers.state import HMCState, MJState, checked_device, make_mj_state

Tensor = torch.Tensor
_F = np.float32


class DualAveragingState(NamedTuple):
    step: int
    log_eps: np.float32  # current log step size
    log_eps_bar: np.float32  # averaged iterate (the one to freeze)
    h_bar: np.float32  # running error statistic
    mu: np.float32  # shrinkage target


def _da_start(log_eps0) -> DualAveragingState:
    return DualAveragingState(0, log_eps0, log_eps0, _F(0.0), np.log(_F(10.0)) + log_eps0)


def da_init(eps0: float) -> DualAveragingState:
    return _da_start(np.log(_F(eps0)))


def da_update(
    da: DualAveragingState,
    accept_mean,
    target: float = 0.65,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    step = da.step + 1
    stepf = _F(step)
    frac = _F(1.0) / (stepf + _F(t0))
    h_bar = (_F(1.0) - frac) * da.h_bar + frac * (_F(target) - _F(float(accept_mean)))
    log_eps = da.mu - np.sqrt(stepf) / _F(gamma) * h_bar
    eta = stepf ** _F(-kappa)
    log_eps_bar = eta * log_eps + (_F(1.0) - eta) * da.log_eps_bar
    return DualAveragingState(step, log_eps, log_eps_bar, h_bar, da.mu)


def da_epsilon(da: DualAveragingState, frozen: bool = False) -> float:
    return float(np.exp(da.log_eps_bar if frozen else da.log_eps))


def _adapt(step, state, da, num_steps, target_accept, weight, mean=torch.mean):
    """``num_steps`` of ``step(state, eps) -> (state, out)`` with a dual-
    averaging update each on ``mean(out.accept_stat)``; accumulates the
    moments of ``out.x`` with ``weight(out)``. Returns (state, da,
    {"moments", "eps_trace"})."""
    acc, trace = None, []
    for _ in range(num_steps):
        eps = da_epsilon(da)
        state, out = step(state, eps)
        da = da_update(da, mean(out.accept_stat), target=target_accept)
        if acc is None:
            acc = MomentAccumulator.init(*out.x.shape, out.x.device)
        acc = acc.update(out.x, weight(out))
        trace.append(eps)
    return state, da, {"moments": acc, "eps_trace": torch.tensor(trace, dtype=torch.float32)}


def adaptive_mjhmc_run(
    dist: Distribution,
    state: MJState,
    da: DualAveragingState,
    generator: torch.Generator,
    num_steps: int,
    beta: float,
    num_leapfrog_steps: int,
    target_accept: float = 0.65,
    mesh=None,
) -> Tuple[MJState, DualAveragingState, dict]:
    """Warmup run: an MJHMC step and a dual-averaging ε update each
    iteration, with the dwell-weighted moments. Under a ``mesh`` (the
    state this rank's block, the generator the same on every rank) the
    acceptance mean is over all chains: one all_reduce per iteration, the
    one collective of the loop (JAX's psum of ``jnp.mean(accept_stat)``)."""
    block, mean = None, torch.mean
    if mesh is not None:
        from mjhmc_tpu_torch.parallel.collectives import chain_mean

        block = mesh.block(*state.chain.x.shape)
        mean = functools.partial(chain_mean, mesh=mesh)
    return _adapt(lambda s, eps: mjhmc_step(dist, s, generator, eps, beta, num_leapfrog_steps,
                                            block=block),
                  state, da, num_steps, target_accept, lambda o: o.dwell, mean)


def adaptive_hmc_run(
    dist: Distribution,
    state: HMCState,
    da: DualAveragingState,
    generator: torch.Generator,
    num_steps: int,
    beta: float,
    num_leapfrog_steps: int,
    target_accept: float = 0.65,
) -> Tuple[HMCState, DualAveragingState, dict]:
    """Warmup run for control HMC with dual averaging."""
    return _adapt(lambda s, eps: hmc_step(dist, s, generator, eps, beta, num_leapfrog_steps),
                  state, da, num_steps, target_accept, lambda o: torch.ones_like(o.accept_stat))


def adaptive_malt_run(
    dist: Distribution,
    state: HMCState,
    da: DualAveragingState,
    generator: torch.Generator,
    num_steps: int,
    gamma: float,
    num_leapfrog_steps: int,
    target_accept: float = 0.8,
) -> Tuple[HMCState, DualAveragingState, dict]:
    """Warmup run for MALT with dual averaging on the step size (the MALT
    paper targets ~0.8: Δ aggregates M leapfrog errors)."""
    return _adapt(lambda s, eps: malt_step(dist, s, generator, eps, gamma, num_leapfrog_steps),
                  state, da, num_steps, target_accept, lambda o: torch.ones_like(o.accept_stat))


def estimate_inv_mass(acc: MomentAccumulator) -> Tensor:
    """Diagonal M⁻¹ from the weighted sample variances (Stan-style: M⁻¹ =
    the posterior variance), shape (ndims, 1)."""
    w = acc.w.sum()
    mean = acc.wx.sum(dim=1) / w
    var = acc.wx2.sum(dim=1) / w - mean * mean
    return var.clamp(min=1e-8)[:, None]


def mjhmc_full_warmup(
    dist: Distribution,
    generator: torch.Generator,
    nbatch: int,
    beta: float = 0.1,
    num_leapfrog_steps: int = 5,
    eps0: float = 0.5,
    phase1: int = 300,
    phase2: int = 300,
    phase3: int = 200,
    target_accept: float = 0.65,
    device="cuda",
):
    """Stan-style three-phase warmup: (1) dual-average ε with unit mass,
    (2) keep adapting ε while accumulating variances → M⁻¹, (3) re-tune ε
    under the new metric. Returns (state, eps, inv_mass (ndims, 1))."""
    device = checked_device(device, "mjhmc_full_warmup")
    state = make_mj_state(dist, generator, nbatch, device)
    da = da_init(eps0)
    state, da, _ = adaptive_mjhmc_run(dist, state, da, generator, phase1, beta,
                                      num_leapfrog_steps, target_accept)
    state, da, aux = adaptive_mjhmc_run(dist, state, da, generator, phase2, beta,
                                        num_leapfrog_steps, target_accept)
    inv_mass = estimate_inv_mass(aux["moments"])
    ch = state.chain
    state = state._replace(  # momenta move to N(0, M); the old caches are invalid
        chain=ch._replace(v=ch.v / torch.sqrt(inv_mass)),
        back_valid=torch.zeros_like(state.back_valid),
    )
    # restart dual averaging from the frozen phase-2 ε
    da = _da_start(da.log_eps_bar)
    for _ in range(phase3):
        state, out = mjhmc_step(dist, state, generator, da_epsilon(da), beta,
                                num_leapfrog_steps, inv_mass=inv_mass)
        da = da_update(da, out.accept_stat.mean(), target=target_accept)
    return state, da_epsilon(da, frozen=True), inv_mass


def nuts_full_warmup(
    dist: Distribution,
    generator: torch.Generator,
    nbatch: int,
    eps0: float = 0.5,
    max_depth: int = 8,
    phase1: int = 60,
    phase2: int = 60,
    phase3: int = 40,
    target_accept: float = 0.8,
    device="cuda",
) -> Tuple[NUTSState, float, Tensor]:
    """Stan-style NUTS warmup, the three phases of ``mjhmc_full_warmup`` on
    ``nuts_step``. Returns (state, eps, inv_mass (ndims, 1))."""
    device = checked_device(device, "nuts_full_warmup")
    state = make_nuts_state(dist, generator, nbatch, device)

    def phase(state, da, num_steps, inv_mass):
        return _adapt(lambda s, eps: nuts_step(dist, s, generator, eps, max_depth,
                                               inv_mass=inv_mass),
                      state, da, num_steps, target_accept, lambda o: torch.ones_like(o.accept_stat))

    da = da_init(eps0)
    state, da, _ = phase(state, da, phase1, None)
    state, da, aux = phase(state, da, phase2, None)
    inv_mass = estimate_inv_mass(aux["moments"])
    state, da, _ = phase(state, _da_start(da.log_eps_bar), phase3, inv_mass)
    return state, da_epsilon(da, frozen=True), inv_mass
