"""MALT — Metropolis Adjusted Langevin Trajectories, plain PyTorch
(counterpart of ``mjhmc_tpu.samplers.malt``; arXiv:2210.12200).

Per iteration: a full momentum refresh v0 ~ N(0, M), then M OBABO steps —
O: v ← η·v + √(1−η²)·N(0, M) with η = exp(−γε/2); BAB: one leapfrog step
whose energy error H_out − H_in (measured inside the O pair, so the refresh
drops out) accumulates into Δ; O again — and one trajectory-level
Metropolis accept with p = min(1, exp(−Δ)). γ=0 is full-refresh HMC.
Exactly M gradient evaluations per iteration.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from mjhmc_tpu_torch.models.base import Distribution, randn
from mjhmc_tpu_torch.ops.leapfrog import momentum_scale, total_energy
from mjhmc_tpu_torch.samplers.hmc import TrajectorySampler, collect_run, draw_uniform
from mjhmc_tpu_torch.samplers.state import HMCState

Tensor = torch.Tensor


class MALTStepOut(NamedTuple):
    x: Tensor  # (ndims, nbatch) post-transition positions
    accept: Tensor  # (nbatch,) bool
    accept_stat: Tensor  # (nbatch,) min(1, exp(-Δ)) — dual-averaging signal


def malt_step(
    dist: Distribution,
    state: HMCState,
    generator: torch.Generator | None,
    epsilon: float,
    gamma: float,
    num_leapfrog_steps: int,
    inv_mass: Tensor | None = None,
    v0: Tensor | None = None,
    noise: Tensor | None = None,
    mh_uniform: Tensor | None = None,
) -> Tuple[HMCState, MALTStepOut]:
    """One MALT iteration across all chains.

    ``v0`` (ndims, nbatch) and ``noise`` (2M, ndims, nbatch) are the N(0, I)
    draws of the refresh and of the O half-steps in trajectory order (step
    k's two O-steps are rows 2k and 2k+1), ``mh_uniform`` (nbatch,) the
    Metropolis uniform: a test feeds the JAX step's ``k_v``/``k_traj``/
    ``k_mh`` draws. When absent they are drawn from ``generator``.
    """
    m = num_leapfrog_steps
    chain = state.chain
    x0, u0, g0 = chain.x, chain.u, chain.grad
    dev = x0.device
    eps = torch.as_tensor(epsilon, dtype=x0.dtype, device=dev)
    eta = torch.exp(-torch.as_tensor(gamma, dtype=torch.float32, device=dev) * eps / 2.0)
    sig = torch.sqrt((1.0 - eta * eta).clamp(min=0.0))
    scale = momentum_scale(inv_mass)
    if v0 is None:
        v0 = randn(generator, x0.shape, dev)
    if noise is None:
        noise = randn(generator, (2 * m, *x0.shape), dev)
    if mh_uniform is None:
        mh_uniform = draw_uniform(generator, x0.shape[1], dev)
    v0 = scale * v0

    x, v, g, u = x0, v0, g0, u0
    delta = torch.zeros_like(u0)
    for k in range(m):
        # O: exact OU half-step (leaves N(0, M) invariant — no energy term)
        v = eta * v + sig * scale * noise[2 * k]
        h_in = total_energy(u, v, inv_mass, dist)
        # BAB: one deterministic leapfrog step; its energy error enters Δ
        v_half = v - 0.5 * eps * g
        x = x + eps * (v_half if inv_mass is None else inv_mass * v_half)
        u, g = dist.potential_and_grad(x)
        v_new = v_half - 0.5 * eps * g
        delta = delta + (total_energy(u, v_new, inv_mass, dist) - h_in)
        # O
        v = eta * v_new + sig * scale * noise[2 * k + 1]

    log_p = (-delta).clamp(max=0.0)
    finite = torch.isfinite(delta)  # a non-finite Δ reads as rejection
    accept_stat = torch.where(finite, torch.exp(log_p), torch.zeros_like(log_p))
    accept = (torch.log(mh_uniform) < log_p) & finite

    ba = accept[None, :]
    x_new = torch.where(ba, x, x0)
    # the next iteration refreshes fully; the end momentum is kept on
    # accept (flip-on-reject is a no-op under full refresh)
    new_state = HMCState(
        chain=chain._replace(x=x_new, v=torch.where(ba, v, -v0),
                             u=torch.where(accept, u, u0), grad=torch.where(ba, g, g0)),
        grad_evals=state.grad_evals + m,
        n_accept=state.n_accept + accept.to(torch.int32),
    )
    return new_state, MALTStepOut(x=x_new, accept=accept, accept_stat=accept_stat)


def malt_run(
    dist: Distribution,
    state: HMCState,
    generator: torch.Generator,
    num_steps: int,
    epsilon: float,
    gamma: float,
    num_leapfrog_steps: int,
    collect: str = "samples",
    inv_mass: Tensor | None = None,
) -> Tuple[HMCState, dict]:
    """Run ``num_steps`` MALT iterations (collect: "samples" | "stats")."""
    return collect_run(
        lambda s: malt_step(dist, s, generator, epsilon, gamma, num_leapfrog_steps,
                            inv_mass=inv_mass),
        state, num_steps, collect)


@dataclasses.dataclass
class MALT(TrajectorySampler):
    """Reference-style MALT on the plain PyTorch path (same interface as
    ``ControlHMC``); runs on the card unless ``device="cpu"`` is asked for."""

    distribution: Distribution
    epsilon: float = 1.0
    gamma: float = 1.0
    num_leapfrog_steps: int = 5
    nbatch: int = 128
    seed: int = 0
    mass_diag: tuple | None = None
    device: str = "cuda"

    def __post_init__(self):
        self._setup()

    def _run(self, num_steps: int, collect: str) -> dict:
        self.state, outs = malt_run(
            self.distribution, self.state, self.generator, num_steps,
            self.epsilon, self.gamma, self.num_leapfrog_steps, collect,
            self.inv_mass,
        )
        return outs

    @property
    def accept_rate(self) -> float:
        total = int(self.state.n_accept.sum())
        steps = int(self.state.grad_evals.sum()) // self.num_leapfrog_steps
        return total / max(steps, 1)
