"""Reduced-flip HMC, plain PyTorch (counterpart of
``mjhmc_tpu.samplers.reduced_flip``): the paper's discrete-time variant
between control HMC and the jump process.

Per iteration, after the β momentum corruption, the chain leaps, flips
or stays with

    p_leap(ζ) = min(1, exp(H(ζ) − H(Lζ)))
    p_flip(ζ) = max(0, p_leap(Fζ) − p_leap(ζ))     (H(LFζ) = H(L⁻¹ζ))
    p_stay    = 1 − p_leap − p_flip,

so it flips only with the excess backward leap probability. The
corruption perturbs v every iteration, so no backward energy survives to
be cached: each iteration costs 2M gradient evaluations (forward and
backward trajectories, run as one stacked (2, ndims, nbatch) leapfrog as
``mjhmc.mjhmc_step`` runs them).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from mjhmc_tpu_torch.models.base import Distribution, randn
from mjhmc_tpu_torch.ops.leapfrog import leapfrog, momentum_scale, total_energy
from mjhmc_tpu_torch.samplers.hmc import TrajectorySampler, collect_run, draw_uniform
from mjhmc_tpu_torch.samplers.state import HMCState

Tensor = torch.Tensor


class RFStepOut(NamedTuple):
    x: Tensor  # (ndims, nbatch) post-transition positions
    sel: Tensor  # (nbatch,) int8: 0=leap, 1=flip, 2=stay
    accept_stat: Tensor  # (nbatch,) p_leap — dual-averaging signal


def reduced_flip_hmc_step(
    dist: Distribution,
    state: HMCState,
    generator: torch.Generator | None,
    epsilon: float,
    beta: float,
    num_leapfrog_steps: int,
    inv_mass: Tensor | None = None,
    xi: Tensor | None = None,
    sel_uniform: Tensor | None = None,
) -> Tuple[HMCState, RFStepOut]:
    """One reduced-flip iteration across all chains.

    β is the per-step partial corruption v ← √(1−β)v + √β ξ (as in
    ``hmc.hmc_step``). ``xi`` (ndims, nbatch) N(0, I) and ``sel_uniform``
    (nbatch,) inject the corruption noise and the selection uniform (JAX's
    ``k_noise`` and ``k_sel`` draws); when absent they are drawn from
    ``generator``.
    """
    chain = state.chain
    x, u, g = chain.x, chain.u, chain.grad
    m = num_leapfrog_steps
    beta = torch.as_tensor(beta, dtype=torch.float32, device=x.device)
    if xi is None:
        xi = randn(generator, chain.v.shape, x.device)
    if sel_uniform is None:
        sel_uniform = draw_uniform(generator, x.shape[1], x.device)
    xi = momentum_scale(inv_mass) * xi
    v = torch.sqrt(1.0 - beta) * chain.v + torch.sqrt(beta) * xi
    h0 = total_energy(u, v, inv_mass, dist)

    # forward and backward trajectories stacked on a new leading axis
    x2f, v2f, u2f, g2f = leapfrog(
        dist.potential_and_grad, torch.stack([x, x]), torch.stack([v, -v]),
        torch.stack([g, g]), epsilon, m, inv_mass=inv_mass,
    )
    x_l, v_l, u_l, g_l = x2f[0], v2f[0], u2f[0], g2f[0]
    h_l = total_energy(u_l, v_l, inv_mass, dist)  # H(Lζ)
    h_b = total_energy(u2f[1], v2f[1], inv_mass, dist)  # H(L⁻¹ζ)

    def leap_prob(h_to):
        p = torch.exp((h0 - h_to).clamp(max=0.0))
        return torch.where(torch.isfinite(h_to), p, torch.zeros_like(p))

    p_leap = leap_prob(h_l)
    p_flip = (leap_prob(h_b) - p_leap).clamp(min=0.0)

    is_l = sel_uniform < p_leap
    is_f = ~is_l & (sel_uniform < p_leap + p_flip)
    sel = torch.where(is_l, 0, torch.where(is_f, 1, 2)).to(torch.int8)

    bl = is_l[None, :]
    x_new = torch.where(bl, x_l, x)
    v_new = torch.where(bl, v_l, torch.where(is_f[None, :], -v, v))
    new_state = HMCState(
        chain=chain._replace(x=x_new, v=v_new, u=torch.where(is_l, u_l, u),
                             grad=torch.where(bl, g_l, g)),
        # the corruption leaves no backward cache: both trajectories, always
        grad_evals=state.grad_evals + 2 * m,
        n_accept=state.n_accept + is_l.to(torch.int32),
    )
    return new_state, RFStepOut(x=x_new, sel=sel, accept_stat=p_leap)


def reduced_flip_hmc_run(
    dist: Distribution,
    state: HMCState,
    generator: torch.Generator,
    num_steps: int,
    epsilon: float,
    beta: float,
    num_leapfrog_steps: int,
    collect: str = "samples",
    inv_mass: Tensor | None = None,
) -> Tuple[HMCState, dict]:
    """Run ``num_steps`` reduced-flip iterations (collect: samples|stats)."""
    return collect_run(
        lambda s: reduced_flip_hmc_step(dist, s, generator, epsilon, beta, num_leapfrog_steps,
                                        inv_mass),
        state, num_steps, collect, fields=RFStepOut._fields)


@dataclasses.dataclass
class ReducedFlipHMC(TrajectorySampler):
    """Reference-style reduced-flip HMC on the plain PyTorch path; runs on
    the card unless ``device="cpu"`` is asked for. ``mass_diag``: per-dim
    diagonal mass M (Stan convention: pass 1/variance). ``unroll`` is
    accepted for the JAX signature and ignored."""

    distribution: Distribution
    epsilon: float = 1.0
    beta: float = 0.2
    num_leapfrog_steps: int = 5
    nbatch: int = 128
    seed: int = 0
    unroll: int = 1
    mass_diag: tuple | None = None
    device: str = "cuda"

    def __post_init__(self):
        self._setup()

    def _run(self, num_steps: int, collect: str) -> dict:
        self.state, outs = reduced_flip_hmc_run(
            self.distribution, self.state, self.generator, num_steps,
            self.epsilon, self.beta, self.num_leapfrog_steps, collect,
            self.inv_mass,
        )
        return outs
