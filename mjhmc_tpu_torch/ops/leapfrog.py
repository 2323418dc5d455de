"""Leapfrog and two-stage integrators (counterpart of
``mjhmc_tpu.ops.leapfrog``); the ``lax.scan`` is a Python loop.

Gradient-caching contract: the caller passes the gradient at the entry
point, so an M-step leapfrog trajectory performs exactly M gradient
evaluations (2M for the two-stage integrator). Both are time-reversible:
``leapfrog(x, -v)`` traces the inverse trajectory, which MJHMC uses for the
backward-rung energy.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import sum_dims

Tensor = torch.Tensor
PotentialAndGrad = Callable[[Tensor], Tuple[Tensor, Tensor]]


def _u0(x: Tensor) -> Tensor:
    # U placeholder for a zero-step trajectory: shape (..., nbatch)
    return torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=x.dtype, device=x.device)


def leapfrog(
    potential_and_grad: PotentialAndGrad,
    x: Tensor,
    v: Tensor,
    grad: Tensor,
    epsilon: Tensor | float,
    num_steps: int,
    inv_mass: Tensor | None = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Run ``num_steps`` leapfrog steps of size ``epsilon``.

    ``x``, ``v``, ``grad``: (..., ndims, nbatch); ``epsilon``: a float or a
    tensor that broadcasts against them (parallel tempering's (T, 1, 1)
    per-rung steps); ``inv_mass``: optional diagonal M⁻¹ of shape
    (ndims, 1). Returns (x', v', U(x'), dU/dx(x')).
    """
    u = _u0(x)
    half = 0.5 * epsilon  # formed once: a tensor ε would cost a kernel a kick
    for _ in range(num_steps):
        v_half = v - half * grad
        x = x + epsilon * (v_half if inv_mass is None else inv_mass * v_half)
        u, grad = potential_and_grad(x)
        v = v_half - half * grad
    return x, v, u, grad


#: BCSS minimal-error two-stage coefficient (arXiv:1912.03253 §3)
TWO_STAGE_B = 0.1931833275037836


def two_stage(
    potential_and_grad: PotentialAndGrad,
    x: Tensor,
    v: Tensor,
    grad: Tensor,
    epsilon: Tensor | float,
    num_steps: int,
    inv_mass: Tensor | None = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Minimal-error two-stage splitting B(bε)A(ε/2)B((1−2b)ε)A(ε/2)B(bε);
    same contract as :func:`leapfrog`, two gradient evaluations per step."""
    eps = torch.as_tensor(epsilon, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(TWO_STAGE_B, dtype=x.dtype, device=x.device)

    def drift(x, v):
        return x + (0.5 * eps) * (v if inv_mass is None else inv_mass * v)

    u = _u0(x)
    for _ in range(num_steps):
        v1 = v - (b * eps) * grad
        x = drift(x, v1)
        _, g1 = potential_and_grad(x)
        v2 = v1 - ((1.0 - 2.0 * b) * eps) * g1
        x = drift(x, v2)
        u, grad = potential_and_grad(x)
        v = v2 - (b * eps) * grad
    return x, v, u, grad


#: integrator registry: name → (stepper fn, gradient evals per step)
INTEGRATORS = {"leapfrog": (leapfrog, 1), "two_stage": (two_stage, 2)}


def masked_leapfrog(
    potential_and_grad: PotentialAndGrad,
    x: Tensor,
    v: Tensor,
    grad: Tensor,
    epsilon: Tensor | float,
    num_steps_max: int,
    num_steps_per_chain: Tensor,
    u0: Tensor | None = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Leapfrog with per-chain trajectory lengths (a fixed compute budget).

    Every chain integrates ``num_steps_max`` steps; chain i freezes after
    its own ``num_steps_per_chain[i]`` (ChEES's jittered lengths). ``u0``:
    the cached U(x) at entry, evaluated once (and not counted) when
    omitted. Returns (x', v', U', g', steps), ``steps`` = min(m_i, max) as
    int32, the chains' algorithmic integrator steps.
    """
    m_i = num_steps_per_chain
    if u0 is None:
        u0 = potential_and_grad(x)[0]  # the frozen chains' U
    u = u0
    half = 0.5 * epsilon
    for i in range(num_steps_max):
        active = m_i > i
        v_half = v - half * grad
        x_new = x + epsilon * v_half
        u_new, g_new = potential_and_grad(x_new)
        v_new = v_half - half * g_new
        a = active[None, :]
        x = torch.where(a, x_new, x)
        v = torch.where(a, v_new, v)
        grad = torch.where(a, g_new, grad)
        u = torch.where(active, u_new, u)
    steps = torch.clamp(m_i, max=num_steps_max).to(torch.int32)
    return x, v, u, grad, steps


def kinetic_energy(v: Tensor, inv_mass: Tensor | None = None, dist=None) -> Tensor:
    """½vᵀM⁻¹v per chain: (..., ndims, nbatch) → (..., nbatch), summed over
    the dims by ``dist``'s hook (``models.base.sum_dims``)."""
    vv = v * v if inv_mass is None else v * v * inv_mass
    return 0.5 * sum_dims(dist, vv)


def total_energy(u: Tensor, v: Tensor, inv_mass: Tensor | None = None, dist=None) -> Tensor:
    """H(ζ) = U(x) + ½vᵀM⁻¹v."""
    return u + kinetic_energy(v, inv_mass, dist)


def momentum_scale(inv_mass: Tensor | None) -> Tensor | float:
    """√M multiplier turning N(0, I) draws into N(0, M) momenta."""
    if inv_mass is None:
        return 1.0
    return torch.sqrt(1.0 / inv_mass)


def inv_mass_of(mass_diag, device) -> Tensor | None:
    """(ndims, 1) float32 diagonal M⁻¹ from a per-dim mass diagonal M (the
    samplers' ``mass_diag``; Stan convention: pass 1/variance), or None."""
    if mass_diag is None:
        return None
    im = 1.0 / np.asarray(mass_diag, np.float32)
    return torch.as_tensor(im, dtype=torch.float32, device=device)[:, None]
