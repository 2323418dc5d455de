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

import torch

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
    epsilon: float,
    num_steps: int,
    inv_mass: Tensor | None = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Run ``num_steps`` leapfrog steps of size ``epsilon``.

    ``x``, ``v``, ``grad``: (..., ndims, nbatch); ``inv_mass``: optional
    diagonal M⁻¹ of shape (ndims, 1). Returns (x', v', U(x'), dU/dx(x')).
    """
    u = _u0(x)
    for _ in range(num_steps):
        v_half = v - 0.5 * epsilon * grad
        x = x + epsilon * (v_half if inv_mass is None else inv_mass * v_half)
        u, grad = potential_and_grad(x)
        v = v_half - 0.5 * epsilon * grad
    return x, v, u, grad


#: BCSS minimal-error two-stage coefficient (arXiv:1912.03253 §3)
TWO_STAGE_B = 0.1931833275037836


def two_stage(
    potential_and_grad: PotentialAndGrad,
    x: Tensor,
    v: Tensor,
    grad: Tensor,
    epsilon: float,
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


def kinetic_energy(v: Tensor, inv_mass: Tensor | None = None) -> Tensor:
    """½vᵀM⁻¹v per chain: (..., ndims, nbatch) → (..., nbatch)."""
    vv = v * v if inv_mass is None else v * v * inv_mass
    return 0.5 * vv.sum(dim=-2)


def total_energy(u: Tensor, v: Tensor, inv_mass: Tensor | None = None) -> Tensor:
    """H(ζ) = U(x) + ½vᵀM⁻¹v."""
    return u + kinetic_energy(v, inv_mass)


def momentum_scale(inv_mass: Tensor | None) -> Tensor | float:
    """√M multiplier turning N(0, I) draws into N(0, M) momenta."""
    if inv_mass is None:
        return 1.0
    return torch.sqrt(1.0 / inv_mass)
