"""Chain-state tuples carried through the samplers (counterpart of
``mjhmc_tpu.samplers.state``).

Layout: tensors are (ndims, nbatch) / (nbatch,) — chains on the last axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mjhmc_tpu_torch.models.base import randn

Tensor = torch.Tensor


class ChainState(NamedTuple):
    """State shared by the continuous-state samplers; ``u``/``grad`` cache
    the potential and its gradient at ``x`` (M evals per M-step trajectory)."""

    x: Tensor  # (ndims, nbatch) positions
    v: Tensor  # (ndims, nbatch) momenta
    u: Tensor  # (nbatch,) potential U(x)
    grad: Tensor  # (ndims, nbatch) dU/dx

    @property
    def nbatch(self) -> int:
        return self.x.shape[1]

    @property
    def ndims(self) -> int:
        return self.x.shape[0]


class MJState(NamedTuple):
    """Markov-jump HMC carry = ChainState + backward-energy cache + counters.

    ``h_back`` caches H(L⁻¹ζ); ``back_valid`` marks chains whose cache
    survives (invalidated only by a momentum refresh).
    """

    chain: ChainState
    h_back: Tensor  # (nbatch,) cached H(L⁻¹ζ)
    back_valid: Tensor  # (nbatch,) bool
    grad_evals: Tensor  # (nbatch,) int32 — algorithmic gradient-eval counter
    dwell_sum: Tensor  # (nbatch,) f32 — Σ dwell weights (Rao-Blackwell mass)


def make_chain_state(dist, generator: torch.Generator, nbatch: int,
                     device="cpu") -> ChainState:
    """Fresh chain state: x ~ dist.init_x, v ~ N(0, I), caches filled."""
    x = dist.init_x(generator, nbatch, device)
    v = randn(generator, x.shape, device)
    u, g = dist.potential_and_grad(x)
    return ChainState(x=x, v=v, u=u, grad=g)


def make_mj_state(dist, generator: torch.Generator, nbatch: int,
                  device="cpu") -> MJState:
    chain = make_chain_state(dist, generator, nbatch, device)
    dev = chain.x.device
    return MJState(
        chain=chain,
        h_back=torch.zeros(nbatch, dtype=torch.float32, device=dev),
        back_valid=torch.zeros(nbatch, dtype=torch.bool, device=dev),
        grad_evals=torch.zeros(nbatch, dtype=torch.int32, device=dev),
        dwell_sum=torch.zeros(nbatch, dtype=torch.float32, device=dev),
    )
