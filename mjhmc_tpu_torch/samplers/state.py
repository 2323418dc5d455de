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


class HMCState(NamedTuple):
    """Control/standard HMC (and MALT) carry."""

    chain: ChainState
    grad_evals: Tensor  # (nbatch,) int32
    n_accept: Tensor  # (nbatch,) int32


class Block(NamedTuple):
    """Where a rank's block of the state lies in the global (ndims, nbatch)
    arrays of a sharded run (``parallel.mesh.ChainMesh.block``). The
    samplers draw their noise at the global shape from the generator every
    rank shares and keep the block, so a sharded run draws the numbers of
    the unsharded one."""

    ndims: int
    nbatch: int
    rows: slice
    cols: slice


def checked_device(device, owner: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    rather than running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{owner}(device='cuda') needs a CUDA device "
                           "(pass device='cpu' to run on the CPU)")
    return device


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


def make_hmc_state(dist, generator: torch.Generator, nbatch: int,
                   device="cpu") -> HMCState:
    chain = make_chain_state(dist, generator, nbatch, device)
    dev = chain.x.device
    return HMCState(
        chain=chain,
        grad_evals=torch.zeros(nbatch, dtype=torch.int32, device=dev),
        n_accept=torch.zeros(nbatch, dtype=torch.int32, device=dev),
    )
