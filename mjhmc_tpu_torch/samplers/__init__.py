"""Samplers ported so far: Markov Jump HMC on the plain PyTorch path."""

from mjhmc_tpu_torch.samplers.mjhmc import (
    MarkovJumpHMC,
    MJStepOut,
    MomentAccumulator,
    mjhmc_run,
    mjhmc_step,
)
from mjhmc_tpu_torch.samplers.state import (
    ChainState,
    MJState,
    make_chain_state,
    make_mj_state,
)

__all__ = [
    "MarkovJumpHMC",
    "MJStepOut",
    "MomentAccumulator",
    "mjhmc_run",
    "mjhmc_step",
    "ChainState",
    "MJState",
    "make_chain_state",
    "make_mj_state",
]
