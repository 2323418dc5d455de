"""Samplers ported so far, on the plain PyTorch path: Markov Jump HMC,
control HMC and MALT."""

from mjhmc_tpu_torch.samplers.hmc import ControlHMC, HMCStepOut, hmc_run, hmc_step
from mjhmc_tpu_torch.samplers.malt import MALT, MALTStepOut, malt_run, malt_step
from mjhmc_tpu_torch.samplers.mjhmc import (
    MarkovJumpHMC,
    MJStepOut,
    MomentAccumulator,
    mjhmc_run,
    mjhmc_step,
)
from mjhmc_tpu_torch.samplers.state import (
    ChainState,
    HMCState,
    MJState,
    make_chain_state,
    make_hmc_state,
    make_mj_state,
)

__all__ = [
    "MarkovJumpHMC",
    "MJStepOut",
    "MomentAccumulator",
    "mjhmc_run",
    "mjhmc_step",
    "ControlHMC",
    "HMCStepOut",
    "hmc_run",
    "hmc_step",
    "MALT",
    "MALTStepOut",
    "malt_run",
    "malt_step",
    "ChainState",
    "HMCState",
    "MJState",
    "make_chain_state",
    "make_hmc_state",
    "make_mj_state",
]
