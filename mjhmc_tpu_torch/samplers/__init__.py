"""Samplers ported so far, on the plain PyTorch path: Markov Jump HMC,
control HMC, MALT and NUTS, and the dual-averaging warmups."""

from mjhmc_tpu_torch.samplers.adaptation import (
    DualAveragingState,
    adaptive_hmc_run,
    adaptive_malt_run,
    adaptive_mjhmc_run,
    da_epsilon,
    da_init,
    da_update,
    estimate_inv_mass,
    mjhmc_full_warmup,
    nuts_full_warmup,
)
from mjhmc_tpu_torch.samplers.hmc import ControlHMC, HMCStepOut, hmc_run, hmc_step
from mjhmc_tpu_torch.samplers.malt import MALT, MALTStepOut, malt_run, malt_step
from mjhmc_tpu_torch.samplers.mjhmc import (
    MarkovJumpHMC,
    MJStepOut,
    MomentAccumulator,
    mjhmc_run,
    mjhmc_step,
)
from mjhmc_tpu_torch.samplers.nuts import (
    NUTS,
    NUTSState,
    NUTSStepOut,
    make_nuts_state,
    nuts_run,
    nuts_step,
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
    "DualAveragingState",
    "adaptive_hmc_run",
    "adaptive_malt_run",
    "adaptive_mjhmc_run",
    "da_epsilon",
    "da_init",
    "da_update",
    "estimate_inv_mass",
    "mjhmc_full_warmup",
    "nuts_full_warmup",
    "NUTS",
    "NUTSState",
    "NUTSStepOut",
    "make_nuts_state",
    "nuts_run",
    "nuts_step",
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
