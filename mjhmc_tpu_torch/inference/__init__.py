"""VI and SMC heads over the shared log-density API (counterpart of
``mjhmc_tpu.inference``)."""

from mjhmc_tpu_torch.inference.smc import (
    SMC,
    SMCState,
    smc_run,
    smc_stage,
    systematic_resample,
)
from mjhmc_tpu_torch.inference.vi import (
    ADVI,
    ADVIParams,
    LowRankADVIParams,
    advi_fit,
    elbo,
    elbo_lowrank,
    q_covariance,
    sample_q,
    sample_q_lowrank,
)

__all__ = [
    "ADVI",
    "ADVIParams",
    "LowRankADVIParams",
    "advi_fit",
    "elbo",
    "elbo_lowrank",
    "q_covariance",
    "sample_q",
    "sample_q_lowrank",
    "SMC",
    "SMCState",
    "smc_run",
    "smc_stage",
    "systematic_resample",
]
