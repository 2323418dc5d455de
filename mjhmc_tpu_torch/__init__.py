"""mjhmc_tpu_torch — the PyTorch + CUDA port of ``mjhmc_tpu``.

The JAX package ``mjhmc_tpu`` stays the reference; this package mirrors its
module paths and names so each module's counterpart is easy to find. It
imports ``torch`` and never ``jax``. Public functions keep the JAX layouts:
``(ndims, nbatch)`` states with chains last, ``(nbatch,)`` per-chain
scalars, energies that reduce axis −2.

Ported so far: every model (rough well, Gaussian, product of t, sparse
coding, logistic regression, and the zoo: funnel, banana, Gaussian
mixture, eight schools), the leapfrog and two-stage integrators, the
plain MJHMC, control HMC, MALT and NUTS samplers with the dual-averaging
warmups, the fused CUDA engines (``ops.cuda_mjhmc``, hand-written kernels
in ``csrc/``), the roofline dossier, the autocorrelation / ESS
diagnostics, and the chain-sharded runtime on ``torch.distributed``
(``parallel``: mesh, collectives, the model axis, multi-process
initialisation, the sharded engine run; ``utils``: checkpoints, long runs,
timing, profiling; ``inference``: systematic resampling). See ROADMAP.md
for what is still to come.
"""

__version__ = "0.1.0"

from mjhmc_tpu_torch import diagnostics, inference, models, ops, parallel, samplers, utils
from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

__all__ = ["models", "ops", "samplers", "diagnostics", "parallel", "inference", "utils",
           "BENCHMARK_CONFIGS"]
