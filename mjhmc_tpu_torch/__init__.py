"""mjhmc_tpu_torch — the PyTorch + CUDA port of ``mjhmc_tpu``.

The JAX package ``mjhmc_tpu`` stays the reference; this package mirrors its
module paths and names so each module's counterpart is easy to find. It
imports ``torch`` and never ``jax``. Public functions keep the JAX layouts:
``(ndims, nbatch)`` states with chains last, ``(nbatch,)`` per-chain
scalars, energies that reduce axis −2.

Ported so far (the main path): the rough-well and Gaussian models, the
leapfrog integrators, the plain MJHMC sampler, the fused CUDA engine
(``ops.cuda_mjhmc``, hand-written kernel in ``csrc/``) and the
autocorrelation / ESS diagnostics. See ROADMAP.md for what is still to come.
"""

__version__ = "0.1.0"

from mjhmc_tpu_torch import diagnostics, models, ops, samplers
from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

__all__ = ["models", "ops", "samplers", "diagnostics", "BENCHMARK_CONFIGS"]
