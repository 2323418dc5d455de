"""mjhmc_tpu_torch — the PyTorch + CUDA port of ``mjhmc_tpu``.

The JAX package ``mjhmc_tpu`` stays the reference; this package mirrors its
module paths and names so each module's counterpart is easy to find. It
imports ``torch`` and never ``jax``. Public functions keep the JAX layouts:
``(ndims, nbatch)`` states with chains last, ``(nbatch,)`` per-chain
scalars, energies that reduce axis −2.

Ported so far: every model (rough well, Gaussian, product of t, sparse
coding, logistic regression, and the zoo: funnel, banana, Gaussian
mixture, eight schools), the leapfrog and two-stage integrators, the
plain MJHMC (with the partial refresh), control HMC, reduced-flip HMC,
MALT, NUTS, ChEES and parallel tempering samplers with the dual-averaging
warmups, the fused CUDA engines (``ops.cuda_mjhmc``, hand-written kernels
in ``csrc/``), the roofline dossier, the diagnostics (autocorrelation,
ESS, split-R̂, spectral gaps), the ESS/s harness (``bench_ess``), the
autocorrelation-vs-gradient-evaluations experiment (``experiments``), the
algebraic ladder oracle (``samplers.algebraic``), burned-in inits
(``utils.init_cache``), and the chain-sharded runtime on
``torch.distributed`` (``parallel``: mesh, collectives, the model axis,
multi-process initialisation, the sharded engine run; ``utils``:
checkpoints, long runs, timing, profiling), the SMC and ADVI heads
(``inference``, ``bench_heads``), the hyperparameter searches (``search``:
the grid sweep and GP-EI), the paper's figures and its efficiency claim
(``experiments.figures``, ``experiments.efficiency_claim``) and the
sampler dataclasses (``config``). See ROADMAP.md for what is still to
come.

On a machine with an NVIDIA H100, from the repository root::

    python -m mjhmc_tpu_torch.bench_ess --config rough_well --sampler mjhmc
    python -m mjhmc_tpu_torch sample --config rough_well --save out.npz
    python -m mjhmc_tpu_torch diagnostics --file out.npz

The first prints one JSON line of ESS/s; ``diagnostics`` prints the saved
samples' ESS, split-R̂, empirical spectral gap and first autocorrelation
lags. Add ``--device cpu`` to run either on the CPU (the engines' plain
versions). The port is held against the JAX package on the CPU by
``python -m pytest tests/test_torch_*.py``.
"""

__version__ = "0.1.0"

from mjhmc_tpu_torch import (
    diagnostics,
    experiments,
    inference,
    models,
    ops,
    parallel,
    samplers,
    search,
    utils,
)
from mjhmc_tpu_torch.config import (
    BENCHMARK_CONFIGS,
    ControlHMCConfig,
    MJHMCConfig,
    NUTSConfig,
)

__all__ = ["models", "ops", "samplers", "diagnostics", "experiments", "parallel",
           "inference", "search", "utils", "MJHMCConfig", "ControlHMCConfig", "NUTSConfig",
           "BENCHMARK_CONFIGS"]
