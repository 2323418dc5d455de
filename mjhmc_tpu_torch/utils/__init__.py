"""Utilities: timing, checkpointing, long runs, profiling, burned-in inits."""

from mjhmc_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from mjhmc_tpu_torch.utils.init_cache import burned_in_init
from mjhmc_tpu_torch.utils.timing import Timer, steps_per_second

__all__ = [
    "Timer",
    "steps_per_second",
    "save_pytree",
    "load_pytree",
    "burned_in_init",
]
