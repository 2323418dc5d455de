"""Checkpointed long-running sampling (counterpart of
``mjhmc_tpu.utils.long_run``).

Wraps a sampler object (``MarkovJumpHMC``, ``ControlHMC``, ``MALT``,
``NUTS``) with periodic full-state checkpoints so a killed job resumes
exactly where it stopped: the state and the generator are the whole
carry, so resume is bit-exact.
"""

from __future__ import annotations

import inspect
import os

from mjhmc_tpu_torch.utils.checkpoint import load_pytree, save_pytree


def run_with_checkpoints(
    sampler,
    total_steps: int,
    checkpoint_every: int,
    path: str,
    collect: str = "stats",
) -> dict:
    """Run ``total_steps`` in chunks, checkpointing the sampler's state and
    generator after each. On start, resumes from ``path`` if present.
    Returns bookkeeping info (steps run this invocation, resumed-from
    step). ``collect`` goes to samplers whose ``_run`` takes it."""
    meta_path = path + ".meta"
    start = 0
    if os.path.exists(path) and os.path.exists(meta_path):
        with open(meta_path) as f:
            start = int(f.read().strip())
        restored = load_pytree(path, {"state": sampler.state, "generator": sampler.generator})
        sampler.state, sampler.generator = restored["state"], restored["generator"]

    takes_collect = "collect" in inspect.signature(sampler._run).parameters
    step = start
    while step < total_steps:
        chunk = min(checkpoint_every, total_steps - step)
        if takes_collect:
            sampler._run(chunk, collect)
        else:
            sampler._run(chunk)
        step += chunk
        save_pytree(path, {"state": sampler.state, "generator": sampler.generator})
        with open(meta_path, "w") as f:
            f.write(str(step))
    return {"resumed_from": start, "steps_run": step - start, "final_step": step}
