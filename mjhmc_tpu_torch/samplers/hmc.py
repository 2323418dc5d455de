"""Standard / control HMC baseline, plain PyTorch (counterpart of
``mjhmc_tpu.samplers.hmc``).

Per iteration: partial momentum corruption v ← √(1−β)·v + √β·ξ with
ξ ~ N(0, M); an M-step leapfrog (or two-stage) trajectory from the cached
entry gradient; Metropolis accept with p = min(1, exp(H(ζ) − H(Lζ)));
momentum flip on reject (the "control" variant, so direction persistence
and gradient budgets match MJHMC's). M evals per iteration (2M two-stage).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from mjhmc_tpu_torch.models.base import Distribution, randn
from mjhmc_tpu_torch.ops.leapfrog import (
    INTEGRATORS,
    inv_mass_of,
    momentum_scale,
    total_energy,
)
from mjhmc_tpu_torch.samplers.mjhmc import MomentAccumulator
from mjhmc_tpu_torch.samplers.state import HMCState, checked_device, make_hmc_state

Tensor = torch.Tensor


class HMCStepOut(NamedTuple):
    x: Tensor  # (ndims, nbatch) post-transition positions
    accept: Tensor  # (nbatch,) bool
    accept_stat: Tensor  # (nbatch,) min(1, exp(-ΔH)) — dual-averaging signal


def draw_uniform(generator: torch.Generator, n: int, device) -> Tensor:
    """(n,) float32 uniforms in [0, 1) from ``generator``, moved to ``device``."""
    u = torch.rand((n,), generator=generator, device=generator.device,
                   dtype=torch.float32)
    return u.to(device)


def hmc_step(
    dist: Distribution,
    state: HMCState,
    generator: torch.Generator | None,
    epsilon: float,
    beta: float,
    num_leapfrog_steps: int,
    flip_on_reject: bool = True,
    inv_mass: Tensor | None = None,
    integrator: str = "leapfrog",
    xi: Tensor | None = None,
    mh_uniform: Tensor | None = None,
) -> Tuple[HMCState, HMCStepOut]:
    """One control-HMC iteration across all chains.

    ``beta`` is the per-step corruption fraction (β=1 is standard HMC with a
    full refresh). ``xi`` (ndims, nbatch) N(0, I) and ``mh_uniform``
    (nbatch,) inject the corruption noise and the Metropolis uniform (a test
    feeds the JAX step's own ``k_noise``/``k_mh`` draws); when absent they
    are drawn from ``generator``.
    """
    chain = state.chain
    x, u, g = chain.x, chain.u, chain.grad
    n = x.shape[1]
    beta = torch.as_tensor(beta, dtype=torch.float32, device=x.device)
    if xi is None:
        xi = randn(generator, chain.v.shape, x.device)
    if mh_uniform is None:
        mh_uniform = draw_uniform(generator, n, x.device)
    xi = momentum_scale(inv_mass) * xi
    v = torch.sqrt(1.0 - beta) * chain.v + torch.sqrt(beta) * xi

    step_fn, evals_per_step = INTEGRATORS[integrator]
    h0 = total_energy(u, v, inv_mass, dist)
    x_l, v_l, u_l, g_l = step_fn(dist.potential_and_grad, x, v, g, epsilon,
                                 num_leapfrog_steps, inv_mass=inv_mass)
    h_l = total_energy(u_l, v_l, inv_mass, dist)

    log_p = (h0 - h_l).clamp(max=0.0)
    # divergence-guarded: a non-finite h_l reads as rejection, not NaN
    finite = torch.isfinite(h_l)
    accept_stat = torch.where(finite, torch.exp(log_p), torch.zeros_like(log_p))
    accept = (torch.log(mh_uniform) < log_p) & finite

    ba = accept[None, :]
    x_new = torch.where(ba, x_l, x)
    # reject → momentum flip (control variant) or keep (plain HMC)
    v_new = torch.where(ba, v_l, -v if flip_on_reject else v)
    new_state = HMCState(
        chain=chain._replace(x=x_new, v=v_new, u=torch.where(accept, u_l, u),
                             grad=torch.where(ba, g_l, g)),
        grad_evals=state.grad_evals + evals_per_step * num_leapfrog_steps,
        n_accept=state.n_accept + accept.to(torch.int32),
    )
    return new_state, HMCStepOut(x=x_new, accept=accept, accept_stat=accept_stat)


def collect_run(step, state, num_steps: int, collect: str,
                fields=("x", "accept", "accept_stat")):
    """Run ``step(state) -> (state, out)`` ``num_steps`` times.
    collect="samples": the ``fields`` of each iteration's out and the
    chain-mean cumulative eval counter; "stats": unit-weight streaming
    moments."""
    if collect not in ("samples", "stats"):
        raise ValueError(f"unknown collect mode: {collect}")
    if collect == "stats":
        ndims, nbatch = state.chain.x.shape
        acc = MomentAccumulator.init(ndims, nbatch, state.chain.x.device)
        ones = torch.ones(nbatch, dtype=torch.float32, device=state.chain.x.device)
        for _ in range(num_steps):
            state, o = step(state)
            acc = acc.update(o.x, ones)
        return state, {"moments": acc}
    outs = []
    for _ in range(num_steps):
        state, o = step(state)
        outs.append((*(getattr(o, f) for f in fields), state.grad_evals.float().mean()))
    return state, dict(zip((*fields, "evals_mean"), (torch.stack(c) for c in zip(*outs))))


def hmc_run(
    dist: Distribution,
    state: HMCState,
    generator: torch.Generator,
    num_steps: int,
    epsilon: float,
    beta: float,
    num_leapfrog_steps: int,
    collect: str = "samples",
    flip_on_reject: bool = True,
    inv_mass: Tensor | None = None,
    integrator: str = "leapfrog",
) -> Tuple[HMCState, dict]:
    """Run ``num_steps`` HMC iterations (collect: "samples" | "stats")."""
    return collect_run(
        lambda s: hmc_step(dist, s, generator, epsilon, beta, num_leapfrog_steps,
                           flip_on_reject, inv_mass, integrator),
        state, num_steps, collect)


class TrajectorySampler:
    """Shared object interface of the HMCState samplers (``ControlHMC``,
    ``MALT``): ``sample(n)``, ``sampling_iteration()``, ``burn_in()``."""

    def _setup(self) -> None:
        self.device = checked_device(self.device, type(self).__name__)
        self.generator = torch.Generator().manual_seed(self.seed)
        self.state = make_hmc_state(self.distribution, self.generator,
                                    self.nbatch, self.device)
        self.inv_mass = inv_mass_of(self.mass_diag, self.device)
        if self.inv_mass is not None:  # momenta start in N(0, M)
            ch = self.state.chain
            self.state = self.state._replace(
                chain=ch._replace(v=ch.v / torch.sqrt(self.inv_mass)))

    def _run(self, num_steps: int, collect: str) -> dict:
        raise NotImplementedError

    def sampling_iteration(self) -> dict:
        return self._run(1, "samples")

    def sample(self, num_steps: int) -> dict:
        return self._run(num_steps, "samples")

    def burn_in(self, num_steps: int = 500) -> None:
        """Advance chains and reset the counters."""
        self._run(num_steps, "stats")
        self.state = self.state._replace(
            grad_evals=torch.zeros_like(self.state.grad_evals),
            n_accept=torch.zeros_like(self.state.n_accept),
        )

    @property
    def grad_evals(self) -> int:
        """Total algorithmic gradient evaluations (the fairness currency)."""
        return int(self.state.grad_evals.sum())


@dataclasses.dataclass
class ControlHMC(TrajectorySampler):
    """Reference-style control HMC on the plain PyTorch path; runs on the
    card unless ``device="cpu"`` is asked for. ``mass_diag``: per-dim
    diagonal mass M (Stan convention: pass 1/variance). ``unroll`` (the
    JAX sampler's scan unroll) has no meaning eagerly: it is accepted for
    the JAX signature and ignored."""

    distribution: Distribution
    epsilon: float = 1.0
    beta: float = 0.2
    num_leapfrog_steps: int = 5
    nbatch: int = 128
    seed: int = 0
    unroll: int = 1
    flip_on_reject: bool = True
    integrator: str = "leapfrog"  # or "two_stage" (arXiv:1912.03253)
    mass_diag: tuple | None = None
    device: str = "cuda"

    def __post_init__(self):
        self._setup()

    def _run(self, num_steps: int, collect: str) -> dict:
        self.state, outs = hmc_run(
            self.distribution, self.state, self.generator, num_steps,
            self.epsilon, self.beta, self.num_leapfrog_steps, collect,
            self.flip_on_reject, self.inv_mass, self.integrator,
        )
        return outs
