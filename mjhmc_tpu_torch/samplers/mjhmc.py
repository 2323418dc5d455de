"""Markov Jump HMC, plain PyTorch (counterpart of
``mjhmc_tpu.samplers.mjhmc``) — the port's reference path.

From ζ=(x,v), three competing exponential clocks:

  L-clock  Γ_L(ζ)  = exp(-½[H(Lζ) − H(ζ)])          fires → ζ ← Lζ
  F-clock  Γ_F(ζ)  = max(0, Γ_L(Fζ) − Γ_L(ζ))       fires → ζ ← Fζ
  R-clock  β (constant)                              fires → v ~ N(0, I)

Each iteration records the expected dwell time t(ζ)=1/(Γ_L+Γ_F+β) as the
sample's weight and picks the transition by Gumbel-max over the log-rates.
The forward and backward trajectories run as one stacked batch on a new
leading axis; the backward energy H(L⁻¹ζ) is cached between iterations and
only a refresh invalidates it, so the eval counter charges M, plus M when
the cache was invalid.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.distributed as tdist

from mjhmc_tpu_torch.models.base import Distribution, randn
from mjhmc_tpu_torch.ops.leapfrog import (
    INTEGRATORS,
    inv_mass_of,
    momentum_scale,
    total_energy,
)
from mjhmc_tpu_torch.samplers.state import Block, MJState, checked_device, make_mj_state

Tensor = torch.Tensor

# exp(25) ≈ 7e10: rates above this only shrink dwell times already ~1e-11
LOG_RATE_MAX = 25.0


class MJStepOut(NamedTuple):
    """Per-step emission (Rao-Blackwell: the *pre-transition* state + weight)."""

    x: Tensor  # (ndims, nbatch) dwelled-at positions
    dwell: Tensor  # (nbatch,) expected dwell time t(ζ)
    sel: Tensor  # (nbatch,) int8: 0=L fired, 1=F, 2=R
    accept_stat: Tensor  # (nbatch,) min(1, exp(-ΔH_L))
    cache_err: Tensor  # (nbatch,) |cached − fresh| backward H where valid


def draw_gumbel(generator: torch.Generator, shape, device) -> Tensor:
    """Standard Gumbel draw, float32, from uniforms clipped away from 0."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def mjhmc_step(
    dist: Distribution,
    state: MJState,
    generator: torch.Generator | None,
    epsilon: float,
    beta: float,
    num_leapfrog_steps: int,
    inv_mass: Tensor | None = None,
    integrator: str = "leapfrog",
    gumbel: Tensor | None = None,
    xi: Tensor | None = None,
    block: Block | None = None,
    refresh_fraction: float = 1.0,
) -> Tuple[MJState, MJStepOut]:
    """One Rao-Blackwellized jump iteration for all chains.

    ``gumbel`` (3, nbatch) and ``xi`` (ndims, nbatch) inject the
    selection noise and the N(0, I) refresh draw (a test can feed the JAX
    sampler's own draws); when absent they are drawn from ``generator``,
    at the global shape of a sharded state's ``block`` and cut to it.
    ``refresh_fraction`` c is the R-clock's corruption: 1 (the default) is
    the full refresh v ← ξ, c < 1 the partial v ← √(1−c)·v + √c·ξ, which
    keeps the momentum marginal too; either way the cache is invalidated.
    """
    chain = state.chain
    x, v, u, g = chain.x, chain.v, chain.u, chain.grad
    n = x.shape[1]
    m = num_leapfrog_steps
    beta_t = torch.as_tensor(beta, dtype=torch.float32, device=x.device)

    h_cur = total_energy(u, v, inv_mass, dist)

    # forward and backward trajectories stacked on a new leading axis
    step_fn, evals_per_step = INTEGRATORS[integrator]
    x2f, v2f, u2f, g2f = step_fn(
        dist.potential_and_grad, torch.stack([x, x]), torch.stack([v, -v]),
        torch.stack([g, g]), epsilon, m, inv_mass=inv_mass,
    )
    x_l, v_l, u_l, g_l = x2f[0], v2f[0], u2f[0], g2f[0]
    h_l = total_energy(u_l, v_l, inv_mass, dist)  # H(Lζ)
    h_back_fresh = total_energy(u2f[1], v2f[1], inv_mass, dist)  # H(L⁻¹ζ)

    valid = state.back_valid
    cache_err = torch.where(
        valid, (state.h_back - h_back_fresh).abs(), torch.zeros_like(h_l)
    )
    h_back = torch.where(valid, state.h_back, h_back_fresh)

    # ---- transition rates (log space, clipped, divergence-guarded) --------
    def log_rate(h_to):
        raw = -0.5 * (h_to - h_cur)
        return torch.where(
            torch.isfinite(h_to), raw.clamp(max=LOG_RATE_MAX),
            torch.full_like(raw, -torch.inf),
        )

    log_gl = log_rate(h_l)  # log Γ_L(ζ)
    log_glf = log_rate(h_back)  # log Γ_L(Fζ)
    gamma_l = torch.exp(log_gl)
    gamma_f = (torch.exp(log_glf) - gamma_l).clamp(min=0.0)
    dwell = 1.0 / (gamma_l + gamma_f + beta_t)

    # ---- categorical transition via Gumbel-max over log-rates -------------
    if gumbel is None:
        if block is None:
            gumbel = draw_gumbel(generator, (3, n), x.device)
        else:
            gumbel = draw_gumbel(generator, (3, block.nbatch), x.device)[:, block.cols]
    if xi is None:
        if block is None:
            xi = randn(generator, v.shape, x.device)
        else:
            xi = randn(generator, (block.ndims, block.nbatch), x.device)[block.rows, block.cols]
    log_rates = torch.stack(
        [log_gl, torch.log(gamma_f), torch.log(beta_t).expand(n)]
    )  # (3, n); log(0) = -inf is a valid Gumbel-max entry
    sel = torch.argmax(log_rates + gumbel, dim=0).to(torch.int8)
    is_l, is_f, is_r = sel == 0, sel == 1, sel == 2

    # ---- apply L / F / R as masked blends ---------------------------------
    v_fresh = momentum_scale(inv_mass) * xi
    if refresh_fraction < 1.0:
        c = torch.tensor(refresh_fraction, dtype=torch.float32, device=x.device)
        v_fresh = torch.sqrt(1.0 - c) * v + torch.sqrt(c) * v_fresh
    bl = is_l[None, :]
    x_new = torch.where(bl, x_l, x)
    v_new = torch.where(bl, v_l, torch.where(is_f[None, :], -v, v_fresh))
    u_new = torch.where(is_l, u_l, u)
    g_new = torch.where(bl, g_l, g)
    # cache state machine: L → H(ζ) becomes the backward energy; F → H(Lζ);
    # R → invalid (next step's backward pass refills it)
    h_back_new = torch.where(is_l, h_cur, torch.where(is_f, h_l, h_back))

    m_cost = evals_per_step * m
    evals_inc = torch.where(valid, m_cost, 2 * m_cost).to(torch.int32)

    new_state = MJState(
        chain=chain._replace(x=x_new, v=v_new, u=u_new, grad=g_new),
        h_back=h_back_new,
        back_valid=~is_r,
        grad_evals=state.grad_evals + evals_inc,
        dwell_sum=state.dwell_sum + dwell,
    )
    accept = torch.where(
        torch.isfinite(h_l), torch.exp((h_cur - h_l).clamp(max=0.0)),
        torch.zeros_like(h_l),
    )
    return new_state, MJStepOut(x, dwell, sel, accept, cache_err)


class MomentAccumulator(NamedTuple):
    """Streaming dwell-weighted sufficient statistics (per chain)."""

    w: Tensor  # (nbatch,) Σ t
    wx: Tensor  # (ndims, nbatch) Σ t·x
    wx2: Tensor  # (ndims, nbatch) Σ t·x²

    @classmethod
    def init(cls, ndims: int, nbatch: int, device="cpu") -> "MomentAccumulator":
        z = torch.zeros((ndims, nbatch), dtype=torch.float32, device=device)
        return cls(w=torch.zeros(nbatch, dtype=torch.float32, device=device),
                   wx=z, wx2=z.clone())

    def update(self, x: Tensor, w: Tensor) -> "MomentAccumulator":
        return MomentAccumulator(
            w=self.w + w, wx=self.wx + w * x, wx2=self.wx2 + w * x * x
        )

    def mean(self) -> Tensor:
        """(ndims,) dwell-weighted posterior mean across all chains/steps."""
        return self.wx.sum(dim=1) / self.w.sum()

    def var(self) -> Tensor:
        """(ndims,) dwell-weighted posterior marginal variance."""
        w = self.w.sum()
        m = self.wx.sum(dim=1) / w
        return self.wx2.sum(dim=1) / w - m * m


def mjhmc_run(
    dist: Distribution,
    state: MJState,
    generator: torch.Generator,
    num_steps: int,
    epsilon: float,
    beta: float,
    num_leapfrog_steps: int,
    collect: str = "samples",
    thin: int = 1,
    inv_mass: Tensor | None = None,
    integrator: str = "leapfrog",
    block: Block | None = None,
    refresh_fraction: float = 1.0,
) -> Tuple[MJState, dict]:
    """Run ``num_steps`` jump iterations (of a sharded state's ``block``:
    ``mjhmc_step``, with its ``refresh_fraction``).

    collect="samples": returns xs (num_steps//thin, ndims, nbatch) + dwell.
    collect="stats":   returns only streaming weighted moments (O(1) memory).
    """
    if collect not in ("samples", "stats"):
        raise ValueError(f"unknown collect mode: {collect}")
    ndims, nbatch = state.chain.x.shape
    if collect == "stats":
        acc = MomentAccumulator.init(ndims, nbatch, state.chain.x.device)
        for _ in range(num_steps):
            state, o = mjhmc_step(dist, state, generator, epsilon, beta,
                                  num_leapfrog_steps, inv_mass, integrator, block=block,
                                  refresh_fraction=refresh_fraction)
            acc = acc.update(o.x, o.dwell)
        return state, {"moments": acc}

    outs = []
    for _ in range(num_steps):
        state, o = mjhmc_step(dist, state, generator, epsilon, beta,
                              num_leapfrog_steps, inv_mass, integrator, block=block,
                              refresh_fraction=refresh_fraction)
        # chain-mean cumulative eval counter after this step (fairness axis)
        outs.append((*o, state.grad_evals.float().mean()))
    xs, dwell, sel, acc, cerr, ev = (torch.stack(c) for c in zip(*outs))
    if thin > 1:
        xs, dwell, sel, ev = xs[::thin], dwell[::thin], sel[::thin], ev[::thin]
    return state, {
        "x": xs,
        "dwell": dwell,
        "sel": sel,
        "accept_stat": acc,
        "cache_err": cerr,
        "evals_mean": ev,
    }


@dataclasses.dataclass
class MarkovJumpHMC:
    """Reference-style sampler object: ``sample(n)``, ``sampling_iteration()``,
    ``burn_in()``, on the plain PyTorch path. Runs on the card unless
    ``device="cpu"`` is asked for. ``mass_diag``: per-dim diagonal mass M
    (Stan convention: pass 1/variance); momenta then start in N(0, M).
    ``refresh_fraction``: the R-clock's corruption (``mjhmc_step``)."""

    distribution: Distribution
    epsilon: float = 1.0
    beta: float = 0.1
    num_leapfrog_steps: int = 5
    nbatch: int = 128
    seed: int = 0
    integrator: str = "leapfrog"
    device: str = "cuda"
    mass_diag: tuple | None = None
    refresh_fraction: float = 1.0

    def __post_init__(self):
        self.device = checked_device(self.device, type(self).__name__)
        self.generator = torch.Generator().manual_seed(self.seed)
        self.state = make_mj_state(self.distribution, self.generator,
                                   self.nbatch, self.device)
        self.inv_mass = inv_mass_of(self.mass_diag, self.device)
        if self.inv_mass is not None:  # momenta start in N(0, M)
            ch = self.state.chain
            self.state = self.state._replace(
                chain=ch._replace(v=ch.v / torch.sqrt(self.inv_mass)))
        self.mesh, self.block = None, None  # set by shard()

    def _run(self, num_steps: int, collect: str) -> dict:
        self.state, outs = mjhmc_run(
            self.distribution, self.state, self.generator, num_steps,
            self.epsilon, self.beta, self.num_leapfrog_steps, collect,
            inv_mass=self.inv_mass, integrator=self.integrator,
            block=self.block, refresh_fraction=self.refresh_fraction,
        )
        return outs

    def shard(self, mesh=None) -> "MarkovJumpHMC":
        """Keep this rank's block of the chains of a ("chains",) mesh (all
        ranks by default) on the mesh's device; returns self. Every rank
        builds the sampler with the same seed, so the draws, made at the
        global shape and cut to the block, are the unsharded run's, and the
        sampling loop communicates nothing."""
        from mjhmc_tpu_torch.parallel.mesh import make_chain_mesh, shard_chain_pytree

        self.mesh = mesh or make_chain_mesh(device=self.device)
        self.state = shard_chain_pytree(self.state, self.mesh)
        self.device = self.mesh.device
        if self.inv_mass is not None:
            self.inv_mass = self.inv_mass.to(self.device)
        self.block = self.mesh.block(*self.state.chain.x.shape)
        return self

    def sampling_iteration(self) -> dict:
        """One jump iteration across all chains."""
        return self._run(1, "samples")

    def sample(self, num_steps: int) -> dict:
        """Run ``num_steps`` iterations; returns samples + dwell weights."""
        return self._run(num_steps, "samples")

    def burn_in(self, num_steps: int = 500) -> None:
        """Advance chains and reset counters/accumulators."""
        self._run(num_steps, "stats")
        self.state = self.state._replace(
            grad_evals=torch.zeros_like(self.state.grad_evals),
            dwell_sum=torch.zeros_like(self.state.dwell_sum),
        )

    @property
    def grad_evals(self) -> int:
        """Total algorithmic gradient evaluations (the fairness currency),
        over every rank's chains when sharded."""
        total = self.state.grad_evals.sum(dtype=torch.int64)
        if self.mesh is not None:
            tdist.all_reduce(total, group=self.mesh.group())
        return int(total)

    @property
    def dwelling_times(self) -> Tensor:
        """Accumulated Rao-Blackwell dwell mass per chain."""
        return self.state.dwell_sum
