"""Tempered SMC head with systematic resampling and HMC mutations, plain
PyTorch (counterpart of ``mjhmc_tpu.inference.smc``; ChEES-SMC,
arXiv:2504.02627).

Particles anneal from a Gaussian prior to the target along
π_λ ∝ exp(−(1−λ)U₀ − λU), with

- **adaptive tempering**: each stage picks Δλ by a 30-step bisection on
  the device so the post-reweight ESS hits a target fraction;
- **systematic resampling**: global cumulative-weight inversion (cumsum +
  searchsorted); under a chain mesh the ring resample of
  ``parallel.collectives.distributed_systematic_resample``;
- **HMC mutations** targeting π_λ (full momentum refresh each step) with
  Robbins-Monro step-size control, or ChEES-adapted jittered trajectories
  (``mutation="chees"``);
- a running **log-evidence estimate** logZ = Σ log⟨w·exp(Δλ δ)⟩.

The number of stages is fixed; once λ reaches 1 the remaining stages are
extra mutation sweeps at the target (Δλ = 0). A stage reads nothing back
to the host: the bisection, the evidence and the step sizes stay tensors
on the particles' device, and the draws come from a generator there.

The uniform offset ``u0`` of the resample and each mutation step's draws
are inputs, so a test can hand both packages the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution, randn
from mjhmc_tpu_torch.ops.leapfrog import leapfrog, masked_leapfrog, total_energy
from mjhmc_tpu_torch.samplers.hmc import draw_uniform
from mjhmc_tpu_torch.samplers.state import checked_device

Tensor = torch.Tensor


class SMCState(NamedTuple):
    x: Tensor  # (ndims, n) particles
    log_w: Tensor  # (n,) unnormalised log weights
    lam: Tensor  # () current temperature
    log_z: Tensor  # () running evidence estimate
    eps: Tensor  # () mutation step size
    log_tau: Tensor  # () ChEES-adapted total integration time
    chees_m: Tensor  # () ChEES Adam first moment
    chees_v: Tensor  # () ChEES Adam second moment
    chees_step: Tensor  # () int32


class SMCStageOut(NamedTuple):
    lam: Tensor
    ess: Tensor
    accept: Tensor
    eps: Tensor


def resample_positions(log_w: Tensor, u0, slots: Tensor) -> tuple:
    """(cdf, pos): the normalised weights' CDF over all n particles and the
    positions u0 + slot/n of the output ``slots``, in float32 as JAX forms
    them."""
    n = log_w.shape[0]
    lw = log_w - torch.logsumexp(log_w, 0)
    cdf = torch.cumsum(torch.exp(lw), 0)
    u0 = torch.as_tensor(u0, dtype=torch.float32, device=log_w.device)
    return cdf, u0 + slots.to(torch.float32) / n


def systematic_resample(x: Tensor, log_w: Tensor, u0) -> Tensor:
    """Systematic resampling: (d, n) particles by global weight inversion."""
    n = log_w.shape[0]
    cdf, pos = resample_positions(log_w, u0, torch.arange(n, device=log_w.device))
    ancestors = torch.searchsorted(cdf, pos).clamp(0, n - 1)
    return x[:, ancestors]


def _prior_potential_and_grad(x: Tensor, scale: float):
    inv = 1.0 / (scale * scale)
    return 0.5 * inv * (x * x).sum(dim=0), x * inv


def _tempered_potential_and_grad(dist: Distribution, scale: float, lam: Tensor):
    def pg(x):
        u0, g0 = _prior_potential_and_grad(x, scale)
        u1, g1 = dist.potential_and_grad(x)
        return (1.0 - lam) * u0 + lam * u1, (1.0 - lam) * g0 + lam * g1

    return pg


def _ess(log_w: Tensor) -> Tensor:
    lw = log_w - torch.logsumexp(log_w, 0)
    return torch.exp(-torch.logsumexp(2.0 * lw, 0))


def _find_delta(log_w: Tensor, delta_logdens: Tensor, lam: Tensor, ess_frac: float,
                n_bisect: int = 30) -> Tensor:
    """Bisect Δλ ∈ (0, 1−λ] so the post-reweight ESS ≈ ess_frac·n; a fixed
    number of steps, every branch a ``torch.where`` on the device."""
    target = ess_frac * log_w.shape[0]
    hi0 = 1.0 - lam

    def ess_at(d):
        return _ess(log_w + d * delta_logdens)

    # if even the full remaining jump keeps the ESS above target, take it
    full_ok = ess_at(hi0) >= target
    lo, hi = torch.zeros_like(lam), hi0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(full_ok, hi0, lo)


class _Particles:
    """Where this rank's particles lie among all of them: the global count,
    its columns, and the global vector of a per-particle quantity (one
    all_gather of n floats under a mesh; the tensor itself without)."""

    def __init__(self, n_local: int, mesh=None):
        self.mesh = mesh
        p = 1 if mesh is None else mesh.size()
        self.n = n_local * p
        self.cols = None if mesh is None else mesh.block(1, n_local).cols

    def local(self, t: Tensor) -> Tensor:
        """This rank's block of a draw made at the global shape."""
        return t if self.cols is None else t[..., self.cols]

    def gather(self, t: Tensor) -> Tensor:
        if self.mesh is None:
            return t
        import torch.distributed as tdist

        parts = [torch.empty_like(t) for _ in range(self.mesh.size())]
        tdist.all_gather(parts, t.contiguous(), group=self.mesh.group())
        return torch.cat(parts)


def smc_stage(
    dist: Distribution,
    state: SMCState,
    generator: torch.Generator | None,
    prior_scale: float,
    ess_frac: float,
    num_mutation_steps: int,
    num_leapfrog_steps: int,
    target_accept: float = 0.65,
    rm_rate: float = 0.3,
    mutation: str = "hmc",
    mesh=None,
    u0: Tensor | None = None,
    v: Tensor | None = None,
    mh_uniform: Tensor | None = None,
    jitter: Tensor | None = None,
) -> Tuple[SMCState, SMCStageOut]:
    """One SMC stage: reweight (adaptive Δλ) → resample → mutate.

    ``mutation="chees"``: jittered-trajectory HMC whose total integration
    time τ ascends the ChEES criterion (``samplers.chees``), as masked
    per-particle leapfrog lengths capped at ``num_leapfrog_steps``.

    ``mesh``: the chain mesh when each rank holds a block of the particles;
    the weights are gathered (n floats) for the bisection and the
    evidence, and the resample is ``distributed_systematic_resample``.

    Injected draws (JAX's key splits; global shapes under a mesh): ``u0``
    the resample offset in [0, 1/n), ``v`` (num_mutation_steps, d, n),
    ``mh_uniform`` and, for ChEES, ``jitter`` (num_mutation_steps, n).
    """
    x, lam = state.x, state.lam
    d, n_local = x.shape
    dev = x.device
    parts = _Particles(n_local, mesh)
    n = parts.n

    # ---- adaptive reweight -------------------------------------------------
    u_prior, _ = _prior_potential_and_grad(x, prior_scale)
    delta = u_prior - dist.potential(x)  # d(log π_λ)/dλ
    log_w_all, delta_all = parts.gather(state.log_w), parts.gather(delta)
    d_lam = _find_delta(log_w_all, delta_all, lam, ess_frac)
    inc = d_lam * delta_all

    # evidence increment: log ⟨ŵ · e^inc⟩ under the normalised weights
    lw_norm = log_w_all - torch.logsumexp(log_w_all, 0)
    log_z = state.log_z + torch.logsumexp(lw_norm + inc, 0)
    log_w_all = log_w_all + inc
    lam = lam + d_lam
    ess = _ess(log_w_all)

    # ---- resample (always; Δλ chose ESS ≈ target) --------------------------
    if u0 is None:
        u0 = draw_uniform(generator, 1, dev)[0] * (1.0 / n)
    if mesh is None:
        x = systematic_resample(x, log_w_all, u0)
    else:
        from mjhmc_tpu_torch.parallel.collectives import distributed_systematic_resample

        x = distributed_systematic_resample(x, state.log_w + d_lam * delta, u0, mesh)
    log_w = torch.zeros_like(state.log_w)

    # ---- mutate: HMC sweeps targeting π_λ ----------------------------------
    pg = _tempered_potential_and_grad(dist, prior_scale, lam)
    u, g = pg(x)
    eps = state.eps
    chees = mutation == "chees"
    if chees:
        from mjhmc_tpu_torch.samplers.chees import (
            CheesState,
            _adam_ascent,
            chees_surrogate_grad,
            draw_jitter,
            jittered_steps,
        )

        cs = CheesState(log_tau=state.log_tau, m_adam=state.chees_m, v_adam=state.chees_v,
                        step=state.chees_step)
    acc_trace = []
    for k in range(num_mutation_steps):
        if chees:
            jit = parts.local(draw_jitter(generator, n, dev)) if jitter is None else jitter[k]
            tau = torch.exp(cs.log_tau)
            m_i = jittered_steps(jit, tau, eps, num_leapfrog_steps)
        vk = parts.local(randn(generator, (d, n), dev)) if v is None else v[k]
        uni = parts.local(draw_uniform(generator, n, dev)) if mh_uniform is None else mh_uniform[k]
        h0 = total_energy(u, vk, dist=dist)
        if chees:
            xl, vl, ul, gl, steps = masked_leapfrog(pg, x, vk, g, eps, num_leapfrog_steps, m_i,
                                                    u0=u)
        else:
            xl, vl, ul, gl = leapfrog(pg, x, vk, g, eps, num_leapfrog_steps)
        hl = total_energy(ul, vl, dist=dist)
        log_p = (h0 - hl).clamp(max=0.0)
        finite = torch.isfinite(hl)
        acc = (torch.log(uni) < log_p) & finite
        am = acc[None, :]
        x = torch.where(am, xl, x)
        u = torch.where(acc, ul, u)
        g = torch.where(am, gl, g)
        if chees:
            alpha = torch.where(finite, torch.exp(log_p), torch.zeros_like(log_p))
            tau_i = eps * steps.to(torch.float32)
            # the post-move x, as the JAX mutation passes it
            cs = _adam_ascent(cs, chees_surrogate_grad(x, xl, vl, alpha, tau_i, tau, mesh))
            acc_mean = parts.gather(alpha).mean()
        else:
            acc_mean = parts.gather(torch.exp(log_p)).mean()
        eps = eps * torch.exp(rm_rate * (acc_mean - target_accept))
        acc_trace.append(acc_mean)

    new_state = state._replace(x=x, log_w=log_w, lam=lam, log_z=log_z, eps=eps)
    if chees:
        new_state = new_state._replace(log_tau=cs.log_tau, chees_m=cs.m_adam,
                                       chees_v=cs.v_adam, chees_step=cs.step)
    return new_state, SMCStageOut(lam=lam, ess=ess, accept=torch.stack(acc_trace).mean(),
                                  eps=eps)


def smc_init(dist: Distribution, generator: torch.Generator, num_particles: int,
             prior_scale: float = 3.0, init_eps: float = 0.25, init_tau: float = 1.0,
             mesh=None, device="cpu") -> SMCState:
    """Particles from the N(0, prior_scale²) prior, uniform weights, λ = 0.
    Under a ``mesh`` the draw is made at the global shape and this rank
    keeps its block; a count the ranks do not divide is refused."""
    if mesh is not None and num_particles % mesh.size():
        raise ValueError(f"{num_particles} particles do not split over {mesh.size()} ranks")
    dev = torch.device(device) if mesh is None else mesh.device
    x0 = prior_scale * randn(generator, (dist.ndims, num_particles), dev)
    n_local = num_particles if mesh is None else num_particles // mesh.size()
    x0 = _Particles(n_local, mesh).local(x0).contiguous()

    def full(v, dtype=torch.float32):
        return torch.full((), v, dtype=dtype, device=dev)

    return SMCState(
        x=x0, log_w=torch.zeros(n_local, dtype=torch.float32, device=dev), lam=full(0.0),
        log_z=full(0.0), eps=full(float(np.float32(init_eps))),
        log_tau=full(float(np.log(np.float32(init_tau)))), chees_m=full(0.0),
        chees_v=full(0.0), chees_step=full(0, torch.int32),
    )


def smc_run(
    dist: Distribution,
    generator: torch.Generator,
    num_particles: int,
    num_stages: int = 20,
    prior_scale: float = 3.0,
    ess_frac: float = 0.5,
    num_mutation_steps: int = 5,
    num_leapfrog_steps: int = 5,
    init_eps: float = 0.25,
    mutation: str = "hmc",
    init_tau: float = 1.0,
    mesh=None,
    device="cuda",
) -> Tuple[SMCState, dict]:
    """Full annealing run prior → target. Returns the final particles ~ p
    and the log-evidence estimate log(Z_target / Z_prior), with the
    stages' trace (lam, ess, accept, eps), all on the device.

    Runs on the card unless ``device="cpu"`` is asked for. ``mesh``: the
    chain mesh when the particles are split over ranks (the same
    ``generator`` seed on every rank; ``device`` is then the mesh's)."""
    if mesh is None:
        device = checked_device(device, "smc_run")
    state = smc_init(dist, generator, num_particles, prior_scale, init_eps, init_tau, mesh,
                     device)
    outs = []
    for _ in range(num_stages):
        state, out = smc_stage(dist, state, generator, prior_scale, ess_frac,
                               num_mutation_steps, num_leapfrog_steps, mutation=mutation,
                               mesh=mesh)
        outs.append(out)
    return state, {k: torch.stack(c) for k, c in zip(SMCStageOut._fields, zip(*outs))}


@dataclasses.dataclass
class SMC:
    """Convenience wrapper mirroring the sampler class API; runs on the
    card unless ``device="cpu"`` is asked for, its draws from a generator
    on that device."""

    distribution: Distribution
    num_particles: int = 4096
    num_stages: int = 20
    prior_scale: float = 3.0
    num_mutation_steps: int = 5
    num_leapfrog_steps: int = 5
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        self.device = checked_device(self.device, type(self).__name__)

    def run(self) -> Tuple[SMCState, dict]:
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.state, self.trace = smc_run(
            self.distribution, gen, self.num_particles, self.num_stages, self.prior_scale,
            num_mutation_steps=self.num_mutation_steps,
            num_leapfrog_steps=self.num_leapfrog_steps, device=self.device)
        if self.device.type == "cuda":  # the run's one wait for the card
            torch.cuda.synchronize(self.device)
        return self.state, self.trace
