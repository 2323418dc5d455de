"""Parallel tempering (replica exchange), plain PyTorch (counterpart of
``mjhmc_tpu.samplers.tempering``) — the multimodal-sampling head.

T replicas per chain target p_t(x) ∝ exp(−β_t U(x)) on an ascending
inverse-temperature ladder β_0 < … < β_{T−1} = 1. Each iteration runs one
full-refresh HMC update per replica, then an even/odd Metropolis exchange
of adjacent rungs (log α = (β_{t+1} − β_t)(U_{t+1} − U_t)).

The ladder rides a leading axis, (T, ndims, nbatch): the energies reduce
axis −2, so one leapfrog integrates every replica of every chain, and the
exchange is ``torch.roll``/``torch.where`` along the ladder axis, never
touching the chain axis. Hotter rungs take √(1/β_t)-scaled steps (the
tempered target widens as 1/√β), which keeps acceptance roughly flat.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mjhmc_tpu_torch.models.base import Distribution, randn
from mjhmc_tpu_torch.ops.leapfrog import kinetic_energy, leapfrog
from mjhmc_tpu_torch.samplers.mjhmc import MomentAccumulator
from mjhmc_tpu_torch.samplers.state import checked_device

Tensor = torch.Tensor


class PTState(NamedTuple):
    """Replica-exchange carry. Leading axis = the temperature ladder (T)."""

    x: Tensor  # (T, d, n) positions
    u: Tensor  # (T, n) BASE potential U(x_t) (untempered: the swap currency)
    grad: Tensor  # (T, d, n) base gradient dU/dx
    grad_evals: Tensor  # (n,) int32: T·M per iteration (every replica counted)
    n_accept: Tensor  # (T, n) int32 HMC accepts per replica
    n_swap_acc: Tensor  # (T-1, n) int32 accepted exchanges per adjacent pair
    n_swap_try: Tensor  # (T-1, n) int32 attempted exchanges per adjacent pair
    replica_id: Tensor  # (T, n) int32: which original replica holds rung t
    seen_hot: Tensor  # (T, n) bool per ORIGINAL replica: visited rung 0
    round_trips: Tensor  # (T, n) int32 per original replica: hot→cold passages
    n_iter: Tensor  # () int32 PT iterations: the health metrics' denominator
    # (grad_evals is reset by burn_in, so the count is not inferred from it)


class PTStepOut(NamedTuple):
    x: Tensor  # (d, n) target-temperature (β=1) positions
    accept: Tensor  # (T, n) bool per-replica HMC accepts
    swap_accept: Tensor  # (T-1, n) bool exchange accepts this step


def geometric_ladder(num_temps: int, beta_min: float) -> np.ndarray:
    """Geometric β ladder from ``beta_min`` to 1.0 (ascending), length T."""
    if num_temps == 1:
        return np.ones(1, np.float32)
    return (beta_min ** np.linspace(1.0, 0.0, num_temps)).astype(np.float32)


def update_ladder(
    betas: np.ndarray,
    swap_rates: np.ndarray,
    target: float = 0.4,
    eta: float = 0.6,
) -> np.ndarray:
    """One Robbins-Monro ladder update toward uniform swap acceptance.

    The ladder is parameterised by its log-β gaps uₜ = log β_{t+1} − log β_t
    (β_{T−1} ≡ 1 stays pinned); each gap scales by exp(η·(rₜ − r*)), so a
    pair swapping more often than the target r* earns a wider gap and a
    starved pair a narrower one (adaptive PT, Miasojedow et al.).
    """
    b = np.asarray(betas, np.float64)
    if b.size == 1:
        return b.astype(np.float32)
    u = np.diff(np.log(b))  # (T-1,) positive gaps
    u = np.clip(u * np.exp(eta * (np.asarray(swap_rates) - target)), 1e-4, 20.0)
    log_b = -np.concatenate([np.cumsum(u[::-1])[::-1], [0.0]])
    return np.exp(log_b).astype(np.float32)


def make_pt_state(dist: Distribution, generator: torch.Generator, nbatch: int,
                  num_temps: int, device="cpu") -> PTState:
    """All replicas start at the same init draw (burn-in separates them)."""
    x0 = dist.init_x(generator, nbatch, device)  # (d, n)
    x = x0.expand((num_temps,) + x0.shape).contiguous()
    u, g = dist.potential_and_grad(x)
    dev = x.device
    t1 = max(num_temps - 1, 1)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return PTState(
        x=x, u=u, grad=g,
        grad_evals=zeros(nbatch),
        n_accept=zeros(num_temps, nbatch),
        n_swap_acc=zeros(t1, nbatch),
        n_swap_try=zeros(t1, nbatch),
        replica_id=torch.arange(num_temps, dtype=torch.int32, device=dev)[:, None]
        .expand(num_temps, nbatch).contiguous(),
        seen_hot=zeros(num_temps, nbatch, dtype=torch.bool),
        round_trips=zeros(num_temps, nbatch),
        n_iter=zeros(),
    )


def _exchange(a: Tensor, mask_next: Tensor, mask_prev: Tensor) -> Tensor:
    """Rung t takes rung t+1's value where ``mask_next``, t−1's where
    ``mask_prev``."""
    up = torch.roll(a, -1, dims=0)  # value from t+1
    down = torch.roll(a, 1, dims=0)  # value from t−1
    return torch.where(mask_next, up, torch.where(mask_prev, down, a))


def pt_step(
    dist: Distribution,
    state: PTState,
    generator: torch.Generator | None,
    parity: int,
    betas: Tensor,
    epsilon: float,
    num_leapfrog_steps: int,
    scale_eps: bool = True,
    v: Tensor | None = None,
    mh_uniform: Tensor | None = None,
    swap_uniform: Tensor | None = None,
) -> Tuple[PTState, PTStepOut]:
    """One PT iteration: per-replica HMC update, then even/odd exchange.

    ``parity`` (0/1) selects which adjacent pairs attempt an exchange;
    alternating it per iteration gives the deterministic even-odd sweep.
    ``v`` (T, d, n), ``mh_uniform`` (T, n) and ``swap_uniform`` (T−1, n)
    inject the momenta and uniforms (JAX's ``k_mom``, ``k_mh`` and
    ``k_swap`` draws); when absent they are drawn from ``generator``.
    """
    num_temps = state.x.shape[0]
    dev = state.x.device
    bt = betas[:, None]  # (T, 1) over chains
    btd = betas[:, None, None]  # (T, 1, 1) over (dim, chains)
    eps = torch.as_tensor(epsilon, dtype=torch.float32, device=dev)
    eps_t = eps * torch.rsqrt(btd) if scale_eps else eps * torch.ones_like(btd)

    if v is None:
        v = randn(generator, state.x.shape, dev)
    if mh_uniform is None:
        mh_uniform = torch.rand(state.u.shape, generator=generator, device=generator.device,
                                dtype=torch.float32).to(dev)
    if swap_uniform is None and num_temps > 1:
        swap_uniform = torch.rand((num_temps - 1,) + state.u.shape[1:], generator=generator,
                                  device=generator.device, dtype=torch.float32).to(dev)

    # ---- per-replica full-refresh HMC on the tempered target β_t·U -------
    h0 = bt * state.u + kinetic_energy(v, dist=dist)

    def tempered_pg(x):
        u, g = dist.potential_and_grad(x)
        return bt * u, btd * g

    x_l, v_l, hu_l, hg_l = leapfrog(tempered_pg, state.x, v, btd * state.grad, eps_t,
                                    num_leapfrog_steps)
    h_l = hu_l + kinetic_energy(v_l, dist=dist)
    log_p = (h0 - h_l).clamp(max=0.0)
    accept = (torch.log(mh_uniform) < log_p) & torch.isfinite(h_l)  # (T, n)

    # base-unit caches at the endpoint: the exact rescale of the tempered
    # values the integrator computed (no extra gradient evaluation)
    u_l, g_l = hu_l / bt, hg_l / btd
    ba = accept[:, None, :]
    x = torch.where(ba, x_l, state.x)
    u = torch.where(accept, u_l, state.u)
    g = torch.where(ba, g_l, state.grad)

    # ---- even/odd replica exchange along the ladder axis ------------------
    if num_temps > 1:
        # log α for pair (t, t+1): (β_{t+1} − β_t)(U_{t+1} − U_t)
        log_a = (betas[1:] - betas[:-1])[:, None] * (u[1:] - u[:-1])  # (T-1, n)
        active = ((torch.arange(num_temps - 1, device=dev) % 2) == parity)[:, None]
        swap = active & (torch.log(swap_uniform) < log_a)  # (T-1, n)
        with_next = F.pad(swap, (0, 0, 0, 1))  # (T, n): t trades with t+1
        with_prev = F.pad(swap, (0, 0, 1, 0))  # (T, n): t trades with t−1
        bn, bp = with_next[:, None, :], with_prev[:, None, :]
        x = _exchange(x, bn, bp)
        u = _exchange(u, with_next, with_prev)
        g = _exchange(g, bn, bp)
        rid = _exchange(state.replica_id, with_next, with_prev)
        n_swap_acc = state.n_swap_acc + swap.to(torch.int32)
        n_swap_try = state.n_swap_try + active.to(torch.int32)

        # replica flow: a round trip completes when a replica that touched
        # the hottest rung (0, β_min) reaches the cold rung (T−1, β=1); the
        # flag then resets, so repeated passages count
        rep_ids = torch.arange(num_temps, dtype=torch.int32, device=dev)[:, None]
        at_hot = rid[0][None, :] == rep_ids  # (T, n): replica r sits at rung 0
        at_cold = rid[-1][None, :] == rep_ids  # replica r sits at the cold rung
        seen_hot = state.seen_hot | at_hot
        completed = at_cold & seen_hot
        round_trips = state.round_trips + completed.to(torch.int32)
        seen_hot = seen_hot & ~completed
    else:
        swap = torch.zeros((1, state.x.shape[-1]), dtype=torch.bool, device=dev)
        rid = state.replica_id
        n_swap_acc, n_swap_try = state.n_swap_acc, state.n_swap_try
        seen_hot, round_trips = state.seen_hot, state.round_trips

    new_state = PTState(
        x=x, u=u, grad=g,
        grad_evals=state.grad_evals + num_temps * num_leapfrog_steps,
        n_accept=state.n_accept + accept.to(torch.int32),
        n_swap_acc=n_swap_acc,
        n_swap_try=n_swap_try,
        replica_id=rid,
        seen_hot=seen_hot,
        round_trips=round_trips,
        n_iter=state.n_iter + 1,
    )
    return new_state, PTStepOut(x=x[-1], accept=accept, swap_accept=swap)


def pt_run(
    dist: Distribution,
    state: PTState,
    generator: torch.Generator,
    num_steps: int,
    betas: Tensor,
    epsilon: float,
    num_leapfrog_steps: int,
    scale_eps: bool = True,
    collect: str = "samples",
) -> Tuple[PTState, dict]:
    """Run ``num_steps`` PT iterations with alternating exchange parity
    (0 first, as JAX's ``arange(num_steps) % 2``)."""
    if collect not in ("samples", "stats"):
        raise ValueError(f"unknown collect mode: {collect}")
    ndims, nbatch = state.x.shape[1:]

    def step(s, i):
        return pt_step(dist, s, generator, i % 2, betas, epsilon, num_leapfrog_steps,
                       scale_eps)

    if collect == "stats":
        acc = MomentAccumulator.init(ndims, nbatch, state.x.device)
        ones = torch.ones(nbatch, dtype=torch.float32, device=state.x.device)
        for i in range(num_steps):
            state, o = step(state, i)
            acc = acc.update(o.x, ones)
        return state, {"moments": acc}
    xs, ev = [], []
    for i in range(num_steps):
        state, o = step(state, i)
        # chain-mean cumulative eval counter (every replica charged)
        xs.append(o.x)
        ev.append(state.grad_evals.float().mean())
    return state, {"x": torch.stack(xs), "evals_mean": torch.stack(ev)}


@dataclasses.dataclass
class ParallelTempering:
    """Reference-style parallel tempering on the plain PyTorch path; runs
    on the card unless ``device="cpu"`` is asked for. ``unroll`` is
    accepted for the JAX signature and ignored."""

    distribution: Distribution
    epsilon: float = 0.5
    num_leapfrog_steps: int = 5
    nbatch: int = 128
    num_temps: int = 6
    beta_min: float = 0.05
    seed: int = 0
    unroll: int = 1
    scale_eps: bool = True
    device: str = "cuda"

    def __post_init__(self):
        self.device = checked_device(self.device, type(self).__name__)
        self.betas = torch.as_tensor(geometric_ladder(self.num_temps, self.beta_min),
                                     device=self.device)
        self.generator = torch.Generator().manual_seed(self.seed)
        self.state = make_pt_state(self.distribution, self.generator, self.nbatch,
                                   self.num_temps, self.device)

    def _run(self, num_steps: int, collect: str) -> dict:
        self.state, outs = pt_run(self.distribution, self.state, self.generator, num_steps,
                                  self.betas, self.epsilon, self.num_leapfrog_steps,
                                  self.scale_eps, collect)
        return outs

    def adapt_ladder(
        self,
        num_windows: int = 20,
        window_size: int = 50,
        target: float = 0.4,
        eta: float = 0.6,
    ) -> np.ndarray:
        """Windowed warmup tuning β toward uniform swap acceptance: after
        each of ``num_windows`` windows of ``window_size`` iterations,
        :func:`update_ladder` on that window's per-pair swap rates alone.
        Returns the tuned ladder."""
        for _ in range(num_windows):
            acc0 = self.state.n_swap_acc.cpu().numpy().astype(np.float64)
            try0 = self.state.n_swap_try.cpu().numpy().astype(np.float64)
            self._run(window_size, "stats")
            d_acc = self.state.n_swap_acc.cpu().numpy() - acc0
            d_try = np.maximum(self.state.n_swap_try.cpu().numpy() - try0, 1.0)
            rates = d_acc.mean(axis=-1) / d_try.mean(axis=-1)
            self.betas = torch.as_tensor(
                update_ladder(self.betas.cpu().numpy(), rates, target, eta), device=self.device)
        return self.betas.cpu().numpy()

    def sampling_iteration(self) -> dict:
        return self._run(1, "samples")

    def sample(self, num_steps: int) -> dict:
        """β=1 chain positions, shape (num_steps, ndims, nbatch)."""
        return self._run(num_steps, "samples")

    def burn_in(self, num_steps: int = 500) -> None:
        """Advance the chains and reset every counter and the replica-flow
        statistics."""
        self._run(num_steps, "stats")
        z = torch.zeros_like
        s = self.state
        self.state = s._replace(
            grad_evals=z(s.grad_evals), n_accept=z(s.n_accept), n_swap_acc=z(s.n_swap_acc),
            n_swap_try=z(s.n_swap_try), seen_hot=z(s.seen_hot), round_trips=z(s.round_trips),
            n_iter=z(s.n_iter),
        )

    @property
    def accept_rates(self) -> np.ndarray:
        """Mean HMC acceptance per temperature, shape (T,)."""
        n = max(int(self.state.n_iter), 1)
        return (self.state.n_accept.float().mean(dim=-1) / n).cpu().numpy()

    @property
    def swap_rates(self) -> np.ndarray:
        """Mean exchange acceptance per adjacent pair, shape (T-1,)."""
        tries = np.maximum(self.state.n_swap_try.cpu().numpy(), 1)
        return self.state.n_swap_acc.cpu().numpy().mean(axis=-1) / tries.mean(axis=-1)

    @property
    def round_trip_rate(self) -> float:
        """Mean completed hot→cold passages per replica per iteration (the
        PT mixing-health metric; 0 means no replica crosses the ladder)."""
        n_iters = max(int(self.state.n_iter), 1)
        return float(self.state.round_trips.cpu().numpy().mean() / n_iters)

    @property
    def grad_evals(self) -> int:
        """Total algorithmic gradient evaluations, every replica counted."""
        return int(self.state.grad_evals.sum(dtype=torch.int64))
