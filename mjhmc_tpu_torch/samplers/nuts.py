"""NUTS baseline, plain PyTorch (counterpart of ``mjhmc_tpu.samplers.nuts``;
arXiv:1111.4246).

The iterative formulation, all chains at once with masks:

- progressive doubling up to ``max_depth`` rounds, each in a random
  direction, with early exit: the round loop stops once every chain is
  done and a subtree's leaf loop once every chain has stopped inside it;
  stopped chains keep their state, and the eval counters count only the
  leaves a chain integrated;
- within a subtree the binary-counter U-turn stack: leaf ``i`` is stored in
  row ``m`` when ``i % 2^m == 0``, and when it completes a span of size
  2^m (``(i+1) % 2^m == 0``) it is checked against the stored left end;
- multinomial (progressive) sampling of the proposal within subtrees and
  biased progressive sampling when merging a subtree into the tree, in log
  space; a divergence guard at ΔH > ``divergence_threshold``.

Momenta are kept in the trajectory frame (pointing minus → plus); backward
integration negates on entry and exit. The U-turn criterion projects Δx on
the velocities M⁻¹v. One fused ``potential_and_grad`` per leaf, gradients
cached at both tree endpoints, so each leaf costs exactly one gradient.
Random draws come from an explicit ``torch.Generator``; they are not the
JAX sampler's, so the two agree in law.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from mjhmc_tpu_torch.models.base import Distribution, randn, sum_dims
from mjhmc_tpu_torch.ops.leapfrog import inv_mass_of, momentum_scale, total_energy
from mjhmc_tpu_torch.samplers.hmc import draw_uniform
from mjhmc_tpu_torch.samplers.state import checked_device

Tensor = torch.Tensor


class NUTSState(NamedTuple):
    x: Tensor  # (ndims, nbatch)
    u: Tensor  # (nbatch,) potential at x
    grad: Tensor  # (ndims, nbatch) dU/dx at x
    grad_evals: Tensor  # (nbatch,) int32 algorithmic counter


class NUTSStepOut(NamedTuple):
    x: Tensor  # (ndims, nbatch) new positions
    depth: Tensor  # (nbatch,) int32 tree depth reached
    accept_stat: Tensor  # (nbatch,) mean MH stat over visited leaves (for DA)
    diverged: Tensor  # (nbatch,) bool
    n_leaves: Tensor  # (nbatch,) int32 leaves actually integrated


def make_nuts_state(dist: Distribution, generator: torch.Generator, nbatch: int,
                    device="cpu") -> NUTSState:
    x = dist.init_x(generator, nbatch, device)
    u, g = dist.potential_and_grad(x)
    return NUTSState(x=x, u=u, grad=g,
                     grad_evals=torch.zeros(nbatch, dtype=torch.int32, device=x.device))


def _dot(dist, a: Tensor, b: Tensor) -> Tensor:
    """Per-chain dot product: (d, n)·(d, n) → (n,), summed by ``dist``'s
    hook (``models.base.sum_dims``)."""
    return sum_dims(dist, a * b)


def nuts_step(
    dist: Distribution,
    state: NUTSState,
    generator: torch.Generator,
    epsilon: float,
    max_depth: int = 8,
    divergence_threshold: float = 1000.0,
    inv_mass: Tensor | None = None,
) -> Tuple[NUTSState, NUTSStepOut]:
    """One NUTS iteration for all chains. ``inv_mass``: optional (ndims, 1)
    diagonal M⁻¹ (Stan convention: the target's variances); momenta are
    then drawn from N(0, M)."""
    d, n = state.x.shape
    dev = state.x.device
    eps = float(epsilon)

    def vel(v):  # momentum → velocity (metric-aware U-turn projection)
        return v if inv_mass is None else inv_mass * v

    def leapfrog1(x, v, g):
        v_half = v - 0.5 * eps * g
        x_new = x + eps * vel(v_half)
        u_new, g_new = dist.potential_and_grad(x_new)
        return x_new, v_half - 0.5 * eps * g_new, u_new, g_new

    v0 = momentum_scale(inv_mass) * randn(generator, (d, n), dev)
    h0 = total_energy(state.u, v0, inv_mass, dist)

    def zeros(dtype=torch.float32):
        return torch.zeros(n, dtype=dtype, device=dev)

    # tree endpoints (trajectory frame) and the proposal (the root)
    x_minus = x_plus = state.x
    v_minus = v_plus = v0
    g_minus = g_plus = state.grad
    x_prop, u_prop, g_prop = state.x, state.u, state.grad
    log_w_tree = zeros()  # log weight of the root: H0 − H0
    done, diverged = zeros(torch.bool), zeros(torch.bool)
    depth, n_leaves = zeros(torch.int32), zeros(torch.int32)
    sum_alpha, n_alpha = zeros(), zeros()

    for j in range(max_depth):
        if bool(done.all()):
            break
        go_right = (draw_uniform(generator, n, dev) < 0.5)[None, :]
        # integration start: outward from the chosen endpoint, integration
        # frame (backward → negate the trajectory-frame v)
        x_c = torch.where(go_right, x_plus, x_minus)
        v_c = torch.where(go_right, v_plus, -v_minus)
        g_c = torch.where(go_right, g_plus, g_minus)

        stack_x = [torch.zeros_like(x_c) for _ in range(j + 1)]
        stack_v = [torch.zeros_like(x_c) for _ in range(j + 1)]
        sub_stop, sub_div = zeros(torch.bool), zeros(torch.bool)
        log_w_sub = torch.full((n,), -torch.inf, device=dev)
        xp_sub, up_sub, gp_sub = x_c, zeros(), g_c
        for i in range(2**j):
            active = ~done & ~sub_stop
            if not bool(active.any()):
                break
            am = active[None, :]
            x_n, v_n, u_n, g_n = leapfrog1(x_c, v_c, g_c)
            x_c = torch.where(am, x_n, x_c)
            v_c = torch.where(am, v_n, v_c)
            g_c = torch.where(am, g_n, g_c)
            n_leaves = n_leaves + active.to(torch.int32)

            h = total_energy(u_n, v_c, inv_mass, dist)
            delta_h = h - h0
            div_now = active & (~torch.isfinite(h) | (delta_h > divergence_threshold))
            sub_div = sub_div | div_now

            # progressive multinomial within the subtree
            log_w_leaf = torch.where(active & ~div_now, -delta_h, -torch.inf)
            log_w_new = torch.logaddexp(log_w_sub, log_w_leaf)
            lu = torch.log(draw_uniform(generator, n, dev))
            take = active & (lu < log_w_leaf - log_w_new)
            tm = take[None, :]
            xp_sub = torch.where(tm, x_c, xp_sub)
            up_sub = torch.where(take, u_n, up_sub)
            gp_sub = torch.where(tm, g_c, gp_sub)
            log_w_sub = torch.where(active, log_w_new, log_w_sub)

            sum_alpha = sum_alpha + torch.where(active, torch.exp((-delta_h).clamp(max=0.0)), 0.0)
            n_alpha = n_alpha + active.to(torch.float32)

            # binary-counter stack: leaf i opens the spans of size 2^m it is
            # a multiple of and closes those i + 1 is a multiple of
            turning = zeros(torch.bool)
            for m in range(1, j + 1):
                if i % 2**m == 0:
                    stack_x[m] = torch.where(am, x_c, stack_x[m])
                    stack_v[m] = torch.where(am, v_c, stack_v[m])
            for m in range(1, j + 1):
                if (i + 1) % 2**m == 0:
                    dx = x_c - stack_x[m]
                    turning = (turning | (_dot(dist, dx, vel(stack_v[m])) < 0.0)
                               | (_dot(dist, dx, vel(v_c)) < 0.0))
            sub_stop = sub_stop | div_now | (active & turning)

        diverged = diverged | sub_div
        ok = ~done & ~sub_stop  # subtree completed cleanly
        okm = ok[None, :]

        # biased progressive merge of the subtree proposal into the tree
        lu = torch.log(draw_uniform(generator, n, dev))
        merge = ok & (lu < log_w_sub - log_w_tree)
        mm = merge[None, :]
        x_prop = torch.where(mm, xp_sub, x_prop)
        u_prop = torch.where(merge, up_sub, u_prop)
        g_prop = torch.where(mm, gp_sub, g_prop)
        log_w_tree = torch.where(ok, torch.logaddexp(log_w_tree, log_w_sub), log_w_tree)

        # extend the tree endpoints (back to the trajectory frame)
        rt, lt = okm & go_right, okm & ~go_right
        x_plus = torch.where(rt, x_c, x_plus)
        v_plus = torch.where(rt, v_c, v_plus)
        g_plus = torch.where(rt, g_c, g_plus)
        x_minus = torch.where(lt, x_c, x_minus)
        v_minus = torch.where(lt, -v_c, v_minus)
        g_minus = torch.where(lt, g_c, g_minus)
        depth = torch.where(ok, j + 1, depth).to(torch.int32)

        # overall U-turn between the tree endpoints (trajectory frame)
        dx = x_plus - x_minus
        global_turn = (_dot(dist, dx, vel(v_minus)) < 0.0) | (_dot(dist, dx, vel(v_plus)) < 0.0)
        done = done | sub_stop | (ok & global_turn)

    new_state = NUTSState(x=x_prop, u=u_prop, grad=g_prop,
                          grad_evals=state.grad_evals + n_leaves)
    out = NUTSStepOut(x=x_prop, depth=depth,
                      accept_stat=sum_alpha / n_alpha.clamp(min=1.0),
                      diverged=diverged, n_leaves=n_leaves)
    return new_state, out


def nuts_run(
    dist: Distribution,
    state: NUTSState,
    generator: torch.Generator,
    num_steps: int,
    epsilon: float,
    max_depth: int = 8,
    inv_mass: Tensor | None = None,
) -> Tuple[NUTSState, dict]:
    """Run ``num_steps`` NUTS iterations: x, depth, accept_stat, diverged and
    the chain-mean cumulative eval counter per iteration."""
    outs = []
    for _ in range(num_steps):
        state, o = nuts_step(dist, state, generator, epsilon, max_depth, inv_mass=inv_mass)
        outs.append((o.x, o.depth, o.accept_stat, o.diverged,
                     state.grad_evals.to(torch.float32).mean()))
    xs, depth, acc, div, ev = (torch.stack(c) for c in zip(*outs))
    return state, {"x": xs, "depth": depth, "accept_stat": acc, "diverged": div,
                   "evals_mean": ev}


def sharded_nuts_run(
    mesh,
    dist: Distribution,
    state: NUTSState,
    seed: int,
    num_steps: int,
    epsilon: float,
    max_depth: int = 8,
    inv_mass: Tensor | None = None,
) -> Tuple[NUTSState, dict]:
    """Chain-sharded NUTS over a ("chains",) mesh with per-rank early exit.

    Each rank runs ``nuts_run`` on its own block of the chains (``state``),
    so its doubling and leaf loops stop as soon as ITS chains are done, and
    nothing is communicated inside the run. Each rank's generator is seeded
    from (``seed``, rank), the counterpart of JAX's ``fold_in(key,
    axis_index)``. The outputs are the rank's blocks, plus
    ``evals_mean_shards`` (steps, P): every rank's chain-mean eval counter
    per iteration, all_gathered once after the run.
    """
    rank, p = mesh.axis_index(), mesh.size()
    words = np.random.SeedSequence((int(seed), rank)).generate_state(2, np.uint32)
    generator = torch.Generator().manual_seed(int(words[0]) << 32 | int(words[1]))
    state, outs = nuts_run(dist, state, generator, num_steps, epsilon, max_depth, inv_mass)
    ev = outs.pop("evals_mean")
    parts = [torch.empty_like(ev) for _ in range(p)]
    tdist.all_gather(parts, ev, group=mesh.group())
    outs["evals_mean_shards"] = torch.stack(parts, dim=1)
    return state, outs


@dataclasses.dataclass
class NUTS:
    """Reference-style NUTS on the plain PyTorch path (same shape as
    ``MarkovJumpHMC``/``ControlHMC``); runs on the card unless
    ``device="cpu"`` is asked for. ``mass_diag``: per-dim diagonal mass M
    (Stan convention: pass 1/variance)."""

    distribution: Distribution
    epsilon: float = 0.5
    max_depth: int = 8
    nbatch: int = 128
    seed: int = 0
    mass_diag: tuple | None = None
    device: str = "cuda"

    def __post_init__(self):
        self.device = checked_device(self.device, type(self).__name__)
        self.generator = torch.Generator().manual_seed(self.seed)
        self.state = make_nuts_state(self.distribution, self.generator, self.nbatch,
                                     self.device)
        self.inv_mass = inv_mass_of(self.mass_diag, self.device)

    def _run(self, num_steps: int) -> dict:
        self.state, outs = nuts_run(self.distribution, self.state, self.generator,
                                    num_steps, self.epsilon, self.max_depth, self.inv_mass)
        return outs

    def sample(self, num_steps: int) -> dict:
        return self._run(num_steps)

    def burn_in(self, num_steps: int = 200) -> None:
        """Advance the chains and reset the counters."""
        self._run(num_steps)
        self.state = self.state._replace(grad_evals=torch.zeros_like(self.state.grad_evals))

    @property
    def grad_evals(self) -> int:
        return int(self.state.grad_evals.sum())
