"""ChEES trajectory-length adaptation, plain PyTorch (counterpart of
``mjhmc_tpu.samplers.chees``; arXiv:2504.02627, Hoffman et al.).

Adapts the total integration time τ of jittered HMC by ascending

    ChEES = ¼ E[ (‖x' − μ‖² − ‖x − μ‖²)² ]

with a per-chain surrogate gradient: chain i runs a trajectory of u_i·τ
(u_i ~ U[1e-3, 1) jitter) as a masked leapfrog with a fixed step budget
(``ops.leapfrog.masked_leapfrog``) and contributes

    g_i = α_i · (‖x̂'‖² − ‖x̂‖²) · (x̂' · v'_i) · ε·round(u_i τ/ε)/τ

(α_i the MH acceptance probability, x̂ centred by the cross-chain mean).
log τ follows a hand-rolled Adam ascent (the JAX package's arithmetic, in
its order), ε dual averaging toward a target acceptance. The SMC head
uses the same machinery for its mutation kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import Distribution, randn
from mjhmc_tpu_torch.ops.leapfrog import masked_leapfrog, total_energy
from mjhmc_tpu_torch.samplers.adaptation import DualAveragingState, da_init, da_update
from mjhmc_tpu_torch.samplers.hmc import draw_uniform
from mjhmc_tpu_torch.samplers.state import HMCState

Tensor = torch.Tensor

# log τ's bounds, float32 logs as JAX forms them
LOG_TAU_MIN, LOG_TAU_MAX = float(np.log(np.float32(1e-3))), float(np.log(np.float32(1e4)))


class CheesState(NamedTuple):
    log_tau: Tensor  # () log total integration time
    m_adam: Tensor  # () Adam first moment
    v_adam: Tensor  # () Adam second moment
    step: Tensor  # () int32


def chees_init(tau0: float = 1.0, device="cpu") -> CheesState:
    def full(v, dtype=torch.float32):
        return torch.full((), v, dtype=dtype, device=device)

    return CheesState(log_tau=full(float(np.log(np.float32(tau0)))), m_adam=full(0.0),
                      v_adam=full(0.0), step=full(0, torch.int32))


def _adam_ascent(cs: CheesState, grad: Tensor, lr: float = 0.025) -> CheesState:
    b1, b2, eps = 0.9, 0.999, 1e-8
    step = cs.step + 1
    m = b1 * cs.m_adam + (1 - b1) * grad
    v = b2 * cs.v_adam + (1 - b2) * grad * grad
    t = step.to(torch.float32)
    mhat = m / (1 - b1 ** t)
    vhat = v / (1 - b2 ** t)
    log_tau = cs.log_tau + lr * mhat / (torch.sqrt(vhat) + eps)
    # keep τ within sane bounds
    log_tau = log_tau.clamp(LOG_TAU_MIN, LOG_TAU_MAX)
    return CheesState(log_tau=log_tau, m_adam=m, v_adam=v, step=step)


def _chain_sum(t: Tensor, mesh=None) -> Tensor:
    """Σ over the chain (last) axis, kept; over every rank's chains under a
    ``mesh`` (one all_reduce)."""
    s = t.sum(dim=-1, keepdim=True)
    if mesh is not None:
        import torch.distributed as tdist

        tdist.all_reduce(s, group=mesh.group())
    return s


def chees_surrogate_grad(x, xl, vl, alpha, tau_i, tau, mesh=None) -> Tensor:
    """The batch's ChEES gradient estimate w.r.t. log τ (shared by the
    jittered-HMC sampler and the SMC mutation kernel). The cross-chain
    means are sums over n, all_reduced over the ranks under a ``mesh``."""
    n = x.shape[-1] * (1 if mesh is None else mesh.size())
    xc = x - _chain_sum(x, mesh) / n
    xlc = xl - _chain_sum(xl, mesh) / n
    dsq = (xlc * xlc).sum(dim=-2) - (xc * xc).sum(dim=-2)
    proj = (xlc * vl).sum(dim=-2)
    per_chain = alpha * dsq * proj * (tau_i / tau)
    denom = _chain_sum(alpha, mesh)[0].clamp(min=1e-6)
    grad_raw = _chain_sum(per_chain, mesh)[0] / denom
    return torch.tanh(grad_raw / (grad_raw.abs() + 1e-12) * torch.log1p(grad_raw.abs()))


def draw_jitter(generator: torch.Generator, n: int, device) -> Tensor:
    """(n,) trajectory-length jitter, uniform in [1e-3, 1)."""
    return 1e-3 + (1.0 - 1e-3) * draw_uniform(generator, n, device)


def jittered_steps(jitter: Tensor, tau: Tensor, eps, max_leapfrog_steps: int) -> Tensor:
    """Per-chain step counts clip(round(u·τ/ε), 1, max) as int32 (round
    half to even, as ``jnp.round``)."""
    return torch.round(jitter * tau / eps).to(torch.int32).clamp(1, max_leapfrog_steps)


def chees_hmc_step(
    dist: Distribution,
    state: HMCState,
    cs: CheesState,
    da: DualAveragingState,
    generator: torch.Generator | None,
    max_leapfrog_steps: int,
    target_accept: float = 0.651,
    jitter: Tensor | None = None,
    v: Tensor | None = None,
    mh_uniform: Tensor | None = None,
) -> Tuple[HMCState, CheesState, DualAveragingState, dict]:
    """One jittered-HMC step + ChEES(τ) and dual-averaging(ε) updates.

    ``jitter`` (n,) in [1e-3, 1), ``v`` (d, n) N(0, I) and ``mh_uniform``
    (n,) inject the draws (JAX's ``k_u``, ``k_v`` and ``k_mh``); when
    absent they are drawn from ``generator``.
    """
    chain = state.chain
    x, u, g = chain.x, chain.u, chain.grad
    d, n = x.shape
    eps = float(np.exp(da.log_eps))  # float32 value, as JAX's exp(log ε)
    tau = torch.exp(cs.log_tau)
    if jitter is None:
        jitter = draw_jitter(generator, n, x.device)
    if v is None:
        v = randn(generator, (d, n), x.device)
    if mh_uniform is None:
        mh_uniform = draw_uniform(generator, n, x.device)
    m_i = jittered_steps(jitter, tau, eps, max_leapfrog_steps)

    h0 = total_energy(u, v, dist=dist)
    xl, vl, ul, gl, steps = masked_leapfrog(dist.potential_and_grad, x, v, g, eps,
                                            max_leapfrog_steps, m_i, u0=u)
    hl = total_energy(ul, vl, dist=dist)
    log_p = (h0 - hl).clamp(max=0.0)
    finite = torch.isfinite(hl)
    alpha = torch.where(finite, torch.exp(log_p), torch.zeros_like(log_p))
    accept = (torch.log(mh_uniform) < log_p) & finite

    am = accept[None, :]
    # ---- ChEES surrogate gradient (from the pre-move x) --------------------
    tau_i = eps * steps.to(torch.float32)
    cs = _adam_ascent(cs, chees_surrogate_grad(x, xl, vl, alpha, tau_i, tau))
    da = da_update(da, alpha.mean(), target=target_accept)

    x_new = torch.where(am, xl, x)
    new_state = HMCState(
        chain=chain._replace(x=x_new, v=torch.where(am, vl, v), u=torch.where(accept, ul, u),
                             grad=torch.where(am, gl, g)),
        grad_evals=state.grad_evals + steps,
        n_accept=state.n_accept + accept.to(torch.int32),
    )
    out = {"x": x_new, "accept_stat": alpha, "tau": tau, "eps": eps,
           "mean_steps": steps.to(torch.float32).mean()}
    return new_state, cs, da, out


def chees_hmc_run(
    dist: Distribution,
    state: HMCState,
    generator: torch.Generator,
    num_steps: int,
    max_leapfrog_steps: int = 64,
    tau0: float = 1.0,
    eps0: float = 0.2,
    target_accept: float = 0.651,
) -> Tuple[HMCState, CheesState, DualAveragingState, dict]:
    """Warmup loop: jittered HMC with joint (τ, ε) adaptation. The trace
    holds each step's τ, ε and mean acceptance probability."""
    cs = chees_init(tau0, state.chain.x.device)
    da = da_init(eps0)
    taus, epss, accs = [], [], []
    for _ in range(num_steps):
        state, cs, da, out = chees_hmc_step(dist, state, cs, da, generator,
                                            max_leapfrog_steps, target_accept)
        taus.append(out["tau"])
        epss.append(out["eps"])
        accs.append(out["accept_stat"].mean())
    return state, cs, da, {"tau": torch.stack(taus),
                           "eps": torch.tensor(epss, dtype=torch.float32),
                           "accept": torch.stack(accs)}
