"""Algebraic ladder samplers — the exact finite-state oracle (counterpart
of ``mjhmc_tpu.samplers.algebraic``).

Finite-state abstraction of HMC (arXiv:1509.03808): states are (rung k,
direction d) on a ladder of K rungs with given energies E_k; the L operator
moves one rung in direction d, F flips d, R randomizes d. The explicit 2K×2K
transition / rate matrices are a NumPy copy of the JAX package's; the
simulators run the jump chain and control HMC on the ladder as torch loops
on the device, with the continuous sampler's selection machinery, so the
rate logic is held against an exact eigensolution.

The ladder is **periodic** (k+d mod K): L is then a bijection with
L⁻¹ = F∘L∘F and H(Fζ)=H(ζ), so π(k,d) ∝ exp(-E_k)·½ is the unique
stationary law and the oracle is assumption-free.

State indexing: s ∈ [0, 2K): k = s mod K; d = +1 for s < K else −1.
Matrices are column-convention: M[i, j] = flow j → i; M @ π evolves a
distribution π.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mjhmc_tpu_torch.samplers.state import checked_device

Tensor = torch.Tensor


def _split_state(s: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    rung = s % k
    d = np.where(s < k, 1, -1)
    return rung, d


def ladder_stationary(energies: np.ndarray) -> np.ndarray:
    """Exact stationary distribution π(k,d) ∝ exp(-E_k)·½, shape (2K,)."""
    e = np.asarray(energies, np.float64)
    p = np.exp(-(e - e.min()))
    p = p / p.sum() / 2.0
    return np.concatenate([p, p])


def continuous_rate_matrix(energies: np.ndarray, beta: float) -> np.ndarray:
    """Generator A of the MJHMC jump process on the ladder, (2K, 2K).

    From (k,d): L-clock rate exp(-½(E_{k+d}−E_k)) → (k+d, d);
    F-clock rate max(0, Γ_L(k,−d) − Γ_L(k,d)) → (k,−d);
    R-clock rate β, new direction uniform → rate β/2 to (k,−d)
    (the β/2 self-transition is a no-op in a generator).
    """
    e = np.asarray(energies, np.float64)
    k = e.shape[0]
    n = 2 * k
    a = np.zeros((n, n))
    s = np.arange(n)
    rung, d = _split_state(s, k)

    def idx(rung, d):
        return np.where(d > 0, rung % k, k + (rung % k))

    gamma_l = np.exp(-0.5 * (e[(rung + d) % k] - e[rung]))
    gamma_lf = np.exp(-0.5 * (e[(rung - d) % k] - e[rung]))
    gamma_f = np.maximum(0.0, gamma_lf - gamma_l)

    a[idx(rung + d, d), s] += gamma_l
    a[idx(rung, -d), s] += gamma_f + beta / 2.0
    a[s, s] -= a.sum(axis=0)
    return a


def discrete_transition_matrix(
    energies: np.ndarray, beta: float, flip_on_reject: bool = True
) -> np.ndarray:
    """Column-stochastic transition matrix of control HMC on the ladder.

    One iteration = momentum corruption (flip d with prob β/2) followed by
    the MH move: accept (k+d, d) with min(1, exp(E_k − E_{k+d})), else flip
    to (k,−d). Mirrors ``samplers.hmc.hmc_step`` semantics exactly (§3.2).

    ``flip_on_reject=False`` is the plain-HMC variant: reject → stay. That
    is only π-invariant under full momentum refresh, so it requires β=1
    (direction fully randomized) and applies the corruption *after* the MH
    move so the returned matrix is exactly π-stationary.
    """
    e = np.asarray(energies, np.float64)
    k = e.shape[0]
    n = 2 * k
    s = np.arange(n)
    rung, d = _split_state(s, k)

    def idx(rung, d):
        return np.where(d > 0, rung % k, k + (rung % k))

    # corruption kernel C: flip direction with prob q
    q = beta / 2.0
    c = np.zeros((n, n))
    c[s, s] += 1.0 - q
    c[idx(rung, -d), s] += q

    # MH kernel M
    acc = np.minimum(1.0, np.exp(e[rung] - e[(rung + d) % k]))
    m = np.zeros((n, n))
    m[idx(rung + d, d), s] += acc
    if flip_on_reject:
        m[idx(rung, -d), s] += 1.0 - acc
        return m @ c
    assert abs(beta - 1.0) < 1e-12, "plain HMC (no flip) requires beta=1"
    m[s, s] += 1.0 - acc
    return c @ m


def reduced_flip_transition_matrix(
    energies: np.ndarray, beta: float
) -> np.ndarray:
    """Column-stochastic matrix of **reduced-flip HMC** on the ladder.

    The paper's discrete-time variant between control HMC and the jump
    process (SURVEY.md §2.4 "reduced-flip variant"): instead of flipping on
    *every* rejection, flip only with the excess backward leap probability

        p_leap(k,d)  = min(1, exp(E_k − E_{k+d}))
        p_flip(k,d)  = max(0, p_leap(k,−d) − p_leap(k,d))
        p_stay       = 1 − p_leap − p_flip.

    This is the discrete-time analogue of the F-clock's max(0, ·) rate and
    is π-stationary by the same telescoping balance (in-flow to (k,d):
    π(k−d)·p_leap(k−d,d) + π(k)·p_flip(k,−d) equals the out-flow
    π(k)·[p_leap + p_flip]; note p_leap + p_flip = max(p_leap fwd, bwd) ≤ 1
    so probabilities are valid). Composed with the same β/2 direction
    corruption kernel as ``discrete_transition_matrix``.
    """
    e = np.asarray(energies, np.float64)
    k = e.shape[0]
    n = 2 * k
    s = np.arange(n)
    rung, d = _split_state(s, k)

    def idx(rung, d):
        return np.where(d > 0, rung % k, k + (rung % k))

    q = beta / 2.0
    c = np.zeros((n, n))
    c[s, s] += 1.0 - q
    c[idx(rung, -d), s] += q

    p_leap = np.minimum(1.0, np.exp(e[rung] - e[(rung + d) % k]))
    p_leap_b = np.minimum(1.0, np.exp(e[rung] - e[(rung - d) % k]))
    p_flip = np.maximum(0.0, p_leap_b - p_leap)
    m = np.zeros((n, n))
    m[idx(rung + d, d), s] += p_leap
    m[idx(rung, -d), s] += p_flip
    m[s, s] += 1.0 - p_leap - p_flip
    return m @ c


class LadderSim(NamedTuple):
    """Empirical dwell-weighted occupation from simulating the jump chain."""

    occupation: Tensor  # (2K,) normalized dwell-weighted occupancy
    mean_dwell: Tensor  # scalar


def _uniform(generator: torch.Generator, shape, device) -> Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return u.to(device)


def _initial_states(generator, s0, k: int, nchains: int, device) -> Tensor:
    if s0 is None:
        s0 = torch.randint(0, 2 * k, (nchains,), generator=generator, device=generator.device)
    return torch.as_tensor(s0, device=device).to(torch.int64)


def _draws(given, t: int, device) -> Tensor | None:
    return None if given is None else torch.as_tensor(given[t], dtype=torch.float32,
                                                      device=device)


def _sidx(rung: Tensor, d: Tensor, k: int) -> Tensor:
    return torch.where(d > 0, rung % k, k + rung % k)


def _one_hot(s: Tensor, n: int) -> Tensor:
    return torch.nn.functional.one_hot(s, n).to(torch.float32)


def simulate_jump_ladder(
    energies: np.ndarray,
    beta: float,
    generator: torch.Generator | None,
    num_steps: int,
    nchains: int = 1024,
    *,
    device="cuda",
    s0=None,
    gumbel=None,
    uniform=None,
) -> LadderSim:
    """Simulate the ladder jump process with the continuous sampler's exact
    selection machinery (Gumbel-max over log-rates + Rao-Blackwell dwell
    weights), vectorized over chains, on ``device``. Used by the oracle
    tests to pin the rate logic against ``continuous_rate_matrix``'s
    eigensolution.

    The draws come from ``generator`` unless given: ``s0`` (nchains,) the
    initial states, ``gumbel`` (num_steps, 3, nchains) the Gumbel noise of
    each step's (L, F, R) clocks and ``uniform`` (num_steps, nchains) each
    step's R-clock direction uniform (a test feeds the JAX simulator's).
    """
    device = checked_device(device, "simulate_jump_ladder")
    e = torch.as_tensor(np.asarray(energies), dtype=torch.float32, device=device)
    k = e.shape[0]
    beta_t = torch.tensor(beta, dtype=torch.float32, device=device)
    s = _initial_states(generator, s0, k, nchains, device)
    occ = torch.zeros(2 * k, dtype=torch.float32, device=device)
    wsum = torch.zeros((), dtype=torch.float32, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for t in range(num_steps):
        rung = s % k
        d = torch.where(s < k, 1, -1)
        gamma_l = torch.exp(-0.5 * (e[(rung + d) % k] - e[rung]))
        gamma_lf = torch.exp(-0.5 * (e[(rung - d) % k] - e[rung]))
        gamma_f = (gamma_lf - gamma_l).clamp(min=0.0)
        dwell = 1.0 / (gamma_l + gamma_f + beta_t)

        log_rates = torch.stack([torch.log(gamma_l), torch.log(gamma_f),
                                 torch.log(beta_t).expand_as(gamma_l)])
        gum = _draws(gumbel, t, device)
        if gum is None:
            gum = -torch.log(-torch.log(_uniform(generator, (3, nchains), device).clamp(min=tiny)))
        sel = torch.argmax(log_rates + gum, dim=0)
        un = _draws(uniform, t, device)
        if un is None:
            un = _uniform(generator, (nchains,), device)

        s_l = _sidx(rung + d, d, k)
        s_f = _sidx(rung, -d, k)
        s_r = _sidx(rung, torch.where(un < 0.5, 1, -1), k)
        s_next = torch.where(sel == 0, s_l, torch.where(sel == 1, s_f, s_r))

        occ = occ + (_one_hot(s, 2 * k) * dwell[:, None]).sum(dim=0)
        wsum = wsum + dwell.sum()
        s = s_next
    return LadderSim(occupation=occ / wsum, mean_dwell=wsum / (num_steps * nchains))


def embedded_jump_chain(energies: np.ndarray, beta: float) -> np.ndarray:
    """Discrete-time chain embedded in the jump process — one matrix row
    per *iteration* of the Rao-Blackwellized sampler (each iteration costs
    the same M gradient evals as one discrete-HMC step, so per-step
    spectral gaps of this matrix vs ``discrete_transition_matrix`` compare
    the samplers at matched gradient budget).

    P[i,j] = rate(j→i)/total(j) off-diagonal, with the R-clock's 50%
    same-direction refresh as a (β/2)/total self-loop.
    """
    a = continuous_rate_matrix(energies, beta)
    total = -np.diag(a) + beta / 2.0  # Γ_L + Γ_F + β
    p = a.copy()
    np.fill_diagonal(p, 0.0)
    p = p / total[None, :]
    np.fill_diagonal(p, (beta / 2.0) / total)
    return p


def simulate_discrete_ladder(
    energies: np.ndarray,
    beta: float,
    generator: torch.Generator | None,
    num_steps: int,
    nchains: int = 1024,
    *,
    device="cuda",
    s0=None,
    uniforms=None,
) -> Tensor:
    """Simulate control HMC on the ladder (corrupt → MH → flip-on-reject),
    mirroring ``discrete_transition_matrix``, on ``device``; returns the
    empirical occupation (2K,).

    The draws come from ``generator`` unless given: ``s0`` (nchains,) the
    initial states and ``uniforms`` (num_steps, 2, nchains) each step's
    corruption and Metropolis uniforms (the JAX simulator splits a third
    key per step and draws nothing from it).
    """
    device = checked_device(device, "simulate_discrete_ladder")
    e = torch.as_tensor(np.asarray(energies), dtype=torch.float32, device=device)
    k = e.shape[0]
    q = beta / 2.0
    s = _initial_states(generator, s0, k, nchains, device)
    occ = torch.zeros(2 * k, dtype=torch.float32, device=device)
    for t in range(num_steps):
        un = _draws(uniforms, t, device)
        if un is None:
            un = _uniform(generator, (2, nchains), device)
        rung = s % k
        d = torch.where(s < k, 1, -1)
        # corruption: flip direction with prob q
        d = torch.where(un[0] < q, -d, d)
        acc_p = torch.exp(e[rung] - e[(rung + d) % k]).clamp(max=1.0)
        acc = un[1] < acc_p
        rung_new = torch.where(acc, (rung + d) % k, rung)
        d_new = torch.where(acc, d, -d)
        s = torch.where(d_new > 0, rung_new, k + rung_new)
        occ = occ + _one_hot(s, 2 * k).sum(dim=0)
    return occ / occ.sum()


def random_ladder_energies(generator: torch.Generator, k: int, scale: float = 1.0) -> np.ndarray:
    """Randomly drawn rung energies (the reference's ladder setup)."""
    z = torch.randn(k, generator=generator, device=generator.device, dtype=torch.float32)
    return (scale * z).cpu().numpy().astype(np.float64)
