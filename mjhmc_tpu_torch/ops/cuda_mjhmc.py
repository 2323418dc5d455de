"""Fused MJHMC engine on CUDA (counterpart of ``mjhmc_tpu.ops.pallas_mjhmc``).

One kernel launch runs a whole sampling run: per chain, ``num_steps`` jump
iterations, each integrating the forward and backward M-step leapfrog
trajectories, computing the clipped rates and the dwell weight, choosing
L, F or R by inverse CDF, refreshing momentum by Box-Muller and updating
the backward-energy cache; it accumulates Kahan sums of Σw, Σw·x, Σw·x²
and the exact int32 eval counters. The stream form also emits every
``thin``-th iteration's pre-transition x, dwell weight and cumulative evals.

The kernel is hand-written CUDA C++ (``csrc/mjhmc_engine.cu``), built by
``ops._build``. Beside it this module holds its plain PyTorch version
(``mjhmc_run_reference`` / ``mjhmc_stream_reference``) with the same
contract. The wrappers ``cuda_mjhmc_run`` / ``cuda_mjhmc_stream_run`` launch
the kernel for CUDA tensors and call the plain version for CPU tensors.

Random numbers come from Philox4x32-10 keyed by the run seed with counter
(chain, iteration, block, 0): 1 + 2·d words per iteration (word 0 picks the
clock, words 1+i and 1+d+i make dim i's Box-Muller normal). The plain
version computes the same words bit for bit. ``fixed_uniform=True`` makes
every uniform 2⁻²⁵ in both, which is what the TPU kernel gives in Pallas
interpret mode, so the CPU tests can hold this engine against it.

Public layout is the JAX one without the TPU's (d, 8, L) fold: states
(d, nbatch), per-chain scalars (nbatch,), any nbatch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import randn
from mjhmc_tpu_torch.models.gaussian import Gaussian
from mjhmc_tpu_torch.models.rough_well import RoughWell
from mjhmc_tpu_torch.samplers.state import MJState

Tensor = torch.Tensor

LOG_RATE_MAX = 25.0
NEG_INF = -1e30
#: the uniform every draw takes in fixed-uniform mode (Pallas interpret mode
#: returns zero bits, and _uniform turns those into 2⁻²⁵)
FIXED_UNIFORM = 2.0**-25
#: state dimensions the kernel is instantiated for (csrc/mjhmc_engine.cu)
KERNEL_DIMS = (2, 50)


# --------------------------------------------------------------------------
# energy specs: an energy id for the kernel, scalar constants, per-dim params
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoughWellSpec:
    scale1: float
    scale2: float
    amplitude: float = 1.0
    energy_id: ClassVar[int] = 0

    def constants(self) -> tuple:
        """(1/s1², 1/s2, a/s2, 0.5/s1², a): the kernel's k0..k4."""
        s1, s2, a = self.scale1, self.scale2, self.amplitude
        return (1.0 / s1**2, 1.0 / s2, a / s2, 0.5 / s1**2, a)

    def param_vector(self, ndims: int) -> np.ndarray:
        return np.ones((ndims,), np.float32)

    def du(self, x, params):
        return x * (1.0 / self.scale1**2) - torch.sin(x * (1.0 / self.scale2)) * (
            self.amplitude / self.scale2
        )

    def u_sum(self, x, params):
        return (
            x * x * (0.5 / self.scale1**2)
            + self.amplitude * torch.cos(x * (1.0 / self.scale2))
        ).sum(dim=-2)


@dataclasses.dataclass(frozen=True)
class GaussianSpec:
    precisions: tuple  # per-dim 1/σ²
    energy_id: ClassVar[int] = 1

    def constants(self) -> tuple:
        return (0.0,) * 5

    def param_vector(self, ndims: int) -> np.ndarray:
        return np.asarray(self.precisions, np.float32)

    def du(self, x, params):
        return x * params

    def u_sum(self, x, params):
        return 0.5 * (x * x * params).sum(dim=-2)


def energy_spec_for(dist):
    if isinstance(dist, RoughWell):
        return RoughWellSpec(dist.scale1, dist.scale2, dist.amplitude)
    if isinstance(dist, Gaussian):
        return GaussianSpec(tuple(float(v) for v in 1.0 / dist.variances))
    raise NotImplementedError(
        f"no fused CUDA energy for {type(dist).__name__} yet "
        "(ROADMAP.md, 'TPU kernels to port', items 5 and 8)"
    )


def _check_slice(spec, variant, integrator, inv_mass):
    if variant != "mjhmc":
        raise NotImplementedError(
            f"engine variant {variant!r} is not ported yet "
            "(ROADMAP.md, 'TPU kernels to port', items 3, 6 and 7)"
        )
    if integrator != "leapfrog" or inv_mass is not None:
        raise NotImplementedError(
            "the two-stage integrator and inv_mass are not ported yet "
            "(ROADMAP.md, 'TPU kernels to port', item 4)"
        )
    if not isinstance(spec, (RoughWellSpec, GaussianSpec)):
        raise NotImplementedError(
            f"no fused CUDA energy for {type(spec).__name__} yet "
            "(ROADMAP.md, 'TPU kernels to port', items 5 and 8)"
        )


# --------------------------------------------------------------------------
# Philox4x32-10 in plain torch (int64 tensors holding 32-bit words)
# --------------------------------------------------------------------------
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: Tensor):
    """(hi, lo) words of the 64-bit product a·b. An int64 cannot hold a
    32×32-bit product, so b is split into 16-bit limbs."""
    p_lo = a * (b & 0xFFFF)  # < 2^48
    p_hi = a * (b >> 16)  # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(counter, key) -> tuple:
    """Philox4x32-10 (Random123 constants). ``counter``: four int64 tensors
    or ints holding 32-bit words, broadcast together; ``key``: two ints.
    Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(seed: int, iterations: range, nbatch: int, nwords: int,
                    device) -> Tensor:
    """(len(iterations), nwords, nbatch) float32 uniforms in (0, 1), built as
    the TPU kernel's ``_uniform``: top 24 bits × 2⁻²⁴ + 2⁻²⁵. The draws do
    not depend on the state, so many iterations are made in one pass."""
    nblocks = (nwords + 3) // 4
    kw = dict(dtype=torch.int64, device=device)
    counter = (
        torch.arange(nbatch, **kw)[None, None, :],  # chain
        torch.tensor(list(iterations), **kw)[:, None, None],  # iteration
        torch.arange(nblocks, **kw)[None, :, None],  # block
        torch.zeros((), **kw),
    )
    words = philox4x32(counter, (int(seed) & _MASK32, 0))  # each (T, nblocks, n)
    words = torch.stack(words, dim=2).reshape(len(iterations), 4 * nblocks, nbatch)
    return (words[:, :nwords] >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25


# --------------------------------------------------------------------------
# plain PyTorch version of the kernel
# --------------------------------------------------------------------------
class RunOut(NamedTuple):
    """Counterpart of ``PallasRunOut`` on the (d, n) / (n,) layout."""

    x: Tensor
    v: Tensor
    grad: Tensor
    u: Tensor
    h_back: Tensor
    back_valid: Tensor  # (n,) float 0/1
    w: Tensor  # (n,) Σ dwell weight per chain
    wx: Tensor  # (d, n)
    wx2: Tensor  # (d, n)
    evals: Tensor  # (n,) int32 algorithmic grad evals, exact per chain


def _kadd(s, c, inc):
    """Kahan compensated add (the kernels' ``_kadd``)."""
    y = inc - c
    t = s + y
    return t, (t - s) - y


def _log_rate(h_to, h_cur):
    raw = -0.5 * (h_to - h_cur)
    ok = (h_to.abs() < 1e30) & (h_to == h_to)
    return torch.where(ok, raw.clamp(max=LOG_RATE_MAX), NEG_INF)


def _halfsq(v):
    return 0.5 * (v * v).sum(dim=-2)


#: iterations whose Philox draws the plain version makes in one pass
_DRAW_CHUNK = 64


def _reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
               num_iters, m, thin, emit, fixed_uniform):
    d, n = x.shape
    dev = x.device
    params = torch.as_tensor(spec.param_vector(d), device=dev)[:, None]
    w = wc = torch.zeros_like(u)
    wx = wxc = wx2 = wx2c = torch.zeros_like(x)
    evals = torch.zeros(n, dtype=torch.int32, device=dev)
    valid = back_valid
    emits = []
    he = 0.5 * epsilon
    for t in range(num_iters):
        h_cur = u + _halfsq(v)
        xs2, vs2, gs2 = torch.stack([x, x]), torch.stack([v, -v]), torch.stack([g, g])
        for _ in range(m):
            vh = vs2 - he * gs2
            xs2 = xs2 + epsilon * vh
            gs2 = spec.du(xs2, params)
            vs2 = vh - he * gs2
        us2 = spec.u_sum(xs2, params)
        h2 = us2 + _halfsq(vs2)
        h_l = h2[0]
        h_b = torch.where(valid > 0.5, h_back, h2[1])

        gamma_l = torch.exp(_log_rate(h_l, h_cur).clamp(min=NEG_INF))
        gamma_f = (torch.exp(_log_rate(h_b, h_cur)) - gamma_l).clamp(min=0.0)
        total = gamma_l + gamma_f + beta
        dwell = 1.0 / total

        if fixed_uniform:
            unif = torch.full((1 + 2 * d, n), FIXED_UNIFORM, device=dev)
        else:
            if t % _DRAW_CHUNK == 0:
                its = range(t, min(t + _DRAW_CHUNK, num_iters))
                draws = philox_uniforms(seed, its, n, 1 + 2 * d, dev)
            unif = draws[t % _DRAW_CHUNK]
        u_sel = unif[0] * total
        is_l = u_sel < gamma_l
        is_f = ~is_l & (u_sel < gamma_l + gamma_f)
        is_r = ~is_l & ~is_f

        evals = evals + torch.where(valid > 0.5, m, 2 * m).to(torch.int32)
        w, wc = _kadd(w, wc, dwell)
        wx, wxc = _kadd(wx, wxc, dwell * x)
        wx2, wx2c = _kadd(wx2, wx2c, dwell * x * x)
        if emit and (t + 1) % thin == 0:
            emits.append((x, dwell, evals))

        v_fresh = torch.sqrt(-2.0 * torch.log(unif[1 : 1 + d])) * torch.cos(
            (2.0 * math.pi) * unif[1 + d :]
        )
        x = torch.where(is_l, xs2[0], x)
        v = torch.where(is_l, vs2[0], torch.where(is_f, -v, v_fresh))
        g = torch.where(is_l, gs2[0], g)
        u = torch.where(is_l, us2[0], u)
        h_back = torch.where(is_l, h_cur, torch.where(is_f, h_l, h_back))
        valid = torch.where(is_r, 0.0, 1.0)
    out = RunOut(x, v, g, u, h_back, valid, w, wx, wx2, evals)
    if not emit:
        return out
    if not emits:
        return x.new_empty((0, d, n)), u.new_empty((0, n)), evals.new_empty((0, n)), out
    xs, ws, es = (torch.stack(c) for c in zip(*emits))
    return xs, ws, es, out


def mjhmc_run_reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon,
                        beta, num_steps, num_leapfrog, fixed_uniform=False):
    """Plain PyTorch version of the run kernel (same contract, any device)."""
    return _reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                      num_steps, num_leapfrog, 1, False, fixed_uniform)


def mjhmc_stream_reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon,
                           beta, num_emits, thin, num_leapfrog,
                           fixed_uniform=False):
    """Plain PyTorch version of the stream kernel: returns (xs (E, d, n),
    ws (E, n), es (E, n) int32, RunOut)."""
    return _reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                      num_emits * thin, num_leapfrog, thin, True, fixed_uniform)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------
def _launch(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
            num_iters, m, thin, num_emits, fixed_uniform):
    """Check the state, allocate the outputs and launch the kernel."""
    from mjhmc_tpu_torch.ops import _build

    if x.device.type != "cuda":
        raise ValueError(
            f"the CUDA engine takes cuda tensors (or cpu ones for its plain "
            f"version), not {x.device}"
        )
    if x.dim() != 2:
        raise ValueError(f"x must be (ndims, nbatch), got {tuple(x.shape)}")
    d, n = x.shape
    if d not in KERNEL_DIMS:
        raise NotImplementedError(
            f"the kernel is instantiated for ndims in {KERNEL_DIMS}, not {d} "
            "(ROADMAP.md, 'TPU kernels to port', item 1)"
        )
    if n == 0 or thin < 1 or num_iters < 0:
        raise ValueError(f"need nbatch > 0, thin >= 1, steps >= 0 (got {n}, {thin}, {num_iters})")
    for name, t, shape in (
        ("x", x, (d, n)), ("v", v, (d, n)), ("g", g, (d, n)), ("u", u, (n,)),
        ("h_back", h_back, (n,)), ("back_valid", back_valid, (n,)),
    ):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous float32 {shape} tensor on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    lib = _build.load()
    params = torch.as_tensor(spec.param_vector(d), device=x.device).contiguous()
    out = RunOut(
        torch.empty_like(x), torch.empty_like(x), torch.empty_like(x),
        torch.empty_like(u), torch.empty_like(u), torch.empty_like(u),
        torch.empty_like(u), torch.empty_like(x), torch.empty_like(x),
        torch.empty((n,), dtype=torch.int32, device=x.device),
    )
    if num_emits is None:
        emits = (None, None, None)
    else:
        emits = (
            torch.empty((num_emits, d, n), dtype=torch.float32, device=x.device),
            torch.empty((num_emits, n), dtype=torch.float32, device=x.device),
            torch.empty((num_emits, n), dtype=torch.int32, device=x.device),
        )
    ptrs = [t.data_ptr() for t in (x, v, g, u, h_back, back_valid, *out)]
    ptrs += [None if t is None else t.data_ptr() for t in emits]
    rc = lib.mjhmc_engine_launch(
        d, spec.energy_id, params.data_ptr(), *spec.constants(), *ptrs,
        n, num_iters, thin, m, int(seed) & _MASK32, float(epsilon), float(beta),
        int(fixed_uniform), ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"mjhmc_engine_launch failed: CUDA error {rc}")
    return out, emits


def cuda_mjhmc_run(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                   num_steps, num_leapfrog, *, inv_mass=None, variant="mjhmc",
                   integrator="leapfrog", fixed_uniform=False) -> RunOut:
    """Engine run (counterpart of ``pallas_mjhmc_run``): ``num_steps`` jump
    iterations in one launch. CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    _check_slice(spec, variant, integrator, inv_mass)
    if x.device.type == "cpu":
        return mjhmc_run_reference(spec, x, v, g, u, h_back, back_valid, seed,
                                   epsilon, beta, num_steps, num_leapfrog,
                                   fixed_uniform)
    out, _ = _launch(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                     num_steps, num_leapfrog, 1, None, fixed_uniform)
    cuda_mjhmc_run.launches += 1
    return out


cuda_mjhmc_run.launches = 0


def cuda_mjhmc_stream_run(spec, x, v, g, u, h_back, back_valid, seed, epsilon,
                          beta, num_emits, thin, num_leapfrog, *, inv_mass=None,
                          variant="mjhmc", integrator="leapfrog",
                          fixed_uniform=False):
    """Streaming engine run (counterpart of ``pallas_mjhmc_stream_run``):
    returns (xs (E, d, n), ws (E, n), es (E, n) int32, RunOut)."""
    _check_slice(spec, variant, integrator, inv_mass)
    if x.device.type == "cpu":
        return mjhmc_stream_reference(spec, x, v, g, u, h_back, back_valid, seed,
                                      epsilon, beta, num_emits, thin,
                                      num_leapfrog, fixed_uniform)
    out, (xs, ws, es) = _launch(spec, x, v, g, u, h_back, back_valid, seed,
                                epsilon, beta, num_emits * thin, num_leapfrog,
                                thin, num_emits, fixed_uniform)
    cuda_mjhmc_stream_run.launches += 1
    return xs, ws, es, out


cuda_mjhmc_stream_run.launches = 0


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CudaMJHMC:
    """High-throughput MJHMC engine (counterpart of ``PallasMJHMC``).

    Takes any ``nbatch``. ``device="cpu"`` runs the kernel's plain version;
    ``fixed_uniform`` pins every uniform at 2⁻²⁵ (test mode).
    """

    distribution: object
    epsilon: float = 1.0
    beta: float = 0.1
    num_leapfrog_steps: int = 10
    nbatch: int = 10_240
    seed: int = 0
    device: str = "cuda"
    inv_mass: tuple | None = None
    variant: str = "mjhmc"
    integrator: str = "leapfrog"
    fixed_uniform: bool = False

    def __post_init__(self):
        self.spec = energy_spec_for(self.distribution)
        _check_slice(self.spec, self.variant, self.integrator, self.inv_mass)
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CudaMJHMC(device='cuda') needs a CUDA device")
        gen = torch.Generator().manual_seed(self.seed)
        x = self.distribution.init_x(gen, self.nbatch, self.device)
        v = randn(gen, x.shape, self.device)
        u, g = self.distribution.potential_and_grad(x)
        zeros = torch.zeros(self.nbatch, dtype=torch.float32, device=self.device)
        self.x, self.v, self.g, self.u = x, v, g, u
        self.h_back, self.back_valid = zeros, zeros.clone()
        # per-run kernel seeds from a generator of the engine seed
        self._seed_gen = torch.Generator().manual_seed(self.seed)
        # exact per-chain cumulative evals over all runs
        self.evals = torch.zeros(self.nbatch, dtype=torch.int64, device=self.device)
        self.steps_total = 0
        self.last_out: RunOut | None = None

    def _next_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self._seed_gen))

    def load_state(self, state: MJState) -> None:
        """Adopt a chain state (e.g. one carried across from JAX with
        ``convert.state_from_jax``)."""
        ch = state.chain
        f32 = dict(dtype=torch.float32, device=self.device)
        self.x, self.v = ch.x.to(**f32).contiguous(), ch.v.to(**f32).contiguous()
        self.g, self.u = ch.grad.to(**f32).contiguous(), ch.u.to(**f32).contiguous()
        self.h_back = state.h_back.to(**f32).contiguous()
        self.back_valid = state.back_valid.to(**f32).contiguous()
        self.nbatch = self.x.shape[1]
        self.evals = torch.zeros(self.nbatch, dtype=torch.int64, device=self.device)

    def _state(self):
        return (self.x, self.v, self.g, self.u, self.h_back, self.back_valid)

    def _adopt(self, out: RunOut, num_iters: int) -> None:
        (self.x, self.v, self.g, self.u, self.h_back, self.back_valid) = out[:6]
        self.evals += out.evals
        self.steps_total += num_iters
        self.last_out = out

    def run(self, num_steps: int) -> RunOut:
        out = cuda_mjhmc_run(
            self.spec, *self._state(), self._next_seed(), self.epsilon,
            self.beta, num_steps, self.num_leapfrog_steps,
            inv_mass=self.inv_mass, variant=self.variant,
            integrator=self.integrator, fixed_uniform=self.fixed_uniform,
        )
        self._adopt(out, num_steps)
        return out

    def sample(self, num_emits: int, thin: int = 1, return_evals: bool = False):
        """Streaming run: (xs (num_emits, d, nbatch), dwell (num_emits, nbatch)),
        plus the exact cumulative int32 eval counters when ``return_evals``.
        The run's accumulators are kept in ``last_out``."""
        xs, ws, es, out = cuda_mjhmc_stream_run(
            self.spec, *self._state(), self._next_seed(), self.epsilon,
            self.beta, num_emits, thin, self.num_leapfrog_steps,
            inv_mass=self.inv_mass, variant=self.variant,
            integrator=self.integrator, fixed_uniform=self.fixed_uniform,
        )
        self._adopt(out, num_emits * thin)
        return (xs, ws, es) if return_evals else (xs, ws)

    @property
    def grad_evals(self) -> int:
        """Cumulative algorithmic gradient evaluations (all runs, all chains)."""
        return int(self.evals.sum())

    @staticmethod
    def moments(out: RunOut):
        """Dwell-weighted (mean, var) per dim from a run's accumulators."""
        w = out.w.sum()
        mean = out.wx.sum(dim=1) / w
        var = out.wx2.sum(dim=1) / w - mean * mean
        return mean, var
