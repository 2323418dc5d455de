"""Fused MJHMC, control HMC, MALT and NUTS engines on CUDA (counterpart of
``mjhmc_tpu.ops.pallas_mjhmc``).

One kernel launch runs a whole sampling run of one step body, chosen by
``variant`` as the TPU kernels choose from ``_STEP_BUILDERS``:

- ``"mjhmc"``: per chain, ``num_steps`` jump iterations, each integrating
  the forward and backward M-step trajectories, computing the clipped
  rates and the dwell weight, choosing L, F or R by inverse CDF, refreshing
  momentum by Box-Muller and updating the backward-energy cache;
- ``"control"``: partial momentum corruption, one forward trajectory,
  Metropolis accept, momentum flip on reject (``beta`` is the corruption
  fraction);
- ``"malt"``: a full refresh, M OBABO steps, one trajectory-level accept
  (``beta`` carries the friction γ);
- ``"nuts"``: up to max_depth doubling rounds with progressive
  multinomial sampling and the binary-counter U-turn stack (the
  ``num_leapfrog`` slot is max_depth).

Every body takes a diagonal inverse mass (``inv_mass``), and MJHMC and
control the BCSS two-stage integrator (``integrator="two_stage"``, two
gradients per step, counted). Each run accumulates Kahan sums of Σw, Σw·x,
Σw·x² and the exact int32 eval counters; the stream form also emits every
``thin``-th iteration's x (MJHMC: pre-transition with its dwell weight; the
others: post-transition with weight 1) and cumulative evals.

There are two hand-written CUDA C++ kernels, built by ``ops._build``:
``csrc/mjhmc_engine.cuh`` for the elementwise energies (rough well,
Gaussian, funnel, banana, Gaussian mixture, eight schools in both
parameterizations; a chain on a group of lanes; C entry
``csrc/mjhmc_engine.cu``; compiled ahead at the presets' D, any other D and
mixture size at its first use from ``csrc/ondemand/ew_instance.cu``) and
``csrc/mjhmc_mm_engine.cuh`` for the matmul energies (product of t, sparse
coding, logistic regression; tiles of chains per block, the parameter
matrix in shared memory, or in a device buffer where it does not fit;
contractions at the spec's dot ``precision``, full f32 in FP32 FMA or bf16
passes on the tensor cores; C entry ``csrc/mjhmc_mm_engine.cu``; compiled
ahead at the presets' shapes and precisions, any other (d, k) and precision
at its first use from ``csrc/ondemand/mm_instance.cu``). Beside them this
module holds
their plain PyTorch versions (``run_reference`` / ``stream_reference``, one
for both kinds) with the same contract. The wrappers ``cuda_mjhmc_run`` /
``cuda_mjhmc_stream_run`` (elementwise) and ``cuda_mjhmc_mm_run`` /
``cuda_mjhmc_mm_stream_run`` (matmul) launch their kernel for CUDA tensors
and call the plain version for CPU tensors; the engines ``CudaMJHMC``,
``CudaControlHMC``, ``CudaMALT`` and ``CudaNUTS`` hold the chains.

Random numbers come from Philox4x32-10 keyed by the run seed with counter
(chain, iteration, slot, tag), each draw keyed by its position, never by
how many draws a chain has made (``csrc/philox.cuh`` lays the tags out:
MJHMC 0, NUTS 1-3, control 4, MALT 5-6). The plain versions compute the
same words bit for bit. ``fixed_uniform=True`` makes every uniform 2⁻²⁵ in
both, which is what the TPU kernels give in Pallas interpret mode, so the
CPU tests can hold this engine against them.

Public layout is the JAX one without the TPU's (d, 8, L) fold: states
(d, nbatch), per-chain scalars (nbatch,), any nbatch.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import math
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from mjhmc_tpu_torch.models.banana import Banana
from mjhmc_tpu_torch.models.base import randn
from mjhmc_tpu_torch.models.eight_schools import EightSchools
from mjhmc_tpu_torch.models.funnel import Funnel
from mjhmc_tpu_torch.models.gaussian import Gaussian
from mjhmc_tpu_torch.models.logreg import LogisticRegression
from mjhmc_tpu_torch.models.mog import GaussianMixture
from mjhmc_tpu_torch.models.product_of_t import ProductOfT
from mjhmc_tpu_torch.models.rough_well import RoughWell
from mjhmc_tpu_torch.models.sparse_coding import SparseCoding
from mjhmc_tpu_torch.ops.leapfrog import TWO_STAGE_B
from mjhmc_tpu_torch.samplers.adaptation import mjhmc_full_warmup, nuts_full_warmup
from mjhmc_tpu_torch.samplers.state import MJState, checked_device

Tensor = torch.Tensor

LOG_RATE_MAX = 25.0
NEG_INF = -1e30
#: the uniform every draw takes in fixed-uniform mode (Pallas interpret mode
#: returns zero bits, and _uniform turns those into 2⁻²⁵)
FIXED_UNIFORM = 2.0**-25
#: deepest tree each NUTS kernel takes: the elementwise kernel's
#: (csrc/mjhmc_engine.cuh, nuts::kMaxDepth) and the matmul kernel's
#: (csrc/mjhmc_mm_engine.cuh). A tree of max_depth 31 has 2^31 − 1 leaves,
#: and its leaf counts and tree positions fit an int32, as the JAX kernel's
#: are; past it those would wrap, so the kernels refuse
NUTS_MAX_DEPTH = 31
NUTS_MM_MAX_DEPTH = 31
#: the depth at which the matmul NUTS tile rule fits the layout on chip
#: (nuts::kTileDepth); a deeper tree runs on the same tile, on the DEEP
#: instance (compiled beside the others of the body), with its stack rows and
#: span slots past this depth in the device buffer (``nuts_scratch``)
NUTS_MM_TILE_DEPTH = 12
NUTS_DIV_THRESHOLD = 1000.0
#: tree positions whose leaf draws the plain NUTS makes in one Philox pass
#: (a multiple of 4: whole leaf slots), and the leaves between its tests
#: whether any chain of a round is still live
NUTS_LEAF_WORDS, NUTS_LIVE_CHECK = 256, 16
#: Philox counter tags (csrc/philox.cuh)
TAG_NUTS_MOMENTUM, TAG_NUTS_ROUND, TAG_NUTS_LEAF = 1, 2, 3
TAG_CONTROL, TAG_MALT_REFRESH, TAG_MALT_NOISE, TAG_MALT_PAIRS = 4, 5, 6, 7
TAG_CONTROL_PAIRS = 8
#: the step bodies and their numbers in both kernels (csrc/mjhmc_engine.cuh,
#: csrc/mjhmc_mm_engine.cuh)
KERNEL_VARIANTS = {"mjhmc": 0, "nuts": 1, "control": 2, "malt": 3}
INTEGRATORS = ("leapfrog", "two_stage")
_MALT_LEAPFROG_ONLY = (
    "the MALT body's OBABO splitting is leapfrog-structured, as the JAX "
    "engine's is (mjhmc_tpu/ops/pallas_mjhmc.py:959): use the plain "
    "samplers.malt for other integrators"
)
_NUTS_LEAPFROG_ONLY = (
    "the NUTS tree's reversibility bookkeeping assumes the leapfrog "
    "integrator, as the JAX engine's does (mjhmc_tpu/ops/pallas_mjhmc.py:1042)"
)


# --------------------------------------------------------------------------
# energy specs: an energy id for the kernel, scalar constants, per-dim params
# --------------------------------------------------------------------------
#: rows past which ``_sum_dims_in_order`` sums on the host after one copy
#: rather than one torch op a row (a launch a row on the card: ~50 ms a call
#: at 4,096 dims)
SUM_IN_ORDER_ROWS = 32


def _sum_dims_in_order(t: Tensor) -> Tensor:
    """Σ over dim −2 row after row, the elementwise kernels' order. Torch's
    reduction rounds in another order from three rows on, and a last-ulp
    difference in an energy or a U-turn dot product changes a NUTS tree.
    Past ``SUM_IN_ORDER_ROWS`` rows the tensor is copied to the host once
    and its rows added there one after another in float32 (not by
    ``np.add.reduce``, which sums pairwise where the rows are the innermost
    axis, as they are with one column)."""
    if t.shape[-2] > SUM_IN_ORDER_ROWS:
        a = t.detach().cpu().numpy()
        out = a[..., 0, :].copy()
        for i in range(1, a.shape[-2]):
            out += a[..., i, :]
        return torch.from_numpy(out).to(t.device)
    s = t[..., 0, :]
    for i in range(1, t.shape[-2]):
        s = s + t[..., i, :]
    return s


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
        return _sum_dims_in_order(
            x * x * (0.5 / self.scale1**2)
            + self.amplitude * torch.cos(x * (1.0 / self.scale2))
        )


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
        return 0.5 * _sum_dims_in_order(x * x * params)


# The zoo energies couple their dims, so the kernel computes the whole
# gradient at once. The per-row special cases are masks over the row index,
# as in the JAX specs, and every sum over dims runs in the kernel's order.
def _row(x: Tensor) -> Tensor:
    """(d, 1) row indices, broadcasting against (..., d, n)."""
    return torch.arange(x.shape[-2], device=x.device)[:, None]


@dataclasses.dataclass(frozen=True)
class FunnelSpec:
    """Neal's funnel: row 0 is the log-scale v, rows 1.. are N(0, eᵛ)."""

    ndims: int
    sigma_v: float
    energy_id: ClassVar[int] = 2

    def constants(self) -> tuple:
        """(1/σ_v², ½(d−1)): the kernel's k0, k1."""
        return (1.0 / self.sigma_v**2, 0.5 * (self.ndims - 1), 0.0, 0.0, 0.0)

    def param_vector(self, ndims: int) -> np.ndarray:
        return np.ones((ndims,), np.float32)

    def _z2(self, x):
        # a masked sum, not Σx² − v²: that cancellation is amplified by e⁻ᵛ
        tail = torch.where(_row(x) == 0, 0.0, x)
        return _sum_dims_in_order(tail * tail)

    def du(self, x, params):
        v = x[..., 0, :]
        e = torch.exp(-v)
        gv = v * (1.0 / self.sigma_v**2) + 0.5 * (self.ndims - 1) - 0.5 * e * self._z2(x)
        return torch.where(_row(x) == 0, gv[..., None, :], e[..., None, :] * x)

    def u_sum(self, x, params):
        v = x[..., 0, :]
        return (0.5 * v * v * (1.0 / self.sigma_v**2) + 0.5 * (self.ndims - 1) * v
                + 0.5 * torch.exp(-v) * self._z2(x))


@dataclasses.dataclass(frozen=True)
class BananaSpec:
    """Haario banana: rows 0 and 1 are the twisted pair, rows ≥ 2 N(0, 1)."""

    ndims: int
    a: float
    b: float
    energy_id: ClassVar[int] = 3

    def constants(self) -> tuple:
        """(a², b, 1/a², 2b): the kernel's k0..k3."""
        return (self.a**2, self.b, 1.0 / self.a**2, 2.0 * self.b, 0.0)

    def param_vector(self, ndims: int) -> np.ndarray:
        return np.ones((ndims,), np.float32)

    def _r(self, x):
        x1 = x[..., 0, :]
        return x1, x[..., 1, :] - self.b * (x1 * x1 - self.a**2)

    def du(self, x, params):
        x1, r = self._r(x)
        g0 = x1 * (1.0 / self.a**2) - (2.0 * self.b) * x1 * r
        idx = _row(x)
        return torch.where(idx == 0, g0[..., None, :], torch.where(idx == 1, r[..., None, :], x))

    def u_sum(self, x, params):
        x1, r = self._r(x)
        tail = torch.where(_row(x) < 2, 0.0, x)  # masked, not subtractive
        return (0.5 * x1 * x1 * (1.0 / self.a**2) + 0.5 * r * r
                + 0.5 * _sum_dims_in_order(tail * tail))


#: most mixture components of the elementwise library's mixture instances
#: (csrc/mjhmc_engine.cuh, kMogMaxComponents); a mixture of more runs on an
#: on-demand instance compiled for its own count (``mog_cap``)
MOG_MAX_COMPONENTS = 8


@dataclasses.dataclass(frozen=True)
class MogSpec:
    """Isotropic K-component Gaussian mixture, U = −logsumexp of the
    component logits (max-shifted), with the JAX spec's expanded square
    ‖x‖² − 2μ·x + ‖μ‖² and its skips of zero means. JAX bakes μ, σ and w
    into the kernel; here they travel in the params vector."""

    ndims: int
    means: tuple  # ((d floats),) × K
    scales: tuple  # (K,)
    weights: tuple  # (K,) normalised
    energy_id: ClassVar[int] = 4

    def constants(self) -> tuple:
        """(K,): the kernel's k0."""
        return (float(len(self.scales)), 0.0, 0.0, 0.0, 0.0)

    def _component_constants(self) -> list:
        """Per component (log w − d log σ, ½/σ², 1/σ², ‖μ‖²), as the JAX
        spec forms them in float64 before they meet the float32 state."""
        out = []
        for k, s in enumerate(self.scales):
            mu = self.means[k]
            musq = 0.0
            for i in range(self.ndims):
                musq += mu[i] * mu[i]
            out.append((math.log(self.weights[k]) - self.ndims * math.log(float(s)),
                        0.5 / float(s) ** 2, 1.0 / float(s) ** 2, musq))
        return out

    def param_vector(self, ndims: int) -> np.ndarray:
        """μ (K·d, row-major), then the K values of each of the four
        per-component constants."""
        consts = np.asarray(self._component_constants(), np.float64).T  # (4, K)
        return np.concatenate([np.asarray(self.means, np.float64).reshape(-1),
                               consts.reshape(-1)]).astype(np.float32)

    def _logits(self, x):
        x2 = _sum_dims_in_order(x * x)
        logits = []
        for k, (c, h, _, musq) in enumerate(self._component_constants()):
            mu = self.means[k]
            cross = 0.0
            for i in range(self.ndims):
                if mu[i] != 0.0:
                    cross = cross + mu[i] * x[..., i, :]
            logits.append(c - h * (x2 - 2.0 * cross + musq))
        return logits

    def du(self, x, params):
        logits = self._logits(x)
        m = logits[0]
        for lg in logits[1:]:
            m = torch.maximum(m, lg)
        exps = [torch.exp(lg - m) for lg in logits]
        tot = exps[0]
        for e in exps[1:]:
            tot = tot + e
        inv_tot = 1.0 / tot
        # grad = x·Σₖ cₖ − Σₖ cₖ μₖ with cₖ = rₖ/σₖ²
        cs = [(e * inv_tot) * iv for e, (_, _, iv, _) in zip(exps, self._component_constants())]
        a = cs[0]
        for c in cs[1:]:
            a = a + c
        g = x * a[..., None, :]
        idx = _row(x)
        for i in range(self.ndims):
            row = None
            for k, c in enumerate(cs):
                if self.means[k][i] != 0.0:
                    t = c * self.means[k][i]
                    row = t if row is None else row + t
            if row is not None:
                g = g - torch.where(idx == i, row[..., None, :], 0.0)
        return g

    def u_sum(self, x, params):
        logits = self._logits(x)
        m = logits[0]
        for lg in logits[1:]:
            m = torch.maximum(m, lg)
        tot = torch.exp(logits[0] - m)
        for lg in logits[1:]:
            tot = tot + torch.exp(lg - m)
        return -(m + torch.log(tot))


@dataclasses.dataclass(frozen=True)
class EightSchoolsSpec:
    """Eight schools: row 0 μ, row 1 ℓ = log τ, rows 2.. the group rows.
    The per-school data (yⱼ, 1/σⱼ²) ship as two rows of the params vector
    (2d entries, zero on rows 0 and 1). The two parameterizations are two
    energies of the kernel."""

    ndims: int
    mu_scale: float
    log_tau_scale: float
    y: tuple
    inv_sig2: tuple
    centered: bool = True

    @property
    def energy_id(self) -> int:
        return 5 if self.centered else 6

    def constants(self) -> tuple:
        """(1/m₀², 1/s₀², K): the kernel's k0..k2."""
        return (1.0 / self.mu_scale**2, 1.0 / self.log_tau_scale**2,
                float(self.ndims - 2), 0.0, 0.0)

    def param_vector(self, ndims: int) -> np.ndarray:
        y_row = np.zeros((ndims,), np.float32)
        i_row = np.zeros((ndims,), np.float32)
        y_row[2:] = np.asarray(self.y, np.float32)
        i_row[2:] = np.asarray(self.inv_sig2, np.float32)
        return np.concatenate([y_row, i_row])

    def _split(self, x, params):
        d = self.ndims
        idx = _row(x)
        return x[..., 0, :], x[..., 1, :], idx, idx >= 2, params[:d], params[d:]

    def _prior(self, mu, l):
        return (0.5 * mu * mu * (1.0 / self.mu_scale**2)
                + 0.5 * l * l * (1.0 / self.log_tau_scale**2))

    def du(self, x, params):
        mu, l, idx, th, yv, is2 = self._split(x, params)
        k = self.ndims - 2
        if self.centered:
            e2 = torch.exp(-2.0 * l)
            dth = torch.where(th, x - mu[..., None, :], 0.0)
            gmu = mu * (1.0 / self.mu_scale**2) - e2 * _sum_dims_in_order(dth)
            gl = (l * (1.0 / self.log_tau_scale**2) + k
                  - e2 * _sum_dims_in_order(dth * dth))
            gth = e2[..., None, :] * dth + torch.where(th, (x - yv) * is2, 0.0)
        else:
            e = torch.exp(l)
            ri = torch.where(th, (mu[..., None, :] + e[..., None, :] * x - yv) * is2, 0.0)
            gmu = mu * (1.0 / self.mu_scale**2) + _sum_dims_in_order(ri)
            gl = l * (1.0 / self.log_tau_scale**2) + e * _sum_dims_in_order(x * ri)
            gth = torch.where(th, x, 0.0) + e[..., None, :] * ri
        return torch.where(idx == 0, gmu[..., None, :],
                           torch.where(idx == 1, gl[..., None, :], gth))

    def u_sum(self, x, params):
        mu, l, idx, th, yv, is2 = self._split(x, params)
        if self.centered:
            dth = torch.where(th, x - mu[..., None, :], 0.0)
            r = torch.where(th, x - yv, 0.0)
            return (self._prior(mu, l) + (self.ndims - 2) * l
                    + 0.5 * torch.exp(-2.0 * l) * _sum_dims_in_order(dth * dth)
                    + 0.5 * _sum_dims_in_order(r * r * is2))
        e = torch.exp(l)
        r = torch.where(th, mu[..., None, :] + e[..., None, :] * x - yv, 0.0)
        z = torch.where(th, x, 0.0)
        return (self._prior(mu, l) + 0.5 * _sum_dims_in_order(z * z)
                + 0.5 * _sum_dims_in_order(r * r * is2))


# matmul energies: the state is (..., d, n) and the parameters are whole
# matrices. On the GPU the forward and backward trajectories are simply
# more columns of the same product, so the TPU's block-diagonal pair
# operands and sublane pads have no counterpart here. The dot precision
# does: each spec carries JAX's ``precision`` with JAX's default, and the
# kernel computes the same bf16 passes on the tensor cores.
#: the dot precisions (MatmulEnergySpec._dot, mjhmc_tpu/ops/pallas_mjhmc.py:
#: 282-375), numbered as the kernel's: "highest" full f32, "bf16x3" three
#: bf16 passes hi·hi + (hi·lo + lo·hi), "bf16x2" two passes hi·(hi + lo)
#: with only the parameter matrix rounded, "default" one bf16 pass
PRECISIONS = ("highest", "bf16x3", "bf16x2", "default")


def _split_bf16(t: Tensor) -> tuple:
    """(hi, lo) in float32: hi = bf16(t), lo = bf16(t − hi), both rounded to
    nearest even, as ``_dot_bf16x3`` splits."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _contract(stub: bool, m: Tensor, b: Tensor, precision: str = "highest") -> Tensor:
    """m @ b at ``precision`` (``PRECISIONS``), the parameter matrix ``m``
    first as in JAX; with ``stub`` (the ``stub_dots`` ablation of
    ``MatmulEnergySpec._dot``) 1e-3·(row 0 of b) on each of m's rows, for
    each trajectory on its own (JAX's ``has_pair=False`` form). The bf16
    passes multiply bf16-valued float32 tensors (the products are exact;
    the callers turn TF32 off), never bf16 tensors, whose matmul would round
    its output to bf16."""
    if stub:
        row = b[..., :1, :] * torch.tensor(1e-3, dtype=b.dtype, device=b.device)
        return row.expand(*b.shape[:-2], m.shape[-2], b.shape[-1])
    if precision == "highest":
        return torch.matmul(m, b)
    if precision not in PRECISIONS:
        raise ValueError(f"unknown dot precision {precision!r}; the kernel has {PRECISIONS}")
    m_hi, m_lo = _split_bf16(m)
    b_hi, b_lo = _split_bf16(b)
    if precision == "default":
        return torch.matmul(m_hi, b_hi)
    if precision == "bf16x2":
        return torch.matmul(m_hi, b_hi) + torch.matmul(m_hi, b_lo)
    return torch.matmul(m_hi, b_hi) + (torch.matmul(m_hi, b_lo) + torch.matmul(m_lo, b_hi))


@dataclasses.dataclass(frozen=True)
class ProductOfTSpec:
    """y = Wᵀx, g = W·(ν+1)y/(ν+y²), U = ½(ν+1)·Σ log1p(y²/ν)."""

    dist: ProductOfT
    #: the dot precision (``PRECISIONS``): JAX's default, one bf16 pass
    precision: str = "default"
    #: ablation: stub both contractions (the dossier's non-matmul floor)
    stub_dots: bool = False
    energy_id: ClassVar[int] = 0

    def param_arrays(self) -> list:
        return [np.asarray(self.dist._basis, np.float32)]  # W: (d, k)

    def aux_rows(self) -> int:
        return self.dist.nbasis

    def constants(self) -> tuple:
        """(ν+1, ν, ½(ν+1), 1/ν): the kernel's k0..k3."""
        nu = self.dist.nu
        return (nu + 1.0, nu, 0.5 * (nu + 1.0), 1.0 / nu)

    def du(self, x, w):
        nu = self.dist.nu
        y = _contract(self.stub_dots, w.T, x, self.precision)
        return _contract(self.stub_dots, w, (nu + 1.0) * y / (nu + y * y), self.precision)

    def u_sum(self, x, w):
        nu = self.dist.nu
        y = _contract(self.stub_dots, w.T, x, self.precision)
        return 0.5 * (nu + 1.0) * torch.log1p(y * y * (1.0 / nu)).sum(dim=-2)


@dataclasses.dataclass(frozen=True)
class SparseCodingSpec:
    """r = patch − Φa, g = λa/√(a²+ε) − σ⁻²Φᵀr, U = λΣ√(a²+ε) + ½σ⁻²‖r‖²."""

    dist: SparseCoding
    #: the dot precision: JAX's default, three bf16 passes (the fit term
    #: multiplies the residual's error by σ⁻² = 100)
    precision: str = "bf16x3"
    #: ablation: stub both contractions
    stub_dots: bool = False
    energy_id: ClassVar[int] = 1

    def param_arrays(self) -> list:
        d = self.dist
        return [np.asarray(d._phi, np.float32), d.patch_array()]  # Φ (p, b), (p,)

    def aux_rows(self) -> int:
        return self.dist.npixels

    def constants(self) -> tuple:
        """(λ, σ⁻², ½σ⁻², ε): the kernel's k0..k3."""
        d = self.dist
        return (d.lam, 1.0 / d.sigma**2, 0.5 / d.sigma**2, d.smooth_eps)

    def _resid(self, a, phi, patch):
        return patch[:, None] - _contract(self.stub_dots, phi, a, self.precision)

    def du(self, a, phi, patch):
        d = self.dist
        s = torch.sqrt(a * a + d.smooth_eps)
        r = self._resid(a, phi, patch)
        return d.lam * (a / s) - (1.0 / d.sigma**2) * _contract(self.stub_dots, phi.T, r,
                                                                 self.precision)

    def u_sum(self, a, phi, patch):
        d = self.dist
        s = torch.sqrt(a * a + d.smooth_eps)
        r = self._resid(a, phi, patch)
        return d.lam * s.sum(dim=-2) + (0.5 / d.sigma**2) * (r * r).sum(dim=-2)


@dataclasses.dataclass(frozen=True)
class LogregSpec:
    """Bayesian logistic regression with the label signs folded into the
    design matrix (Xs = −s·X): z = Xs·θ, g = Xsᵀσ(z) + θ/σ₀², U = Σ
    softplus(z) + ½σ₀⁻²‖θ‖², softplus(z) = max(z, 0) + log1p(e^{−|z|})."""

    dist: LogisticRegression
    #: the dot precision: JAX's default, one bf16 pass (the logits are O(1))
    precision: str = "default"
    energy_id: ClassVar[int] = 2

    def param_arrays(self) -> list:
        xmat, s = self.dist._data
        return [np.asarray(-s[:, None] * xmat, np.float32)]  # Xs: (o, d)

    def aux_rows(self) -> int:
        return self.dist.nobs

    def constants(self) -> tuple:
        """(1/σ₀², ½/σ₀², 0, 0): the kernel's k0..k3."""
        p = self.dist.prior_scale
        return (1.0 / p**2, 0.5 / p**2, 0.0, 0.0)

    def du(self, th, xs):
        z = _contract(False, xs, th, self.precision)
        sig = 1.0 / (1.0 + torch.exp(-z))
        return _contract(False, xs.T, sig, self.precision) + th * (1.0 / self.dist.prior_scale**2)

    def u_sum(self, th, xs):
        z = _contract(False, xs, th, self.precision)
        sp = z.clamp(min=0.0) + torch.log1p(torch.exp(-z.abs()))
        return sp.sum(dim=-2) + (0.5 / self.dist.prior_scale**2) * (th * th).sum(dim=-2)


ELEMENTWISE_SPECS = (RoughWellSpec, GaussianSpec, FunnelSpec, BananaSpec, MogSpec,
                     EightSchoolsSpec)
MATMUL_SPECS = (ProductOfTSpec, SparseCodingSpec, LogregSpec)
#: state dimensions the elementwise library is compiled ahead for, per spec
#: (csrc/mjhmc_engine.cu and the *_d50*.cu and zoo_*.cu sources): the
#: presets' D. Every other D runs on an instance compiled at first use
#: (``_build.load_instance``, ``ew_library``)
KERNEL_DIMS = {RoughWellSpec: (2, 50), GaussianSpec: (2, 50), FunnelSpec: (10,),
               BananaSpec: (2,), MogSpec: (1,), EightSchoolsSpec: (10,)}
#: (ndims, aux rows) the matmul library is compiled ahead for, per spec
#: (csrc/mjhmc_mm_engine.cuh lists the sources): the product_of_t,
#: sparse_coding and logreg presets. Every other shape runs on an instance
#: compiled at first use (``_build.load_instance``, ``mm_library``)
MM_KERNEL_SHAPES = {ProductOfTSpec: (36, 36), SparseCodingSpec: (128, 64),
                    LogregSpec: (16, 256)}
#: what the matmul library is compiled ahead for at each dot precision at
#: its shape, per spec: every body and branch (run and stream, with a mass,
#: two-stage) at "highest" and at the JAX preset's default; the precision
#: sweep's MJHMC leapfrog run without a mass at the other two of product of t
#: and sparse coding (bench_mm_precision.py). Every other (body, precision)
#: runs on an instance compiled at first use
ALL_BODIES, SWEEP_RUN = "every body and branch", "the MJHMC leapfrog run without a mass"
MM_KERNEL_PRECISIONS = {
    ProductOfTSpec: {"highest": ALL_BODIES, "default": ALL_BODIES,
                     "bf16x3": SWEEP_RUN, "bf16x2": SWEEP_RUN},
    SparseCodingSpec: {"highest": ALL_BODIES, "bf16x3": ALL_BODIES,
                       "bf16x2": SWEEP_RUN, "default": SWEEP_RUN},
    LogregSpec: {"highest": ALL_BODIES, "default": ALL_BODIES},
}

_FUSED_ENERGIES = (
    "the engines have the rough_well, gaussian, funnel, banana, mog and "
    "eight_schools energies (elementwise kernel) and the product_of_t, "
    "sparse_coding and logreg energies (matmul kernel); other distributions "
    "run on the plain samplers (mjhmc_tpu_torch.samplers)"
)


def energy_spec_for(dist):
    if isinstance(dist, RoughWell):
        return RoughWellSpec(dist.scale1, dist.scale2, dist.amplitude)
    if isinstance(dist, Gaussian):
        return GaussianSpec(tuple(float(v) for v in 1.0 / dist.variances))
    if isinstance(dist, Funnel):
        return FunnelSpec(dist.ndims, dist.sigma_v)
    if isinstance(dist, Banana):
        return BananaSpec(dist.ndims, dist.a, dist.b)
    if isinstance(dist, GaussianMixture):
        return MogSpec(dist.ndims, tuple(tuple(float(m) for m in row) for row in dist._mu),
                       tuple(float(s) for s in dist._sigma), tuple(float(w) for w in dist._w))
    if isinstance(dist, EightSchools):
        return EightSchoolsSpec(dist.ndims, dist.mu_scale, dist.log_tau_scale,
                                tuple(float(v) for v in dist.y),
                                tuple(1.0 / float(s) ** 2 for s in dist.sigma),
                                centered=dist.parameterization == "centered")
    if isinstance(dist, ProductOfT):
        return ProductOfTSpec(dist)
    if isinstance(dist, SparseCoding):
        return SparseCodingSpec(dist)
    if isinstance(dist, LogisticRegression):
        return LogregSpec(dist)
    raise NotImplementedError(
        f"no fused CUDA energy for {type(dist).__name__}: {_FUSED_ENERGIES}"
    )


def check_kernel_dims(spec, ndims: int) -> None:
    """Refuse what the JAX engine cannot run either: a state without dims,
    a state of other dims than the spec's, a mixture without components.
    Every D and every mixture size has an instance: the library's at
    ``KERNEL_DIMS`` (mixtures of at most ``MOG_MAX_COMPONENTS``), else one
    compiled on demand."""
    # the dims the spec is built for (the rough well takes any)
    own = len(spec.precisions) if isinstance(spec, GaussianSpec) else getattr(spec, "ndims", None)
    if ndims < 1 or (own is not None and own != ndims):
        raise ValueError(f"{type(spec).__name__} is built for {own} dims; the state has {ndims}")
    if isinstance(spec, MogSpec) and not spec.scales:
        raise ValueError("a mixture needs at least one component")


def mog_cap(spec) -> int:
    """The component cap of the instance that runs ``spec``: the library's
    (``MOG_MAX_COMPONENTS``), or a mixture's own count where that is more."""
    return max(MOG_MAX_COMPONENTS, len(spec.scales)) if isinstance(spec, MogSpec) else \
        MOG_MAX_COMPONENTS


def compiled_ahead(spec, ndims: int) -> bool:
    """Whether the elementwise library has the instance of ``spec`` at
    ``ndims`` (``KERNEL_DIMS``, and mixtures of at most
    ``MOG_MAX_COMPONENTS``); else it is compiled on demand."""
    return ndims in KERNEL_DIMS[type(spec)] and mog_cap(spec) == MOG_MAX_COMPONENTS


class EwEntries(NamedTuple):
    """The C entries that serve one elementwise (body, spec, D): the
    library's, or an on-demand instance's."""

    launch: object
    ew_tile: object
    nuts_tile: object


def ew_library(variant: str, spec, ndims: int) -> EwEntries:
    """The entries of the instance that runs ``variant`` on ``spec`` at
    ``ndims``: the library's where it was compiled ahead
    (``compiled_ahead``), else the on-demand instance's, compiled at its
    first use (``_build.load_instance``; a failed nvcc or load raises)."""
    from mjhmc_tpu_torch.ops import _build

    if compiled_ahead(spec, ndims):
        lib = _build.load()
        return EwEntries(lib.mjhmc_engine_launch, lib.mjhmc_ew_tile, lib.mjhmc_nuts_tile)
    lib = _build.load_instance(_build.ew_instance(KERNEL_VARIANTS[variant], spec.energy_id,
                                                  ndims, mog_cap(spec)))
    return EwEntries(lib.mjhmc_od_launch, lib.mjhmc_od_ew_tile, lib.mjhmc_od_nuts_tile)


def _check_slice(spec, variant, integrator, inv_mass, kinds):
    """Refuse what the kernels do not cover; ``kinds`` are the spec types
    of the calling wrapper's kernel."""
    if variant not in KERNEL_VARIANTS:
        raise ValueError(f"unknown engine variant {variant!r}; the kernels run "
                         f"{sorted(KERNEL_VARIANTS)}")
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}; the kernels run {INTEGRATORS}")
    if integrator == "two_stage" and variant in ("malt", "nuts"):
        raise NotImplementedError(
            _MALT_LEAPFROG_ONLY if variant == "malt" else _NUTS_LEAPFROG_ONLY)
    if not isinstance(spec, ELEMENTWISE_SPECS + MATMUL_SPECS):
        raise NotImplementedError(
            f"no fused CUDA energy for {type(spec).__name__}: {_FUSED_ENERGIES}"
        )
    if not isinstance(spec, kinds):
        raise ValueError(
            f"{type(spec).__name__} belongs to the other kernel: elementwise "
            "specs take cuda_mjhmc_run/_stream_run, matmul specs "
            "cuda_mjhmc_mm_run/_stream_run"
        )
    if getattr(spec, "stub_dots", False) and (variant != "mjhmc" or integrator != "leapfrog"
                                              or inv_mass is not None):
        raise NotImplementedError(
            "the stub_dots ablation runs the MJHMC leapfrog body without a mass "
            "(the roofline dossier's row)")
    if isinstance(spec, MATMUL_SPECS) and spec.precision not in PRECISIONS:
        raise ValueError(f"unknown dot precision {spec.precision!r}; the matmul kernel has "
                         f"{PRECISIONS}")


def mm_shape(spec) -> tuple:
    """(state dims, rows of the intermediate) of a matmul spec: product of t
    (ndims, nbasis), sparse coding (nbasis, npixels), logreg (ndims, nobs)."""
    return spec.dist.ndims, spec.aux_rows()


def check_mm_dims(spec, ndims: int) -> None:
    """Refuse what the JAX engine cannot run either: a state without dims,
    or of other dims than the spec's. Every (d, k) and dot precision has an
    instance: the library's (``mm_compiled_ahead``), else one compiled on
    demand."""
    own = mm_shape(spec)[0]
    if ndims < 1 or ndims != own:
        raise ValueError(f"{type(spec).__name__} is built for {own} dims; the state has {ndims}")


def mm_compiled_ahead(spec, sweep_run: bool) -> bool:
    """Whether the matmul library has the instance of ``spec`` (its shape
    and precision, ``MM_KERNEL_SHAPES`` and ``MM_KERNEL_PRECISIONS``) for a
    call that is the precision sweep's run (``sweep_run``: the MJHMC
    leapfrog run without a mass, or its tile) or any other; else it is
    compiled on demand."""
    if mm_shape(spec) != MM_KERNEL_SHAPES[type(spec)]:
        return False
    have = MM_KERNEL_PRECISIONS[type(spec)].get(spec.precision)
    return have == ALL_BODIES or (have == SWEEP_RUN and sweep_run)


class MmEntries(NamedTuple):
    """The C entries that serve one matmul (body, spec, shape, precision):
    the library's, or an on-demand instance's."""

    launch: object
    tile: object
    nuts_tile: object


def mm_library(variant: str, spec, d: int, k: int, sweep_run: bool = False) -> MmEntries:
    """The entries of the instance that runs ``variant`` on ``spec`` at (d,
    k) and the spec's precision: the library's where it was compiled ahead
    (``mm_compiled_ahead``), else the on-demand instance's, compiled at its
    first use in the mode the tile rule picks (``_build.load_instance``; a
    failed nvcc or load raises)."""
    from mjhmc_tpu_torch.ops import _build

    if (d, k) != mm_shape(spec):
        raise ValueError(f"{type(spec).__name__} is built for {mm_shape(spec)}, not {(d, k)}")
    if mm_compiled_ahead(spec, sweep_run):
        lib = _build.load()
        return MmEntries(lib.mjhmc_mm_engine_launch, lib.mjhmc_mm_tile, lib.mjhmc_mm_nuts_tile)
    rule = nuts_mm_tile_rule(spec) if variant == "nuts" else mm_tile_rule(spec, variant)
    lib = _build.load_instance(_build.mm_instance(
        KERNEL_VARIANTS[variant], spec.energy_id, d, k, PRECISIONS.index(spec.precision),
        rule.off, rule.chunk, rule.xg_off))
    return MmEntries(lib.mjhmc_mm_od_launch, lib.mjhmc_mm_od_tile, lib.mjhmc_mm_od_nuts_tile)


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


def _uniform_of(words: Tensor) -> Tensor:
    """f32 uniforms in (0, 1) from 32-bit words: top 24 bits × 2⁻²⁴ + 2⁻²⁵."""
    return (words >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25


def philox_block(seed: int, nbatch: int, t: int, slot: int, tag: int, device) -> tuple:
    """The four words (int64 tensors of shape (nbatch,)) of counter
    (chain, t, slot, tag) for every chain."""
    chains = torch.arange(nbatch, dtype=torch.int64, device=device)
    return philox4x32((chains, t, slot, tag), (int(seed) & _MASK32, 0))


def philox_words(seed: int, nbatch: int, t: int, slots: range, tag: int, device) -> Tensor:
    """The words of counters (chain, t, slot, tag) for every slot of
    ``slots`` and chain, (4·len(slots), nbatch) int64: word k of the draw
    family at row k − 4·slots.start (output k % 4 of slot k // 4), as
    ``philox_block`` gives them one slot at a time."""
    kw = dict(dtype=torch.int64, device=device)
    words = philox4x32((torch.arange(nbatch, **kw)[None, :], t,
                        torch.arange(slots.start, slots.stop, **kw)[:, None], tag),
                       (int(seed) & _MASK32, 0))
    return torch.stack(words, dim=1).reshape(4 * len(slots), nbatch)


def philox_uniforms(seed: int, iterations: range, nbatch: int, nwords: int,
                    device, tag: int = 0) -> Tensor:
    """(len(iterations), nwords, nbatch) float32 uniforms in (0, 1) of the
    draw family ``tag`` (word k from output k % 4 of slot k // 4), built as
    the TPU kernel's ``_uniform``: top 24 bits × 2⁻²⁴ + 2⁻²⁵. The draws do
    not depend on the state, so many iterations are made in one pass."""
    nblocks = (nwords + 3) // 4
    kw = dict(dtype=torch.int64, device=device)
    counter = (
        torch.arange(nbatch, **kw)[None, None, :],  # chain
        torch.tensor(list(iterations), **kw)[:, None, None],  # iteration
        torch.arange(nblocks, **kw)[None, :, None],  # block
        torch.full((), tag, **kw),
    )
    words = philox4x32(counter, (int(seed) & _MASK32, 0))  # each (T, nblocks, n)
    words = torch.stack(words, dim=2).reshape(len(iterations), 4 * nblocks, nbatch)
    return _uniform_of(words[:, :nwords])


# --------------------------------------------------------------------------
# plain PyTorch versions of the kernels
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


class _Acc:
    """The kernels' accumulators: Kahan sums of the emitted x with its
    weight (Σw, Σw·x, Σw·x²), the exact int32 counters, and every
    ``thin``-th (x, weight, cumulative evals) when emitting."""

    def __init__(self, x, u, thin, emit):
        self.w = self.wc = torch.zeros_like(u)
        self.wx = self.wxc = self.wx2 = self.wx2c = torch.zeros_like(x)
        self.evals = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
        self.thin, self.emit, self.emits = thin, emit, []

    def add(self, t, x, weight, inc):
        self.evals = self.evals + inc
        self.w, self.wc = _kadd(self.w, self.wc, weight)
        self.wx, self.wxc = _kadd(self.wx, self.wxc, weight * x)
        self.wx2, self.wx2c = _kadd(self.wx2, self.wx2c, weight * x * x)
        if self.emit and (t + 1) % self.thin == 0:
            self.emits.append((x, weight, self.evals))

    def out(self, x, v, g, u, h_back, valid):
        """The run's ``RunOut``; emitting, (xs, ws, es, RunOut)."""
        out = RunOut(x, v, g, u, h_back, valid, self.w, self.wx, self.wx2, self.evals)
        if not self.emit:
            return out
        if not self.emits:
            d, n = x.shape
            return x.new_empty((0, d, n)), u.new_empty((0, n)), self.evals.new_empty((0, n)), out
        xs, ws, es = (torch.stack(c) for c in zip(*self.emits))
        return xs, ws, es, out


def _log_rate(h_to, h_cur):
    raw = -0.5 * (h_to - h_cur)
    ok = (h_to.abs() < 1e30) & (h_to == h_to)
    return torch.where(ok, raw.clamp(max=LOG_RATE_MAX), NEG_INF)


def _halfsq(v, im=None):
    """½ Σ (v·v)·M⁻¹ per chain."""
    return 0.5 * (v * v if im is None else v * v * im).sum(dim=-2)


def _accept(log_ratio, h):
    """Metropolis probability min(1, exp(log_ratio)); 0 where ``h`` is
    non-finite, and a NaN ratio stays NaN so that it rejects (the kernels'
    divergence guard)."""
    ok = (h.abs() < 1e30) & (h == h)
    return torch.where(ok, torch.exp(log_ratio.clamp(max=0.0)), 0.0)


def _box_muller(un: Tensor, d: int) -> Tensor:
    """Dim i's normal from uniforms i (radius) and d+i (angle) of ``un``."""
    return torch.sqrt(-2.0 * torch.log(un[:d])) * torch.cos((2.0 * math.pi) * un[d:2 * d])


#: iterations whose Philox draws the plain version makes in one pass
_DRAW_CHUNK = 64


class _Draws:
    """Uniforms of one Philox draw family, ``nwords`` per chain and
    iteration, made ``_DRAW_CHUNK`` iterations at a time (or every one 2⁻²⁵
    in fixed-uniform mode)."""

    def __init__(self, seed, num_iters, n, nwords, device, fixed_uniform, tag=0):
        self.args = (seed, num_iters, n, nwords, device, tag)
        self.fixed = (torch.full((nwords, n), FIXED_UNIFORM, device=device)
                      if fixed_uniform else None)

    def __call__(self, t: int) -> Tensor:
        if self.fixed is not None:
            return self.fixed
        seed, num_iters, n, nwords, device, tag = self.args
        if t % _DRAW_CHUNK == 0:
            its = range(t, min(t + _DRAW_CHUNK, num_iters))
            self.chunk = philox_uniforms(seed, its, n, nwords, device, tag=tag)
        return self.chunk[t % _DRAW_CHUNK]


def _param_tensors(spec, ndims: int, device) -> tuple:
    """The spec's parameters as tensors: a matmul spec's matrices, or an
    elementwise spec's per-dim vector as a (d, 1) column."""
    if isinstance(spec, MATMUL_SPECS):
        arrays = spec.param_arrays()
    else:
        arrays = [spec.param_vector(ndims)[:, None]]
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _mass_tensor(inv_mass, d: int, device) -> Tensor | None:
    """The (2, d) float32 (M⁻¹, √M) the kernels take, or None: √M is
    ``torch.rsqrt`` of M⁻¹, computed once here, so the kernel and the plain
    version scale by the same values (the JAX body's ``jax.lax.rsqrt``
    rounds on its own: held at the tests' rtol)."""
    if inv_mass is None:
        return None
    if isinstance(inv_mass, Tensor):
        im = inv_mass.to(device=device, dtype=torch.float32).reshape(-1)
    else:
        im = torch.tensor(np.asarray(inv_mass, np.float32).reshape(-1), device=device)
    if im.numel() != d:
        raise ValueError(f"inv_mass must have {d} entries, got {im.numel()}")
    return torch.stack([im, torch.rsqrt(im)]).contiguous()


def _mass_columns(inv_mass, d, device):
    """(M⁻¹, √M) as (d, 1) columns, or (None, None)."""
    mass = _mass_tensor(inv_mass, d, device)
    return (None, None) if mass is None else (mass[0][:, None], mass[1][:, None])


def _two_stage_coefficients(epsilon) -> tuple:
    """(bε, (1−2b)ε, ε/2) rounded to float32 as the JAX body (weak-typed
    constants times the f32 step size) and the kernels form them."""
    e = np.float32(epsilon)
    return tuple(float(np.float32(c) * e)
                 for c in (TWO_STAGE_B, 1.0 - 2.0 * TWO_STAGE_B, 0.5))


def _integrate(spec, params, x, v, g, epsilon, m, im, two_stage):
    """M leapfrog or BCSS two-stage steps of one trajectory (or a stack of
    them), in the kernels' order of operations; returns (x, v, g)."""

    def drift(x, v, c):
        return x + c * (v if im is None else im * v)

    if not two_stage:
        he = 0.5 * epsilon
        for _ in range(m):
            vh = v - he * g
            x = drift(x, vh, epsilon)
            g = spec.du(x, *params)
            v = vh - he * g
        return x, v, g
    cb, cm, ch = _two_stage_coefficients(epsilon)
    for _ in range(m):
        v1 = v - cb * g
        x = drift(x, v1, ch)
        g1 = spec.du(x, *params)
        v2 = v1 - cm * g1
        x = drift(x, v2, ch)
        g = spec.du(x, *params)
        v = v2 - cb * g
    return x, v, g


@contextlib.contextmanager
def _full_f32_matmul():
    """The plain version sets ``torch.backends.cuda.matmul.allow_tf32 =
    False`` while it runs, so its products on the card are full float32
    (the kernel's FP32 FMA contractions are held against them)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@_full_f32_matmul()
def _reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
               num_iters, m, thin, emit, fixed_uniform, inv_mass, integrator):
    """The MJHMC step body ``_make_step``."""
    d, n = x.shape
    dev = x.device
    params = _param_tensors(spec, d, dev)
    im, sm = _mass_columns(inv_mass, d, dev)
    two_stage = integrator == "two_stage"
    m_cost = (2 if two_stage else 1) * m
    acc = _Acc(x, u, thin, emit)
    draws = _Draws(seed, num_iters, n, 1 + 2 * d, dev, fixed_uniform)
    valid = back_valid
    for t in range(num_iters):
        h_cur = u + _halfsq(v, im)
        xs2, vs2, gs2 = _integrate(spec, params, torch.stack([x, x]), torch.stack([v, -v]),
                                   torch.stack([g, g]), epsilon, m, im, two_stage)
        us2 = spec.u_sum(xs2, *params)
        h2 = us2 + _halfsq(vs2, im)
        h_l = h2[0]
        h_b = torch.where(valid > 0.5, h_back, h2[1])

        gamma_l = torch.exp(_log_rate(h_l, h_cur).clamp(min=NEG_INF))
        gamma_f = (torch.exp(_log_rate(h_b, h_cur)) - gamma_l).clamp(min=0.0)
        total = gamma_l + gamma_f + beta
        dwell = 1.0 / total

        unif = draws(t)
        u_sel = unif[0] * total
        is_l = u_sel < gamma_l
        is_f = ~is_l & (u_sel < gamma_l + gamma_f)
        is_r = ~is_l & ~is_f

        acc.add(t, x, dwell, torch.where(valid > 0.5, m_cost, 2 * m_cost).to(torch.int32))
        v_fresh = _box_muller(unif[1:], d)
        if sm is not None:
            v_fresh = v_fresh * sm  # N(0, M) refresh
        x = torch.where(is_l, xs2[0], x)
        v = torch.where(is_l, vs2[0], torch.where(is_f, -v, v_fresh))
        g = torch.where(is_l, gs2[0], g)
        u = torch.where(is_l, us2[0], u)
        h_back = torch.where(is_l, h_cur, torch.where(is_f, h_l, h_back))
        valid = torch.where(is_r, 0.0, 1.0)
    return acc.out(x, v, g, u, h_back, valid)


def control_pair_draws(seed: int, t: int, n: int, d: int, device) -> tuple:
    """The elementwise control body's draws of iteration ``t``
    (csrc/philox.cuh, tag 8): (ξ (d, n) unscaled by √M, the Metropolis
    uniform (n,)). Word k of the iteration is word k % 4 of slot k // 4;
    Box-Muller pair p takes words 2p (u1) and 2p + 1 (u2), dim i is branch
    i % 2 of pair i // 2 (its cosine, then its sine), and the Metropolis
    uniform is word 2·ceil(d/2). The words depend on the dim's position
    alone, so every grouping of the kernel's lanes draws these."""
    pairs = (d + 1) // 2
    nslots = (2 * pairs) // 4 + 1  # the pairs' slots and the Metropolis word's
    kw = dict(dtype=torch.int64, device=device)
    counter = (torch.arange(n, **kw)[None, :], t, torch.arange(nslots, **kw)[:, None],
               TAG_CONTROL_PAIRS)
    words = torch.stack(philox4x32(counter, (int(seed) & _MASK32, 0)), dim=1)  # (slots, 4, n)
    un = _uniform_of(words.reshape(4 * nslots, n))
    rad = torch.sqrt(-2.0 * torch.log(un[0:2 * pairs:2]))
    ang = (2.0 * math.pi) * un[1:2 * pairs:2]
    z = torch.stack([rad * torch.cos(ang), rad * torch.sin(ang)], dim=1)  # (pairs, 2, n)
    return z.reshape(2 * pairs, n)[:d], un[2 * pairs]


@_full_f32_matmul()
def _reference_control(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                       num_iters, m, thin, emit, fixed_uniform, inv_mass, integrator):
    """The control HMC step body ``_make_step_control``: ``beta`` is the
    corruption fraction; H₀ and the first kick use the carried u and g.
    The draws are each kernel's: the matmul kernel's (tag 4, every normal a
    cosine branch) for a matmul spec, ``control_pair_draws`` (tag 8) for an
    elementwise one; in fixed-uniform mode every normal is the cosine branch
    of u1 = u2 = 2⁻²⁵ in both."""
    d, n = x.shape
    dev = x.device
    params = _param_tensors(spec, d, dev)
    im, sm = _mass_columns(inv_mass, d, dev)
    two_stage = integrator == "two_stage"
    inc = torch.full((n,), (2 if two_stage else 1) * m, dtype=torch.int32, device=dev)
    b = np.float32(beta)
    sb, sb1 = float(np.sqrt(b)), float(np.sqrt(max(np.float32(1.0) - b, np.float32(0.0))))
    acc = _Acc(x, u, thin, emit)
    ones = torch.ones_like(u)
    draws = _Draws(seed, num_iters, n, 2 * d + 1, dev, fixed_uniform, TAG_CONTROL)
    pairs = not isinstance(spec, MATMUL_SPECS) and not fixed_uniform
    for t in range(num_iters):
        if pairs:
            xi, mh = control_pair_draws(seed, t, n, d, dev)
        else:
            unif = draws(t)
            xi, mh = _box_muller(unif, d), unif[2 * d]
        if sm is not None:
            xi = xi * sm  # ξ ~ N(0, M)
        v = sb1 * v + sb * xi
        h0 = u + _halfsq(v, im)
        xf, vf, gf = _integrate(spec, params, x, v, g, epsilon, m, im, two_stage)
        uf = spec.u_sum(xf, *params)
        h_l = uf + _halfsq(vf, im)
        accept = mh < _accept(h0 - h_l, h_l)
        x = torch.where(accept, xf, x)
        v = torch.where(accept, vf, -v)  # flip on reject
        u = torch.where(accept, uf, u)
        g = torch.where(accept, gf, g)
        acc.add(t, x, ones, inc)
    return acc.out(x, v, g, u, h_back, back_valid)


def malt_pair_draws(seed: int, t: int, n: int, d: int, m: int, device) -> tuple:
    """The elementwise MALT body's draws of iteration ``t`` (csrc/philox.cuh,
    tag 7): (v0 (d, n), the 2m O-step normals (2m, d, n) in trajectory order,
    the Metropolis uniform (n,)), unscaled by √M. Dim i's m + 1 Box-Muller
    pairs are slots i·B .. i·B + B − 1 (B = ceil((m + 1)/2)), pair p in words
    2(p % 2) and 2(p % 2) + 1 of slot i·B + p // 2; pair k < m gives step k's
    two O-steps (its cosine, then its sine branch), pair m the refresh (its
    cosine branch); the Metropolis uniform is word 0 of slot d·B."""
    nb = (m + 2) // 2
    kw = dict(dtype=torch.int64, device=device)
    counter = (torch.arange(n, **kw)[None, :], t, torch.arange(d * nb + 1, **kw)[:, None],
               TAG_MALT_PAIRS)
    words = torch.stack(philox4x32(counter, (int(seed) & _MASK32, 0)), dim=1)  # (slots, 4, n)
    un = _uniform_of(words[: d * nb]).reshape(d, 2 * nb, 2, n)
    rad = torch.sqrt(-2.0 * torch.log(un[:, :, 0]))
    ang = (2.0 * math.pi) * un[:, :, 1]
    zc, zs = rad * torch.cos(ang), rad * torch.sin(ang)  # (d, pairs, n)
    o_steps = torch.stack([zc[:, :m], zs[:, :m]], dim=2).permute(1, 2, 0, 3)
    return zc[:, m], o_steps.reshape(2 * m, d, n), _uniform_of(words[d * nb, 0])


@_full_f32_matmul()
def _reference_malt(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                    num_iters, m, thin, emit, fixed_uniform, inv_mass, integrator):
    """The MALT step body ``_make_step_malt``: ``beta`` is the friction γ.
    The draws are each kernel's: the matmul kernel's (tags 5 and 6, every
    normal a cosine branch) for a matmul spec, ``malt_pair_draws`` (tag 7)
    for an elementwise one; in fixed-uniform mode every normal is the cosine
    branch of u1 = u2 = 2⁻²⁵ in both."""
    if integrator != "leapfrog":
        raise NotImplementedError(_MALT_LEAPFROG_ONLY)
    d, n = x.shape
    dev = x.device
    params = _param_tensors(spec, d, dev)
    im, sm = _mass_columns(inv_mass, d, dev)
    eps = torch.tensor(epsilon, dtype=torch.float32, device=dev)
    eta = torch.exp(-torch.tensor(beta, dtype=torch.float32, device=dev) * eps * 0.5)
    sig = torch.sqrt((1.0 - eta * eta).clamp(min=0.0))
    he = 0.5 * epsilon
    inc = torch.full((n,), m, dtype=torch.int32, device=dev)
    acc = _Acc(x, u, thin, emit)
    ones = torch.ones_like(u)
    refresh = _Draws(seed, num_iters, n, 2 * d + 1, dev, fixed_uniform, TAG_MALT_REFRESH)
    nblocks = (2 * d + 3) // 4  # slots of one O-step's 2d words
    pairs = not isinstance(spec, MATMUL_SPECS)

    def scaled(z):
        return z if sm is None else z * sm

    for t in range(num_iters):
        if pairs and not fixed_uniform:
            v0, o_steps, mh = malt_pair_draws(seed, t, n, d, m, dev)
        else:
            unif = refresh(t)
            v0, mh = _box_muller(unif, d), unif[2 * d]
            if fixed_uniform:
                o_steps = v0[None].expand(2 * m, d, n)
            else:
                o_unif = philox_uniforms(seed, range(t, t + 1), n, 2 * m * 4 * nblocks, dev,
                                         tag=TAG_MALT_NOISE)[0].reshape(2 * m, 4 * nblocks, n)
                o_steps = [_box_muller(o, d) for o in o_unif]
        v0 = scaled(v0)
        xl, vl, gl, ul = x, v0, g, u
        delta = torch.zeros_like(u)
        for k in range(m):
            vl = eta * vl + sig * scaled(o_steps[2 * k])  # O
            h_in = ul + _halfsq(vl, im)
            vh = vl - he * gl  # B
            xl = xl + epsilon * (vh if im is None else im * vh)  # A
            gl = spec.du(xl, *params)
            vl = vh - he * gl  # B
            ul = spec.u_sum(xl, *params)
            delta = delta + (ul + _halfsq(vl, im) - h_in)
            vl = eta * vl + sig * scaled(o_steps[2 * k + 1])  # O
        accept = mh < _accept(-delta, delta)
        x = torch.where(accept, xl, x)
        v = torch.where(accept, vl, -v0)
        u = torch.where(accept, ul, u)
        g = torch.where(accept, gl, g)
        acc.add(t, x, ones, inc)
    return acc.out(x, v, g, u, h_back, back_valid)


def _logaddexp(a: Tensor, b: Tensor) -> Tensor:
    """jnp.logaddexp: max + log1p(exp(−|Δ|)), or a + b where Δ is NaN."""
    d = a - b
    return torch.where(torch.isnan(d), a + b,
                       torch.maximum(a, b) + torch.log1p(torch.exp(-d.abs())))


@_full_f32_matmul()
def _reference_nuts(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                    num_iters, max_depth, thin, emit, fixed_uniform, inv_mass, integrator):
    """The NUTS step body of ``_make_step_nuts`` (``beta`` unused),
    vectorised over chains with masks as the JAX body is: a round or a leaf
    runs while any chain is live in it, and a chain that is done or stopped
    keeps its state. Sums over dims run in the kernels' order, so its
    roundings are the elementwise kernel's at any D (the matmul kernel's
    contractions sum in another order)."""
    if integrator != "leapfrog":
        raise NotImplementedError(_NUTS_LEAPFROG_ONLY)
    d, n = x.shape
    dev = x.device
    params = _param_tensors(spec, d, dev)
    im, sm = _mass_columns(inv_mass, d, dev)
    he = 0.5 * epsilon

    def halfsq(v):
        return 0.5 * _sum_dims_in_order(v * v if im is None else v * v * im)

    def cdot(a, b):
        return _sum_dims_in_order(a * b if im is None else a * b * im)

    def unif(word):
        return torch.full((n,), FIXED_UNIFORM, device=dev) if fixed_uniform else _uniform_of(word)

    def draw(t, slot, tag):
        if fixed_uniform:
            return (None,) * 4
        return philox_block(seed, n, t, slot, tag, dev)

    def leaf_words(t, k):
        """The words of tree positions k .. k + NUTS_LEAF_WORDS − 1 (k a
        multiple of 4), NUTS_LEAF_WORDS / 4 leaf slots drawn in one pass."""
        if fixed_uniform:
            return None
        return philox_words(seed, n, t, range(k // 4, (k + NUTS_LEAF_WORDS) // 4),
                            TAG_NUTS_LEAF, dev)

    acc = _Acc(x, u, thin, emit)
    ones = torch.ones_like(u)
    v0 = v
    for t in range(num_iters):
        if fixed_uniform:
            un = torch.full((2 * d, n), FIXED_UNIFORM, device=dev)
        else:  # words 0..2d-1 of tag 1, every block in one pass
            un = philox_uniforms(seed, range(t, t + 1), n, 2 * d, dev, tag=TAG_NUTS_MOMENTUM)[0]
        v0 = _box_muller(un, d)
        if sm is not None:
            v0 = v0 * sm  # v ~ N(0, M)
        h0 = u + halfsq(v0)

        xm = xp = x
        vm = vp = v0
        gm = gp = g
        log_w_tree = torch.zeros_like(u)
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        nl = torch.zeros(n, dtype=torch.int32, device=dev)
        for jj in range(max_depth):
            if not bool((~done).any()):
                break
            rr = draw(t, jj, TAG_NUTS_ROUND)
            right = unif(rr[0]) < 0.5
            # integration frame: outward from the chosen endpoint
            xc = torch.where(right, xp, xm)
            vc = torch.where(right, vp, -vm)
            gc = torch.where(right, gp, gm)
            xs, us, gs = xc, torch.zeros_like(u), gc
            log_w_sub = torch.full_like(u, NEG_INF)
            stop = torch.zeros_like(done)
            sx, sv = [None] * jj, [None] * jj
            for i in range(1 << jj):
                act = ~done & ~stop
                # a leaf where no chain is live changes nothing, so the
                # host waits on the device for this test once in
                # NUTS_LIVE_CHECK leaves only
                if i % NUTS_LIVE_CHECK == 0 and not bool(act.any()):
                    break
                vh = vc - he * gc
                xn = xc + epsilon * (vh if im is None else im * vh)
                gn = spec.du(xn, *params)
                vn = vh - he * gn
                ul = spec.u_sum(xn, *params)
                xc, vc, gc = (torch.where(act, a, b) for a, b in ((xn, xc), (vn, vc), (gn, gc)))
                nl = nl + act.to(torch.int32)
                h = ul + halfsq(vc)
                dh = h - h0
                div = act & ((h.abs() >= 1e30) | (h != h) | (dh > NUTS_DIV_THRESHOLD))

                # progressive multinomial sampling inside the subtree
                lw_leaf = torch.where(act & ~div, -dh, NEG_INF)
                lw_new = _logaddexp(log_w_sub, lw_leaf)
                k = (1 << jj) - 1 + i
                if i == 0 or k % NUTS_LEAF_WORDS == 0:
                    k_words = k - k % 4
                    words = leaf_words(t, k_words)
                lu = torch.log(unif(None if fixed_uniform else words[k - k_words]))
                take = act & ~div & (lu < lw_leaf - lw_new)
                xs, us, gs = (torch.where(take, a, b) for a, b in ((xc, xs), (ul, us), (gc, gs)))
                log_w_sub = torch.where(act, lw_new, log_w_sub)

                # binary-counter U-turn stack (rows above jj never complete
                # a span inside this round)
                turning = torch.zeros_like(done)
                for mm in range(1, jj + 1):
                    mask = (1 << mm) - 1
                    if i & mask == 0:
                        sx[mm - 1], sv[mm - 1] = xc, vc
                    if (i + 1) & mask == 0:
                        dx = xc - sx[mm - 1]
                        turning = turning | (cdot(dx, sv[mm - 1]) < 0) | (cdot(dx, vc) < 0)
                stop = stop | div | (act & turning)

            ok = ~done & ~stop
            merge = ok & (torch.log(unif(rr[1])) < log_w_sub - log_w_tree)
            x, u, g = (torch.where(merge, a, b) for a, b in ((xs, x), (us, u), (gs, g)))
            log_w_tree = torch.where(ok, _logaddexp(log_w_tree, log_w_sub), log_w_tree)
            # extend the tree (back to the trajectory frame), then the
            # U-turn test between its endpoints
            rt, lt = ok & right, ok & ~right
            xp, vp, gp = (torch.where(rt, a, b) for a, b in ((xc, xp), (vc, vp), (gc, gp)))
            xm, vm, gm = (torch.where(lt, a, b) for a, b in ((xc, xm), (-vc, vm), (gc, gm)))
            dx = xp - xm
            done = done | stop | (ok & ((cdot(dx, vm) < 0) | (cdot(dx, vp) < 0)))

        acc.add(t, x, ones, nl)  # the post-transition x, weight 1
    return acc.out(x, v0, g, u, h_back, back_valid)


_REFERENCES = {"mjhmc": _reference, "control": _reference_control,
               "malt": _reference_malt, "nuts": _reference_nuts}


def run_reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                  num_steps, num_leapfrog, fixed_uniform=False, *, variant="mjhmc",
                  inv_mass=None, integrator="leapfrog") -> RunOut:
    """Plain PyTorch version of the run kernels, any variant (the wrappers'
    contract, any device)."""
    return _REFERENCES[variant](spec, x, v, g, u, h_back, back_valid, seed, epsilon,
                                beta, num_steps, num_leapfrog, 1, False, fixed_uniform,
                                inv_mass, integrator)


def stream_reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                     num_emits, thin, num_leapfrog, fixed_uniform=False, *,
                     variant="mjhmc", inv_mass=None, integrator="leapfrog"):
    """Plain PyTorch version of the stream kernels, any variant: returns
    (xs (E, d, n), ws (E, n), es (E, n) int32, RunOut)."""
    return _REFERENCES[variant](spec, x, v, g, u, h_back, back_valid, seed, epsilon,
                                beta, num_emits * thin, num_leapfrog, thin, True,
                                fixed_uniform, inv_mass, integrator)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------
#: the elementwise NUTS kernel's tree rows (csrc/mjhmc_engine.cuh, nuts::Row)
#: live in shared memory up to this many dims, else in a scratch buffer in
#: device memory that the wrapper allocates
NUTS_ON_CHIP_DIMS = 10
#: threads a block of the elementwise NUTS kernel at most (one warp), and
#: the SM sub-partitions (warp schedulers) of an SM
NUTS_THREADS, SM_SUBPARTITIONS = 32, 4


def nuts_tree_rows(max_depth: int) -> int:
    """Rows of d floats per chain of the elementwise NUTS kernel's tree
    state: the sample (x, g), the subtree's proposal (x, g), both tree
    endpoints (x, v, g), the momentum v0, the Kahan pairs of Σx and Σx²,
    and the U-turn stack (x, v for each of max_depth − 1 spans)."""
    return 15 + 2 * (max_depth - 1)


def nuts_threads(d: int, n: int, sms: int) -> int:
    """Threads a block of the elementwise NUTS kernel at ``d`` dims for ``n``
    chains on a card of ``sms`` SMs (mirror of nuts_threads<D>): where the
    tree rows live on chip the fewest, a power of two up to one warp, that
    put at most one block on each SM sub-partition (nuts::threads_for); one
    warp where they live in the device scratch."""
    if d > NUTS_ON_CHIP_DIMS:
        return NUTS_THREADS
    t = 1
    while t < NUTS_THREADS and -(-n // t) > SM_SUBPARTITIONS * sms:
        t *= 2
    return t


def nuts_smem_bytes(d: int, threads: int, max_depth: int) -> int:
    """Shared-memory bytes a block of the elementwise NUTS kernel takes
    (mirror of nuts::smem_bytes): the tree rows of its threads where they
    live on chip, none where they live in the scratch."""
    return nuts_tree_rows(max_depth) * d * threads * 4 if d <= NUTS_ON_CHIP_DIMS else 0


def nuts_tree_scratch(d: int, max_depth: int, n: int, device) -> Tensor | None:
    """The elementwise NUTS kernel's tree rows in device memory, (rows, d,
    n), where they do not live in shared memory (d > NUTS_ON_CHIP_DIMS);
    None for the others."""
    if d <= NUTS_ON_CHIP_DIMS:
        return None
    return torch.empty((nuts_tree_rows(max_depth), d, n), dtype=torch.float32, device=device)


def nuts_scratch_rows(max_depth: int) -> int:
    """Rows of d floats per chain of the matmul kernel's NUTS tree state:
    both tree endpoints (x, v, g), the subtree's proposal (x, g) and the
    U-turn stack (x, v for each of max_depth − 1 spans)."""
    return 8 + 2 * (max_depth - 1)


# The matmul kernels' tile rule and layouts (csrc/mjhmc_mm_engine.cuh:
# TileRule, mm_rule, mm_geom, nuts_rule, nuts_geom), mirrored here for the
# wrappers' buffers and the checks that hold the instances' own reports to
# them. The base tile is the energy's preset one; where the layout does not
# fit a block's 227 KB, the chains a block halve (the threads with them) down
# to one mma n-tile of 8 columns, and where even that does not fit the
# parameter matrix moves to a device buffer ("off"). Past that the
# intermediate's K rows run in chunks (``chunk`` rows at a time, the
# parameter matrix off chip, a chain's threads doubled up to 1,024 a block
# until an owner holds at most 4 groups of four dims, NUTS 16 dims), and
# where even 8 columns of X and G do not fit beside a chunk they and the
# mass move to the block's slice of the device buffer (``xg_off``). The rule
# refuses no shape: the device buffer is the limit. At the bf16 precisions a
# chunked tile with X and G on chip also keeps a ring of ``stages`` chunks of
# the parameter matrix's fragments in shared memory, and a tile may split
# over a cluster of CTAs (``cluster_plan``); mm_kernel's tile starts from
# ``RING_COLUMNS`` columns and both kernels' from ``RING_THREADS`` threads.
# mm_kernel takes the most blocks an SM any ring and chunk give, then the
# largest chunk, then the most stages; NUTS its tree state on chip where it
# fits, then the most stages, then the largest chunk; a ring's chunk is a
# multiple of 16 rows for each warp too. The ``xg_off`` tiles and "highest"
# take no ring.
#: shared memory on the H100: what a block may opt into, an SM's, and what
#: an SM reserves for each resident block
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED = 232448, 233472, 1024
#: the base tile per spec: chains and threads a block, MINB (mm_kernel's
#: logreg MJHMC 4 chains, its 8 columns one mma n-tile)
_BASE_TILES = {ProductOfTSpec: (8, 96, 4), SparseCodingSpec: (16, 256, 2),
               LogregSpec: (8, 128, 3)}
#: a chunk's rows at most, an owner's groups of four dims (mm_kernel) and
#: dims (NUTS) at most where a chunked tile's threads grow, a block's threads
#: at most (kChunkMax, kOwnerGroups, kOwnerDims, kMaxThreads)
CHUNK_MAX, OWNER_GROUPS, OWNER_DIMS, MAX_THREADS = 512, 4, 16, 1024
#: the ring of the chunked tiles at the bf16 precisions: a stage's bytes at
#: most (kStageBytes; at least one k-tile of each warp's fragments), its
#: stages (kMaxStages, kMinStages) and the cluster sizes (kClusterSizes)
STAGE_BYTES, MAX_STAGES, MIN_STAGES = 16384, 4, 2
CLUSTER_SIZES = (2, 4, 8, 16)
#: the ring's tiles with X and G on chip: columns and threads a block
#: (kRingColumns, kRingThreads)
RING_COLUMNS, RING_THREADS = 32, 256


class TileRule(NamedTuple):
    """A tile of the matmul kernels: chains and threads a block, the
    blocks an SM asked of ``__launch_bounds__``, the parameter matrix in a
    device buffer (``off``), NUTS's tree state in shared memory
    (``onchip``), the rows of a chunk of the intermediate (``chunk``, 0:
    all at once), X, G and the mass in the block's slice of the device
    buffer (``xg_off``) and the stages of the chunks' ring (``stages``, 0:
    none)."""

    chains: int
    threads: int
    minb: int
    off: bool
    onchip: bool
    chunk: int = 0
    xg_off: bool = False
    stages: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def param_floats(spec) -> int:
    """Floats of the parameter matrix at the spec's shape and precision
    (Params::kFloats): two f32 copies with rows padded to fours at
    "highest", else the bf16 A fragments of both contractions (16-padded;
    hi, and lo at "bf16x3") in 32-bit words; the device buffer's size where
    it is off chip."""
    d, k = mm_shape(spec)
    if spec.precision == "highest":
        return d * _round_up(k, 4) + k * _round_up(d, 4)
    copies = 2 if spec.precision == "bf16x3" else 1
    return 2 * copies * (_round_up(k, 16) * _round_up(d, 16) // 2)


def _minb(spec, floats: int) -> int:
    fit = SMEM_SM // (4 * floats + SMEM_RESERVED)
    return 1 if fit < 1 else min(_BASE_TILES[type(spec)][2], fit)


def _chunked_minb(spec, floats: int, threads: int) -> int:
    """A chunked tile's MINB (chunked_minb): at most 1,024 / T."""
    return min(_minb(spec, floats), max(1, MAX_THREADS // threads))


def frag_copies(precision: str) -> int:
    """The bf16 copies of the parameter matrix's fragments: hi (and lo at
    "bf16x3"); none at "highest"."""
    return {"highest": 0, "bf16x3": 2}.get(precision, 1)


def stage_k(threads: int, precision: str) -> int:
    """k-tiles a stage of the ring holds of each warp's fragments
    (stage_k): STAGE_BYTES of 512-byte fragments over the warps, at least
    one."""
    return max(1, STAGE_BYTES // (threads // 32 * 512 * max(frag_copies(precision), 1)))


def ring_floats(threads: int, precision: str, stages: int) -> int:
    """Shared floats of the ring (ring_floats): the stages and their two
    barriers each."""
    if not stages:
        return 0
    words = threads // 32 * stage_k(threads, precision) * frag_copies(precision) * 128
    return stages * (words + 4)


def b_floats(rows: int, columns: int, precision: str) -> int:
    """Shared floats of a B operand split into bf16 fragments (xb_floats,
    zb_floats): ``rows`` padded to 16, hi and, past one bf16 pass, lo."""
    return _cdiv(rows, 16) * (columns // 8) * 32 * (2 if precision == "default" else 4)


def split_floats(dp: int, columns: int, threads: int) -> int:
    """Shared floats of a split tile's partials (split_floats): G's and two
    energy partials a thread."""
    return dp * columns + 2 * threads


def _chunks(k: int, owners: int, threads: int = 0):
    """A chunked tile's candidate chunks, largest first (chunk_quantum,
    chunk_start): multiples of 16 and of a column's owners (with a ring's
    ``threads``, of 16 rows for each warp too: ring_quantum), at most
    ``CHUNK_MAX`` and k rounded up."""
    q = owners // math.gcd(owners, 16) * 16
    if threads:
        q = math.lcm(q, 16 * (threads // 32))
    return range(min(_round_up(k, q), max(CHUNK_MAX // q, 1) * q), q - 1, -q)


class MmGeometry(NamedTuple):
    """mm_kernel's layout on a tile (mm_geom): columns, operand row stride,
    a chain's threads (rows' owners) and its dims' owners, groups of four
    dims and rows (of a chunk, where chunked) an owner holds, the padded
    dims and rows (a chunk's), the shared memory in floats, and the block's
    slice of the device buffer where X and G live there."""

    columns: int
    ld: int
    row_owners: int
    dim_owners: int
    groups: int
    rows: int
    dp: int
    kp: int
    floats: int
    slice: int = 0


def mm_geometry(spec, variant: str, branches: bool, chains: int, threads: int,
                off: bool, chunk: int = 0, xg_off: bool = False, stages: int = 0) -> MmGeometry:
    d, k = mm_shape(spec)
    nc = 2 * chains if variant == "mjhmc" else chains
    ry = threads // chains
    groups = _cdiv(d, 4)
    ng = _cdiv(groups, ry)
    r = _cdiv(groups, ng)
    nk = chunk // ry if chunk else _cdiv(k, ry)
    dp, kp, ld = 4 * r * ng, chunk or ry * nk, nc + 4
    f32 = spec.precision == "highest" and not off
    params = 0 if off else param_floats(spec)
    # the f32 copies, X, G (none where xg_off), Y and Z (none at sparse
    # coding, whose Y is the residual operand; none with a ring, whose Z is
    # in ZB), the mass, then the bf16 fragments, 16-byte aligned
    mass = ((params if f32 else 0) + (0 if xg_off else dp * ld + dp * nc)
            + (kp * ld if isinstance(spec, SparseCodingSpec)
               else kp * nc + (0 if stages else kp * ld)))
    frag = _round_up(mass + (2 * dp if branches and not xg_off else 0), 4)
    # then (a ring's tiles) the ring, ZB, XB and a split tile's partials
    red = frag + (0 if f32 else params)
    if stages:
        red += (ring_floats(threads, spec.precision, stages)
                + b_floats(chunk, nc, spec.precision) + b_floats(d, nc, spec.precision)
                + split_floats(dp, nc, threads))
    return MmGeometry(nc, ld, ry, r, ng, nk, dp, kp,
                      red + (4 if variant == "mjhmc" else 3) * threads,
                      dp * (ld + nc + 2) if xg_off else 0)


def _grown(threads: int, owners_of, most: int) -> int:
    """A chunked tile's threads: doubled while an owner holds more than
    ``most`` (``owners_of(threads)``) and the block stays within 1,024."""
    while 2 * threads <= MAX_THREADS and owners_of(threads) > most:
        threads *= 2
    return threads


def mm_tile_rule(spec, variant: str) -> TileRule:
    """mm_kernel's tile of ``variant`` on the spec at its shape and
    precision (mm_rule; the layout with the branches must fit). Every shape
    has one: past the whole tile on chip or with the parameter matrix off
    chip, the chunked tiles (at the bf16 precisions with their ring)."""
    ch0, t0, _ = _BASE_TILES[type(spec)]
    if isinstance(spec, LogregSpec) and variant == "mjhmc":
        ch0 = 4
    cols = (lambda ch: 2 * ch) if variant == "mjhmc" else (lambda ch: ch)
    for off in (False, True):
        ch = ch0
        while cols(ch) >= 8:
            t = _round_up(t0 // ch0 * ch, 32)
            floats = mm_geometry(spec, variant, True, ch, t, off).floats
            if 4 * floats <= SMEM_BLOCK:
                return TileRule(ch, t, _minb(spec, floats), off, False)
            ch //= 2
    d, k = mm_shape(spec)
    ch8 = 4 if variant == "mjhmc" else 8
    wide = RING_COLUMNS // 2 if variant == "mjhmc" else RING_COLUMNS
    # X and G on chip with a ring (the bf16 precisions), then without, then
    # (xg_off) in the device buffer
    for ring, xg_off in ((True, False), (False, False), (False, True)):
        if ring and spec.precision == "highest":
            continue
        ch = ch8 if xg_off else wide if ring else ch0
        while cols(ch) >= 8:
            t = max(RING_THREADS, _round_up(ch, 32)) if ring else _round_up(t0 // ch0 * ch, 32)
            t = _grown(t, lambda t: _cdiv(_cdiv(d, 4), t // ch), OWNER_GROUPS)
            floats = lambda kc, ns: mm_geometry(spec, variant, True, ch, t, True, kc, xg_off,
                                                ns).floats
            if not ring:  # the largest chunk that fits
                for kc in _chunks(k, t // ch):
                    if 4 * floats(kc, 0) <= SMEM_BLOCK:
                        return TileRule(ch, t, _chunked_minb(spec, floats(kc, 0), t), True,
                                        False, kc, xg_off)
                ch //= 2
                continue
            kcs = _chunks(k, t // ch, t)
            least = floats(kcs[-1], MIN_STAGES)
            if 4 * least <= SMEM_BLOCK:
                best = _chunked_minb(spec, least, t)
                for kc in kcs:
                    for ns in range(MAX_STAGES, MIN_STAGES - 1, -1):
                        f = floats(kc, ns)
                        if 4 * f <= SMEM_BLOCK and _chunked_minb(spec, f, t) == best:
                            return TileRule(ch, t, best, True, False, kc, xg_off, ns)
            ch //= 2
    raise AssertionError(f"no tile of the matmul kernel at {mm_shape(spec)}")  # unreachable


def mm_smem_bytes(spec, variant: str, branches: bool) -> int:
    """Shared-memory bytes a block of mm_kernel's ``variant`` run takes at
    the spec's shape and precision, with the branches (the mass) or without
    (mirror of MmLayout::kFloats on the tile rule's tile)."""
    rule = mm_tile_rule(spec, variant)
    return 4 * mm_geometry(spec, variant, branches, rule.chains, rule.threads, rule.off,
                           rule.chunk, rule.xg_off, rule.stages).floats


def mm_splits(rule: TileRule) -> bool:
    """Whether mm_kernel's tile may split over a cluster (MmLayout::SPLITS):
    the ring's tiles."""
    return rule.stages > 0


def nuts_splits(rule: TileRule) -> bool:
    """Whether the NUTS tile may split over a cluster (NutsLayout::SPLITS):
    the ring's tiles with the tree state on chip."""
    return rule.stages > 0 and rule.onchip


def cluster_plan(tiles: int, held, splits: bool) -> tuple:
    """(C, split, grid) of a ring tile's launch (cluster_plan in the
    header): ``held`` the clusters of C = 2, 4, 8 and 16 CTAs the card holds
    at once at the tile's threads and shared bytes (the instance's tile
    report, entries 10-13). Where the tile may split and the card holds a
    cluster of two for every tile, each tile takes a cluster of the largest
    C the card holds one of a tile, its CTAs splitting the chunks; else a
    CTA a tile."""
    if splits and tiles <= held[0]:
        for s in (3, 2, 1, 0):
            if held[s] >= tiles:
                return CLUSTER_SIZES[s], True, tiles * CLUSTER_SIZES[s]
    return 1, False, tiles


def launched_blocks(rule: TileRule, n: int, splits: bool) -> int:
    """The most blocks a launch of the tile for ``n`` chains runs: its
    tiles, or, where it may split, 16 CTAs a tile (``cluster_plan``'s
    largest), so that the device buffer does not depend on the card's
    cluster occupancy."""
    tiles = _cdiv(n, rule.chains)
    return CLUSTER_SIZES[-1] * tiles if splits else tiles


def mm_scratch_floats(spec, variant: str, n: int) -> int:
    """Floats of mm_kernel's device buffer for ``n`` chains: the parameter
    matrix where the tile rule puts it off chip (``param_floats``), then,
    where X and G live there, each block's slice (MmGeom::slice) for as
    many blocks as a launch may run (``launched_blocks``); 0 where the tile
    needs none."""
    rule = mm_tile_rule(spec, variant)
    if not rule.off:
        return 0
    geom = mm_geometry(spec, variant, True, rule.chains, rule.threads, True, rule.chunk,
                       rule.xg_off, rule.stages)
    return param_floats(spec) + launched_blocks(rule, n, mm_splits(rule)) * geom.slice


def mm_scratch(spec, variant: str, n: int, device) -> Tensor | None:
    """mm_kernel's device buffer for ``n`` chains (``mm_scratch_floats``);
    None where the tile needs none."""
    floats = mm_scratch_floats(spec, variant, n)
    return torch.empty((floats,), dtype=torch.float32, device=device) if floats else None


class NutsGeometry(NamedTuple):
    """The matmul NUTS kernel's layout on a tile (nuts_geom): owners a
    column, dims and rows (of a chunk, where chunked) an owner holds, the
    padded dims and rows (a chunk's), the floats before the tree state,
    whether the tree state is on chip, and the block's slice of the device
    buffer where X and G live there."""

    owners: int
    dims: int
    rows: int
    dp: int
    kp: int
    tree: int
    chains: int
    threads: int
    onchip: bool
    slice: int = 0

    def floats(self, max_depth: int) -> int:
        """Shared floats a block at ``max_depth`` (past NUTS_MM_TILE_DEPTH,
        the layout at it)."""
        m = min(max_depth, NUTS_MM_TILE_DEPTH)
        tree = nuts_scratch_rows(m) * self.dp * self.chains if self.onchip else 0
        return self.tree + tree + (5 + 2 * (m - 1)) * self.threads


def nuts_mm_geometry(spec, chains: int, threads: int, off: bool, onchip: bool,
                     chunk: int = 0, xg_off: bool = False, stages: int = 0) -> NutsGeometry:
    d, k = mm_shape(spec)
    r = threads // chains
    ne = _cdiv(d, r)
    nk = chunk // r if chunk else _cdiv(k, r)
    dp, kp = r * ne, chunk or r * nk
    f32 = spec.precision == "highest" and not off
    params = 0 if off else param_floats(spec)
    # the f32 copies, the patch (none where chunked), X and G (none where
    # xg_off), Y and Z (none at sparse coding), the mass (none where
    # xg_off), then the bf16 fragments, 16-byte aligned
    mass = ((params if f32 else 0) + (0 if chunk else _round_up(k, 4))
            + (0 if xg_off else 2 * dp * chains)
            + kp * chains * (1 if isinstance(spec, SparseCodingSpec) or stages else 2))
    # then the fragments and (a ring's tiles) the ring, ZB, XB and (the tree
    # state on chip) a split tile's partials
    tree = _round_up(mass + (0 if xg_off else 2 * dp), 4) + (0 if f32 else params)
    if stages:
        tree += (ring_floats(threads, spec.precision, stages)
                 + b_floats(chunk, chains, spec.precision) + b_floats(d, chains, spec.precision)
                 + (split_floats(dp, chains, threads) if onchip else 0))
    return NutsGeometry(r, ne, nk, dp, kp, tree, chains, threads, onchip,
                        _round_up(dp * (2 * chains + 2), 4) if xg_off else 0)


def nuts_mm_tile_rule(spec) -> TileRule:
    """The matmul NUTS kernel's tile on the spec at its shape and precision
    (nuts_rule; the layout at NUTS_MM_TILE_DEPTH must fit, the tree state on
    chip where it fits there too; every depth runs on this tile). Every
    shape has one, as ``mm_tile_rule``'s."""
    nc0, t0, _ = _BASE_TILES[type(spec)]
    top = NUTS_MM_TILE_DEPTH
    for off in (False, True):
        nc = nc0
        while nc >= 8:
            t = _round_up(t0 // nc0 * nc, 32)
            floats = nuts_mm_geometry(spec, nc, t, off, False).floats(top)
            if 4 * floats <= SMEM_BLOCK:
                onchip = 4 * nuts_mm_geometry(spec, nc, t, off, True).floats(top) <= SMEM_BLOCK
                minb = _minb(spec, nuts_mm_geometry(spec, nc, t, off, onchip).floats(1))
                return TileRule(nc, t, minb, off, onchip)
            nc //= 2
    d, k = mm_shape(spec)
    for ring, xg_off in ((True, False), (False, False), (False, True)):
        if ring and spec.precision == "highest":
            continue
        nc = 8 if xg_off else nc0
        while nc >= 8:
            t = _round_up(t0 // nc0 * nc, 32)
            if ring:
                t = max(t, RING_THREADS)
            t = _grown(t, lambda t: _cdiv(d, t // nc), OWNER_DIMS)
            geom = lambda onchip, kc, ns: nuts_mm_geometry(spec, nc, t, True, onchip, kc,
                                                           xg_off, ns)
            if not ring:  # the largest chunk, the tree state on chip where it fits too
                for kc in _chunks(k, t // nc):
                    if 4 * geom(False, kc, 0).floats(top) > SMEM_BLOCK:
                        continue
                    onchip = 4 * geom(True, kc, 0).floats(top) <= SMEM_BLOCK
                    return TileRule(nc, t, _chunked_minb(spec, geom(onchip, kc, 0).floats(1), t),
                                    True, onchip, kc, xg_off)
            else:
                for onchip in (True, False):
                    for ns in range(MAX_STAGES, MIN_STAGES - 1, -1):
                        for kc in _chunks(k, t // nc, t):
                            g = geom(onchip, kc, ns)
                            if 4 * g.floats(top) <= SMEM_BLOCK:
                                return TileRule(nc, t, _chunked_minb(spec, g.floats(1), t), True,
                                                onchip, kc, xg_off, ns)
            nc //= 2
    raise AssertionError(f"no tile of the matmul NUTS kernel at {mm_shape(spec)}")  # unreachable


def nuts_mm_geometry_of(spec) -> NutsGeometry:
    """The NUTS layout on the tile rule's tile."""
    rule = nuts_mm_tile_rule(spec)
    return nuts_mm_geometry(spec, rule.chains, rule.threads, rule.off, rule.onchip, rule.chunk,
                            rule.xg_off, rule.stages)


def nuts_deep_rows(max_depth: int) -> int:
    """The stack rows a chain and the span slots a thread that a launch
    past NUTS_MM_TILE_DEPTH keeps in the device buffer: x and v, and the two
    U-turn projections, of each span of 2^mm leaves, mm ≥ the tile depth
    (mirror of nuts::deep_rows)."""
    return 2 * max(0, max_depth - NUTS_MM_TILE_DEPTH)


def nuts_scratch_floats(spec, max_depth: int, n: int) -> int:
    """Floats of the matmul NUTS kernel's device buffer for ``n`` chains:
    the parameter matrix where it is off chip (``param_floats``), the tree
    state (rows, DP, n) where it is not in shared memory (else, past
    NUTS_MM_TILE_DEPTH, its stack rows past it), then, where X and G live
    there, each block's slice (16-byte aligned), then, past
    NUTS_MM_TILE_DEPTH, each block's span slots past it ([slot][threads],
    after the same alignment), for as many blocks as a launch may run
    (``launched_blocks``); 0 where none."""
    rule = nuts_mm_tile_rule(spec)
    geom = nuts_mm_geometry_of(spec)
    deep = nuts_deep_rows(max_depth)
    rows = deep if rule.onchip else nuts_scratch_rows(max_depth)
    floats = (param_floats(spec) if rule.off else 0) + rows * geom.dp * n
    if rule.xg_off or deep:
        floats = _round_up(floats, 4) + launched_blocks(rule, n, nuts_splits(rule)) * (
            (geom.slice if rule.xg_off else 0) + deep * rule.threads)
    return floats


def nuts_scratch(spec, max_depth: int, n: int, device) -> Tensor | None:
    """The matmul NUTS kernel's device buffer (``nuts_scratch_floats``):
    the tree state (rows, DP, n) where it alone is there, else flat; None
    where the tile needs none."""
    rule = nuts_mm_tile_rule(spec)
    floats = nuts_scratch_floats(spec, max_depth, n)
    if not floats:
        return None
    if not rule.off and not rule.onchip and not nuts_deep_rows(max_depth):
        tree = (nuts_scratch_rows(max_depth), nuts_mm_geometry_of(spec).dp, n)
        return torch.empty(tree, dtype=torch.float32, device=device)
    return torch.empty((floats,), dtype=torch.float32, device=device)


def nuts_mm_smem_bytes(spec, max_depth: int) -> int:
    """Shared-memory bytes a block of the matmul NUTS kernel takes at the
    spec's shape, precision and ``max_depth`` (mirror of NutsLayout::floats
    on the tile rule's tile): the parameter matrix (f32 in both orientations
    at "highest", else its bf16 A fragments; none off chip), the patch, X
    and G, Y and Z (no Z at sparse coding), the mass, the tree state where
    it is on chip, and the column sums' partials (5 + 2(max_depth − 1) slots
    of one float a thread); past NUTS_MM_TILE_DEPTH, the bytes at it."""
    return 4 * nuts_mm_geometry_of(spec).floats(max_depth)


def _launch(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
            num_iters, m, thin, num_emits, fixed_uniform, variant, inv_mass,
            integrator, prof=None):
    """Check the state, allocate the outputs and launch the spec's kernel
    (with ``prof``, the kernel's PROF instance of the body writing into it)."""
    from mjhmc_tpu_torch.ops import _build

    if x.dim() != 2:
        raise ValueError(f"x must be (ndims, nbatch), got {tuple(x.shape)}")
    d, n = x.shape
    matmul = isinstance(spec, MATMUL_SPECS)
    if matmul:
        check_mm_dims(spec, d)
        # the tile rule's tile (raises where no tile fits, before any build)
        if variant == "nuts":
            nuts_mm_tile_rule(spec)
        elif not getattr(spec, "stub_dots", False):
            mm_tile_rule(spec, variant)
    else:
        check_kernel_dims(spec, d)
    cap = NUTS_MM_MAX_DEPTH if matmul else NUTS_MAX_DEPTH
    if variant == "nuts" and not 1 <= m <= cap:
        raise NotImplementedError(
            f"the {'matmul' if matmul else 'elementwise'} NUTS kernel holds trees of "
            f"max_depth 1..{cap} (2^max_depth − 1 leaves fit an int32), not {m}")
    if x.device.type != "cuda":
        raise ValueError(
            f"the CUDA engine takes cuda tensors (or cpu ones for its plain "
            f"version), not {x.device}"
        )
    if n == 0 or thin < 1 or num_iters < 0:
        raise ValueError(f"need nbatch > 0, thin >= 1, steps >= 0 (got {n}, {thin}, {num_iters})")
    if matmul and m < 1:  # the endpoint energies reuse the last step's product
        raise ValueError(f"the matmul kernel needs leapfrog steps >= 1, got {m}")
    if getattr(spec, "stub_dots", False) and (
            num_emits is not None or not isinstance(spec, ProductOfTSpec)
            or mm_shape(spec) != MM_KERNEL_SHAPES[ProductOfTSpec]):
        raise NotImplementedError(
            "the stub_dots kernel is instantiated for the product-of-t preset's run "
            "only, the roofline dossier's ablation row (its plain version takes any spec)"
        )
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
    mass = _mass_tensor(inv_mass, d, x.device)
    if prof is not None or getattr(spec, "stub_dots", False):  # these live in the library
        lib = _build.load()
    elif matmul:
        sweep_run = (variant == "mjhmc" and integrator == "leapfrog" and inv_mass is None
                     and num_emits is None)
        entries = mm_library(variant, spec, d, spec.aux_rows(), sweep_run)
    else:
        entries = ew_library(variant, spec, d)
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
    branches = (None if mass is None else mass.data_ptr(), int(integrator == "two_stage"))
    ptrs = [t.data_ptr() for t in (x, v, g, u, h_back, back_valid, *out)]
    ptrs += [None if t is None else t.data_ptr() for t in emits]
    tail = (n, num_iters, thin, m, int(seed) & _MASK32, float(epsilon), float(beta),
            int(fixed_uniform),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if matmul:
        params = [t.contiguous() for t in _param_tensors(spec, d, x.device)]
        p0, p1 = (params + [None])[:2]
        if getattr(spec, "stub_dots", False):
            scratch, fn, extra = None, lib.mjhmc_mm_engine_launch, ()
        elif prof is not None:
            scratch = nuts_scratch(spec, m, n, x.device) if variant == "nuts" else None
            fn = lib.mjhmc_mm_nuts_profile if variant == "nuts" else lib.mjhmc_mm_profile
            extra = (prof.data_ptr(),)
        else:
            scratch = (nuts_scratch(spec, m, n, x.device) if variant == "nuts"
                       else mm_scratch(spec, variant, n, x.device))
            # control's and MALT's instances have the branches always
            _check_buffer(entries, spec, variant,
                          variant != "mjhmc" or mass is not None or integrator == "two_stage",
                          m, n, scratch)
            fn, extra = entries.launch, ()
        rc = fn(
            spec.energy_id, d, spec.aux_rows(), int(getattr(spec, "stub_dots", False)),
            KERNEL_VARIANTS[variant], PRECISIONS.index(spec.precision),
            p0.data_ptr(), None if p1 is None else p1.data_ptr(),
            *spec.constants(), *branches, None if scratch is None else scratch.data_ptr(),
            *ptrs, *tail, *extra,
        )
    else:
        params = torch.as_tensor(spec.param_vector(d), device=x.device).contiguous()
        scratch = nuts_tree_scratch(d, m, n, x.device) if variant == "nuts" else None
        if prof is not None:
            fn = lib.mjhmc_nuts_profile if variant == "nuts" else lib.mjhmc_ew_profile
            extra = (prof.data_ptr(),)
        else:
            fn, extra = entries.launch, ()
        rc = fn(KERNEL_VARIANTS[variant], d, spec.energy_id, params.data_ptr(),
                *spec.constants(), *branches, None if scratch is None else scratch.data_ptr(),
                *ptrs, *tail, *extra)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} (variant {variant}, {type(spec).__name__}, d={d}) "
                           f"failed: CUDA error {rc}")
    return out, emits


#: the phases of the elementwise NUTS run's PROF instance
#: (csrc/mjhmc_engine.cuh, nuts::Phase): cycles of each, then the chain's
#: leaves and the leaf slots its warp spent (counted by one lane a step)
NUTS_EW_PROF_PHASES = ("kick_drift_gradient", "energy_halfsq", "multinomial_draw",
                       "stack_uturn", "round", "iteration", "idle", "other", "leaves",
                       "leaf_slots")


#: threads a block of the elementwise MJHMC, control and MALT kernels at
#: most (csrc/mjhmc_engine.cuh, kThreads)
EW_THREADS = 64


#: dims a lane holds at most where a chain's dims go to a group of lanes
#: (csrc/mjhmc_engine.cuh, kLaneDims): the presets' D 50 over 8 lanes
LANE_DIMS = 7


def lanes_for(d: int, most: int) -> int:
    """The fewest lanes, a power of two up to a warp, that hold at most
    ``most`` of ``d`` dims each (mirror of lanes_for)."""
    g = 1
    while g < 32 and -(-d // g) > most:
        g *= 2
    return g


def ew_lanes(variant: str, spec, d: int) -> int:
    """Lanes a chain of the elementwise MJHMC, control or MALT body at ``d``
    dims (mirror of ew_lanes in csrc/mjhmc_engine.cuh). The rough well's and
    the Gaussian's dims go to the fewest lanes that hold at most
    ``LANE_DIMS`` each (one at D 2, 8 at D 50), MALT's to 2 at least from D
    2. A coupled energy: MJHMC's two trajectories on 2 lanes from D 10;
    control's whole mode (each lane every dim and the trajectory, the
    corruption draw's pairs split) on 8 lanes from D 10; MALT's funnel and
    eight schools dims over ``lanes_for(d, LANE_DIMS)`` lanes, 4 at least,
    from D 10, the banana and the mixture on one lane (their gradient runs
    on one); else one thread a chain."""
    separable = isinstance(spec, (RoughWellSpec, GaussianSpec))
    g = lanes_for(d, LANE_DIMS)
    if separable:
        return 2 if variant == "malt" and d >= 2 and g < 2 else g
    if variant == "mjhmc":
        return 2 if d >= 10 else 1
    if variant == "control":
        return 8 if d >= 10 else 1
    grouped = isinstance(spec, (FunnelSpec, EightSchoolsSpec))
    return max(4, g) if grouped and d >= 10 else 1


def ew_threads(lanes: int, n: int, sms: int) -> int:
    """Threads a block of the elementwise MJHMC, control or MALT body for
    ``n`` chains of ``lanes`` lanes on a card of ``sms`` SMs (mirror of
    ew_threads_for): the fewest, a power of two from the group up to
    EW_THREADS, that put at most one block on each SM sub-partition, else
    EW_THREADS."""
    t = lanes
    while t < EW_THREADS and -(-n * lanes // t) > SM_SUBPARTITIONS * sms:
        t *= 2
    return t


def ew_tile(variant: str, spec, d: int, n: int) -> tuple:
    """(lanes a chain, threads a block) of the elementwise MJHMC, control or
    MALT body of ``spec`` at ``d`` dims for ``n`` chains, as the instance
    that runs it reports them (``mjhmc_ew_tile``, or an on-demand
    instance's ``mjhmc_od_ew_tile``; ``ew_lanes`` and ``ew_threads`` mirror
    them)."""
    out = (ctypes.c_int * 2)()
    rc = ew_library(variant, spec, d).ew_tile(KERNEL_VARIANTS[variant], d, spec.energy_id, n,
                                              out)
    if rc != 0:
        raise RuntimeError(f"mjhmc_ew_tile: no grouping of {variant} (CUDA error {rc})")
    return tuple(out)


def sincos_probe(x: Tensor) -> Tensor:
    """(4, n): sinf, cosf and sincosf's sine and cosine of each float of the
    CUDA tensor ``x``, from the library's probe kernel (the rough well's MALT
    force and energy share one sincosf; this says whether it gives the
    separate functions' bits). A measurement, not a main-path call."""
    from mjhmc_tpu_torch.ops import _build

    x = x.contiguous()
    out = torch.empty((4, x.numel()), dtype=torch.float32, device=x.device)
    rc = _build.load().mjhmc_sincos_probe(
        x.data_ptr(), out.data_ptr(), x.numel(),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"mjhmc_sincos_probe failed: CUDA error {rc}")
    return out


def nuts_tile(spec, d: int, max_depth: int, n: int, mass: bool = False) -> tuple:
    """(threads, shared-memory bytes) of a block of the elementwise NUTS
    instance of ``spec`` at ``d`` dims, without a mass or with one, for
    ``n`` chains at ``max_depth``, and the blocks of it an SM holds at once,
    as the instance that runs it reports them (``mjhmc_nuts_tile``, or an
    on-demand instance's ``mjhmc_od_nuts_tile``; ``nuts_threads`` and
    ``nuts_smem_bytes`` mirror the first two)."""
    out = (ctypes.c_int * 3)()
    rc = ew_library("nuts", spec, d).nuts_tile(d, spec.energy_id, int(mass), max_depth, n, out)
    if rc != 0:
        raise RuntimeError(f"mjhmc_nuts_tile: no NUTS instance of {type(spec).__name__} at "
                           f"d={d}{' with a mass' if mass else ''} (CUDA error {rc})")
    return tuple(out)


def nuts_profile(spec, x, v, g, u, seed, epsilon, num_iters, max_depth) -> Tensor:
    """The phase breakdown of the elementwise NUTS run from its PROF
    instance (CUDA tensors; gauss2d or the funnel, no mass), in the main
    path's blocks (``nuts_threads``): an int64 (n,
    len(NUTS_EW_PROF_PHASES)) tensor of each chain's clock64() cycles per
    phase, its leaves and its warp's leaf slots. A measurement, not a
    main-path call: the run's outputs are dropped and no launch is counted."""
    prof = torch.zeros((x.shape[1], len(NUTS_EW_PROF_PHASES)), dtype=torch.int64,
                       device=x.device)
    z = torch.zeros_like(u)
    _launch(spec, x, v, g, u, z, z, seed, epsilon, 0.0, num_iters, max_depth, 1, None,
            False, "nuts", None, "leapfrog", prof=prof)
    return prof


#: the phases of the elementwise MJHMC, control and MALT runs' PROF instances
#: (csrc/mjhmc_engine.cuh, ewprof): cycles of each, then (MJHMC) the
#: chain-iterations that began with an invalid cache and those whose warp held
#: any such chain
EW_PROF_PHASES = {
    "mjhmc": ("trajectories", "energies_rates_choice", "refresh", "kahan_emission", "other",
              "invalid_iterations", "warp_invalid_iterations"),
    "control": ("corruption_draw", "trajectory", "end_energy", "accept_kahan", "other"),
    "malt": ("refresh_draw", "o_step_draws", "kick_drift_gradient", "energy", "accept_kahan",
             "other"),
}


def ew_profile(spec, variant, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
               num_iters, m, inv_mass=None) -> Tensor:
    """The phase breakdown of an elementwise MJHMC, control or MALT run from
    its PROF instance (CUDA tensors; the cases the C entry
    ``mjhmc_ew_profile`` has: the rough well at D 2 and the funnel without a
    mass, MJHMC and control on the D=50 Gaussian with one), in the main
    path's blocks: an int64 (n,
    len(EW_PROF_PHASES[variant])) tensor of each chain's clock64() cycles
    per phase and its counters. A measurement, not a main-path call: the
    run's outputs are dropped and no launch is counted."""
    prof = torch.zeros((x.shape[1], len(EW_PROF_PHASES[variant])), dtype=torch.int64,
                       device=x.device)
    _launch(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta, num_iters, m, 1, None,
            False, variant, inv_mass, "leapfrog", prof=prof)
    return prof


#: the phases of the matmul NUTS run's PROF instance (csrc/mjhmc_mm_engine.cuh,
#: nuts::Phase): cycles of each, then the block's leaf steps
NUTS_PROF_PHASES = ("kick_drift", "contraction_1", "contraction_2", "energy_halfsq",
                    "multinomial", "stack_writes", "leaf_uturn", "round_end",
                    "barrier_waits", "other", "leaf_steps")


#: the numbers a tile entry writes (the header's tile_of, nuts_tile_at)
TILE_REPORT = 14


def _nuts_tile_report(entries: MmEntries, spec, max_depth: int) -> tuple:
    """All the numbers the NUTS tile entry writes (``nuts_mm_tile``'s
    four, then its device buffer's: floats of a block's slice, the
    parameter matrix's, the tree state's a chain, a block's span slots; then
    the cluster's: the ring's stages, whether a tile may split, and the
    clusters of 2, 4, 8 and 16 CTAs the card holds at once)."""
    out = (ctypes.c_int * TILE_REPORT)()
    rc = entries.nuts_tile(spec.energy_id, PRECISIONS.index(spec.precision), max_depth, out)
    if rc != 0:
        raise RuntimeError(f"mjhmc_mm_nuts_tile: no NUTS instance of {type(spec).__name__} "
                           f"at {spec.precision} (CUDA error {rc})")
    return tuple(out)


def nuts_mm_tile(spec, max_depth: int) -> tuple:
    """(chains, threads, shared-memory bytes) of a block of the matmul NUTS
    instances of ``spec`` at its shape, precision and ``max_depth``, and the
    blocks of its run an SM holds at once, as the instance that runs it
    reports them (``mjhmc_mm_nuts_tile``, or an on-demand instance's
    ``mjhmc_mm_od_nuts_tile``; ``nuts_mm_tile_rule`` and
    ``nuts_mm_smem_bytes`` mirror the first three)."""
    return _nuts_tile_report(mm_library("nuts", spec, *mm_shape(spec)), spec, max_depth)[:4]


def nuts_mm_profile(spec, x, v, g, u, seed, epsilon, num_iters, max_depth) -> Tensor:
    """The per-leaf phase breakdown of the matmul NUTS run from its PROF
    instance (CUDA tensors; the spec at its JAX default precision, no
    mass): an int64 (blocks, 2, len(NUTS_PROF_PHASES)) tensor of each
    block's clock64() cycles per phase as thread 0 and the last warp's
    first thread saw them, and its leaf steps. A measurement, not a
    main-path call: the run's outputs are dropped and no launch is counted."""
    blocks = -(-x.shape[1] // nuts_mm_tile_rule(spec).chains)
    prof = torch.zeros((blocks, 2, len(NUTS_PROF_PHASES)), dtype=torch.int64,
                       device=x.device)
    z = torch.zeros_like(u)
    _launch(spec, x, v, g, u, z, z, seed, epsilon, 0.0, num_iters, max_depth, 1, None,
            False, "nuts", None, "leapfrog", prof=prof)
    return prof


#: the phases of mm_kernel's PROF instances (csrc/mjhmc_mm_engine.cuh,
#: MmPhase): cycles of each, then the block's gradients
MM_PROF_PHASES = ("draws_o_steps", "kick_drift", "contraction_1", "contraction_2", "sums",
                  "decide_move", "barrier_waits", "other", "gradients")


def mm_tile(spec, variant: str, branches: bool = False) -> tuple:
    """(chains, threads, shared-memory bytes) of a block of mm_kernel's
    ``variant`` run of ``spec`` at its shape and precision, with the
    branches or without (control and MALT have only the former), and the
    blocks of it an SM holds at once, as the instance that runs it reports
    them (``mjhmc_mm_tile``, or an on-demand instance's ``mjhmc_mm_od_tile``;
    ``mm_tile_rule`` and ``mm_smem_bytes`` mirror the first three)."""
    sweep_run = variant == "mjhmc" and not branches
    return _tile_report(mm_library(variant, spec, *mm_shape(spec), sweep_run), spec, variant,
                        branches)[:4]


def _tile_report(entries: MmEntries, spec, variant: str, branches: bool) -> tuple:
    """All the numbers mm_kernel's tile entry writes (``mm_tile``'s four,
    then its device buffer's: floats of a block's slice, the parameter
    matrix's, 0, 0; then the cluster's, as ``_nuts_tile_report``'s)."""
    out = (ctypes.c_int * TILE_REPORT)()
    rc = entries.tile(spec.energy_id, PRECISIONS.index(spec.precision), KERNEL_VARIANTS[variant],
                      int(branches), out)
    if rc != 0:
        raise RuntimeError(f"mjhmc_mm_tile: no {variant} instance of {type(spec).__name__} at "
                           f"{spec.precision}{' with the branches' if branches else ''} "
                           f"(CUDA error {rc})")
    return tuple(out)


def cluster_of(spec, variant: str, n: int, max_depth: int = NUTS_MM_TILE_DEPTH,
               branches: bool = True) -> dict | None:
    """The cluster launch of ``variant``'s tile of the spec for ``n``
    chains, from its instance's tile report (the ring's stages, whether a
    tile may split, the clusters of each size the card holds at once) and
    ``cluster_plan``: a dict of those and the plan's C, split and grid;
    None where the tile has no ring (no cluster)."""
    entries = mm_library(variant, spec, *mm_shape(spec))
    rep = (_nuts_tile_report(entries, spec, max_depth) if variant == "nuts"
           else _tile_report(entries, spec, variant, branches))
    if not rep[8]:
        return None
    c, split, grid = cluster_plan(_cdiv(n, rep[0]), rep[10:14], bool(rep[9]))
    return dict(stages=rep[8], splits=bool(rep[9]), held=dict(zip(CLUSTER_SIZES, rep[10:14])),
                c=c, split=split, grid=grid)


#: {(the tile entry's address, energy, shape, precision, variant, branches,
#: max_depth): the instance's tile report}, read once a key
#: (``_check_buffer``)
_TILE_REPORTS: dict = {}


def _check_buffer(entries: MmEntries, spec, variant: str, branches: bool, max_depth: int,
                  n: int, scratch: Tensor | None) -> None:
    """Refuse a launch whose device buffer is not the one the instance
    indexes for ``n`` chains, as its tile entry reports it: the parameter
    matrix where off chip, NUTS's tree state where off chip (16-byte
    aligned before the slices), then a slice a block where X and G live
    there. The mirror sizes the buffer (``mm_scratch``, ``nuts_scratch``);
    this holds it to the compiled layout, so that a drift between the two
    raises instead of writing past the buffer. Past NUTS_MM_TILE_DEPTH, the
    span slots a block follow (16-byte aligned, after the slices). A
    clustered tile's blocks are as many as any plan may launch
    (``launched_blocks``)."""
    nuts = variant == "nuts"
    entry = ctypes.cast(entries.nuts_tile if nuts else entries.tile, ctypes.c_void_p).value
    key = (entry, spec.energy_id, mm_shape(spec), spec.precision, variant, branches,
           max_depth if nuts else 0)
    if key not in _TILE_REPORTS:
        _TILE_REPORTS[key] = (_nuts_tile_report(entries, spec, max_depth) if nuts
                              else _tile_report(entries, spec, variant, branches))
    report = _TILE_REPORTS[key]
    chains, slice_, params, tree, stages, splits = (report[i] for i in (0, 4, 5, 6, 8, 9))
    slots = report[7] if nuts else 0
    want = params + tree * n
    if slice_ or slots:
        blocks = launched_blocks(TileRule(chains, 0, 0, True, False, stages=stages), n,
                                 bool(splits))
        want = (_round_up(want, 4) if nuts else want) + blocks * (slice_ + slots)
    have = 0 if scratch is None else scratch.numel()
    if have != want:
        raise RuntimeError(
            f"the {variant} instance of {type(spec).__name__} at {mm_shape(spec)} indexes a "
            f"device buffer of {want} floats for {n} chains (tile report "
            f"{_TILE_REPORTS[key]}); the mirror allocated {have}")


def mm_profile(spec, variant, x, v, g, u, seed, epsilon, beta, num_iters, m) -> Tensor:
    """The per-iteration phase breakdown of mm_kernel's ``variant`` run
    ("mjhmc" or "malt") from its PROF instance (CUDA tensors; sparse coding
    at "bf16x3" both, logreg at "default" MALT; no mass): an int64 (blocks,
    2, len(MM_PROF_PHASES)) tensor of each block's clock64() cycles per
    phase as thread 0 and the last warp's first thread saw them, and its
    gradients. A measurement, not a main-path call: the run's outputs are
    dropped and no launch is counted."""
    blocks = -(-x.shape[1] // mm_tile_rule(spec, variant).chains)
    prof = torch.zeros((blocks, 2, len(MM_PROF_PHASES)), dtype=torch.int64, device=x.device)
    z = torch.zeros_like(u)
    _launch(spec, x, v, g, u, z, z, seed, epsilon, beta, num_iters, m, 1, None, False, variant,
            None, "leapfrog", prof=prof)
    return prof


#: each wrapper's launch counts: one per step body (``launches`` is MJHMC's,
#: ``stub_launches`` the stubbed matmul kernel's), and the launches that
#: took the two-stage integrator or an inverse mass, NUTS's at max_depth 11
#: or deeper, (matmul kernel, not the stub) those at each dot precision and
#: those made for a rank of a chain mesh (``sharded_cuda_mjhmc_run``),
#: counted besides
COUNTS = ("launches", "control_launches", "malt_launches", "nuts_launches",
          "stub_launches", "two_stage_launches", "mass_launches", "sharded_launches",
          "deep_nuts_launches", *(f"{p}_launches" for p in PRECISIONS))


def _count(wrapper, spec, variant, integrator, inv_mass, m) -> None:
    """One launch of the wrapper's kernel, counted under its step body and
    its branches (``m``: M, or NUTS's max_depth)."""
    if getattr(spec, "stub_dots", False):
        wrapper.stub_launches += 1
    elif variant == "mjhmc":
        wrapper.launches += 1
    else:
        name = f"{variant}_launches"
        setattr(wrapper, name, getattr(wrapper, name) + 1)
    if variant == "nuts" and m > 10:
        wrapper.deep_nuts_launches += 1
    if integrator == "two_stage":
        wrapper.two_stage_launches += 1
    if inv_mass is not None:
        wrapper.mass_launches += 1
    if isinstance(spec, MATMUL_SPECS) and not getattr(spec, "stub_dots", False):
        name = f"{spec.precision}_launches"
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def reset_counts() -> None:
    """Set every launch count of the four engine wrappers to 0."""
    for fn in WRAPPERS:
        for name in COUNTS:
            setattr(fn, name, 0)


def _run(wrapper, kinds, spec, x, v, g, u, h_back, back_valid, seed, epsilon,
         beta, num_steps, num_leapfrog, inv_mass, variant, integrator,
         fixed_uniform) -> RunOut:
    _check_slice(spec, variant, integrator, inv_mass, kinds)
    if x.device.type == "cpu":
        return run_reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                             num_steps, num_leapfrog, fixed_uniform, variant=variant,
                             inv_mass=inv_mass, integrator=integrator)
    out, _ = _launch(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                     num_steps, num_leapfrog, 1, None, fixed_uniform, variant,
                     inv_mass, integrator)
    _count(wrapper, spec, variant, integrator, inv_mass, num_leapfrog)
    return out


def _stream_run(wrapper, kinds, spec, x, v, g, u, h_back, back_valid, seed,
                epsilon, beta, num_emits, thin, num_leapfrog, inv_mass, variant,
                integrator, fixed_uniform):
    _check_slice(spec, variant, integrator, inv_mass, kinds)
    if x.device.type == "cpu":
        return stream_reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                                num_emits, thin, num_leapfrog, fixed_uniform,
                                variant=variant, inv_mass=inv_mass, integrator=integrator)
    out, (xs, ws, es) = _launch(spec, x, v, g, u, h_back, back_valid, seed,
                                epsilon, beta, num_emits * thin, num_leapfrog,
                                thin, num_emits, fixed_uniform, variant, inv_mass,
                                integrator)
    _count(wrapper, spec, variant, integrator, inv_mass, num_leapfrog)
    return xs, ws, es, out


def cuda_mjhmc_run(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                   num_steps, num_leapfrog, *, inv_mass=None, variant="mjhmc",
                   integrator="leapfrog", fixed_uniform=False) -> RunOut:
    """Engine run for the elementwise energies (counterpart of
    ``pallas_mjhmc_run``): ``num_steps`` iterations in one launch. CUDA
    tensors launch the kernel; CPU tensors take the plain version.
    ``variant``: "mjhmc" (jump process; ``beta`` the refresh rate),
    "control" (``beta`` the corruption fraction), "malt" (``beta`` the
    friction γ) or "nuts" (``beta`` unused, the ``num_leapfrog`` slot is
    max_depth). ``inv_mass``: a diagonal M⁻¹ (d entries); ``integrator``:
    "leapfrog" or "two_stage" (MJHMC and control)."""
    return _run(cuda_mjhmc_run, ELEMENTWISE_SPECS, spec, x, v, g, u, h_back,
                back_valid, seed, epsilon, beta, num_steps, num_leapfrog,
                inv_mass, variant, integrator, fixed_uniform)


def cuda_mjhmc_stream_run(spec, x, v, g, u, h_back, back_valid, seed, epsilon,
                          beta, num_emits, thin, num_leapfrog, *, inv_mass=None,
                          variant="mjhmc", integrator="leapfrog",
                          fixed_uniform=False):
    """Streaming engine run for the elementwise energies (counterpart of
    ``pallas_mjhmc_stream_run``): returns (xs (E, d, n), ws (E, n), es (E, n)
    int32, RunOut). MJHMC emits every ``thin``-th iteration's
    pre-transition x with its dwell weight; control, MALT and NUTS the
    post-transition x with weight 1."""
    return _stream_run(cuda_mjhmc_stream_run, ELEMENTWISE_SPECS, spec, x, v, g,
                       u, h_back, back_valid, seed, epsilon, beta, num_emits,
                       thin, num_leapfrog, inv_mass, variant, integrator,
                       fixed_uniform)


def cuda_mjhmc_mm_run(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                      num_steps, num_leapfrog, *, inv_mass=None, variant="mjhmc",
                      integrator="leapfrog", fixed_uniform=False) -> RunOut:
    """Engine run for the matmul energies (counterpart of
    ``pallas_mjhmc_mm_run``), same contract as ``cuda_mjhmc_run``."""
    return _run(cuda_mjhmc_mm_run, MATMUL_SPECS, spec, x, v, g, u, h_back,
                back_valid, seed, epsilon, beta, num_steps, num_leapfrog,
                inv_mass, variant, integrator, fixed_uniform)


def cuda_mjhmc_mm_stream_run(spec, x, v, g, u, h_back, back_valid, seed, epsilon,
                             beta, num_emits, thin, num_leapfrog, *, inv_mass=None,
                             variant="mjhmc", integrator="leapfrog",
                             fixed_uniform=False):
    """Streaming engine run for the matmul energies (counterpart of
    ``pallas_mjhmc_mm_stream_run``), same contract as
    ``cuda_mjhmc_stream_run``; the emissions carry no row padding."""
    return _stream_run(cuda_mjhmc_mm_stream_run, MATMUL_SPECS, spec, x, v, g, u,
                       h_back, back_valid, seed, epsilon, beta, num_emits, thin,
                       num_leapfrog, inv_mass, variant, integrator, fixed_uniform)


WRAPPERS = (cuda_mjhmc_run, cuda_mjhmc_stream_run, cuda_mjhmc_mm_run,
            cuda_mjhmc_mm_stream_run)
reset_counts()

#: the seed offset of each rank of a chain mesh (JAX's ``dev * 131071``)
RANK_SEED_STRIDE = 131071


def rank_seed(seed: int, rank: int) -> int:
    """``int32(seed) + rank·131071`` with JAX's int32 wrap."""
    return (int(seed) + rank * RANK_SEED_STRIDE + 2**31) % 2**32 - 2**31


def sharded_cuda_mjhmc_run(mesh, spec, x, v, g, u, h_back, back_valid, seed, epsilon,
                           beta, *rest, **kw) -> RunOut:
    """Engine run on every rank of a ("chains",) mesh (counterpart of
    ``sharded_pallas_mjhmc_run``). Chains are independent, so this is pure
    SPMD: each rank passes its own block of the chains and launches the run
    kernel its spec needs (``cuda_mjhmc_run`` for an elementwise spec,
    ``cuda_mjhmc_mm_run`` for a matmul one) with the rank-offset seed
    ``rank_seed(seed, rank)``, and communicates nothing. A chain's Philox
    counter is its index in the block, so rank r's result is a direct run
    on its block at seed + r·131071. ``rest`` and ``kw`` are the run
    wrapper's (num_steps, num_leapfrog, inv_mass=..., variant=...).
    Returns the rank's ``RunOut``; on the card each call is one launch,
    counted in the wrapper's ``sharded_launches``."""
    run_fn = cuda_mjhmc_mm_run if isinstance(spec, MATMUL_SPECS) else cuda_mjhmc_run
    out = run_fn(spec, x, v, g, u, h_back, back_valid,
                 rank_seed(seed, mesh.axis_index("chains")), epsilon, beta, *rest, **kw)
    if x.device.type == "cuda":
        run_fn.sharded_launches += 1
    return out


# --------------------------------------------------------------------------
# engines
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CudaMJHMC:
    """High-throughput MJHMC engine (counterpart of ``PallasMJHMC``).

    Takes any ``nbatch``. Matmul energies (product of t, sparse coding) go
    through the matmul kernel, the others through the elementwise one, as
    ``PallasMJHMC`` picks its kernels. ``device="cpu"`` runs the kernels'
    plain version; ``fixed_uniform`` pins every uniform at 2⁻²⁵ (test mode).
    ``inv_mass``: a per-dim diagonal M⁻¹ (Stan convention: the target's
    variances); the initial momenta are then drawn from N(0, M).
    ``integrator``: "leapfrog" or "two_stage" (2 gradients per step).
    A matmul energy contracts at its spec's JAX default precision
    (product of t and logreg one bf16 pass, sparse coding bf16x3); another
    is picked as in JAX, ``eng.spec = dataclasses.replace(eng.spec,
    precision="highest")`` (``PRECISIONS``). Any (d, k) and precision runs
    on the card: what the library lacks (``MM_KERNEL_SHAPES``,
    ``MM_KERNEL_PRECISIONS``) is compiled at its first call (``mm_library``).
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
        self._matmul = isinstance(self.spec, MATMUL_SPECS)
        if self._matmul:
            self._run_fn, self._stream_fn = cuda_mjhmc_mm_run, cuda_mjhmc_mm_stream_run
        else:
            self._run_fn, self._stream_fn = cuda_mjhmc_run, cuda_mjhmc_stream_run
        _check_slice(self.spec, self.variant, self.integrator, self.inv_mass,
                     MATMUL_SPECS if self._matmul else ELEMENTWISE_SPECS)
        self.device = checked_device(self.device, type(self).__name__)
        gen = torch.Generator().manual_seed(self.seed)
        # the kernels take contiguous (d, n) rows; a mixture's draws at D > 1
        # come transposed
        x = self.distribution.init_x(gen, self.nbatch, self.device).contiguous()
        v = randn(gen, x.shape, self.device)
        if self.inv_mass is not None:  # momenta live in N(0, M)
            self.inv_mass = np.asarray(self.inv_mass, np.float32).reshape(x.shape[0])
            v = v / torch.sqrt(torch.as_tensor(self.inv_mass, device=self.device))[:, None]
        u, g = self.distribution.potential_and_grad(x)
        zeros = torch.zeros(self.nbatch, dtype=torch.float32, device=self.device)
        self.x, self.v, self.g, self.u = x, v, g.contiguous(), u.contiguous()
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
        out = self._run_fn(
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
        xs, ws, es, out = self._stream_fn(
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

    @classmethod
    def from_warmup(cls, dist, seed: int = 0, nbatch: int = 10_240, beta: float = 0.1,
                    num_leapfrog_steps: int = 10, device="cuda", **warmup_kwargs):
        """Stan-style warmup → fused engine: ``mjhmc_full_warmup`` on the
        plain sampler, on the engine's device (dual-averaged ε, a
        variance-estimated diagonal M⁻¹, ε re-tuned under it), then the
        engine with that (ε, M⁻¹), holding the warmed chains."""
        gen = torch.Generator().manual_seed(seed)
        state, eps, inv_mass = mjhmc_full_warmup(
            dist, gen, nbatch, beta=beta, num_leapfrog_steps=num_leapfrog_steps,
            device=device, **warmup_kwargs)
        eng = cls(dist, epsilon=eps, beta=beta, num_leapfrog_steps=num_leapfrog_steps,
                  nbatch=nbatch, seed=seed, device=device,
                  inv_mass=tuple(float(v) for v in inv_mass.reshape(-1)))
        eng.load_state(state)
        return eng


@dataclasses.dataclass
class CudaNUTS(CudaMJHMC):
    """Fused NUTS engine (counterpart of ``PallasNUTS``), on either kernel:
    ``num_leapfrog_steps`` is max_depth (default 8, at most 31 on either
    kernel, ``NUTS_MAX_DEPTH``, ``NUTS_MM_MAX_DEPTH``: 2^31 − 1 leaves, whose
    counts fit an int32), ``beta`` is unused. Emissions are post-transition
    positions with weight 1; ``evals`` counts the integrated leaves of each
    chain exactly."""

    beta: float = 0.0  # unused scalar slot
    num_leapfrog_steps: int = 8  # max_depth
    variant: str = "nuts"

    @classmethod
    def from_warmup(cls, dist, seed: int = 0, nbatch: int = 10_240, max_depth: int = 8,
                    device="cuda", **warmup_kwargs):
        """Stan-style NUTS warmup → fused engine: ``nuts_full_warmup`` on
        the plain sampler (at most 1,024 chains, on the engine's device),
        then the engine with that (ε, M⁻¹). The warmed chains are not
        handed over: NUTS refreshes the momentum every iteration, so a short
        engine burn-in from fresh inits re-equilibrates."""
        gen = torch.Generator().manual_seed(seed)
        # the warmup runs at nuts_full_warmup's own depth (8), whatever the
        # engine's, as PallasNUTS.from_warmup's does
        _, eps, inv_mass = nuts_full_warmup(dist, gen, min(nbatch, 1024), device=device,
                                            **warmup_kwargs)
        return cls(dist, epsilon=eps, num_leapfrog_steps=max_depth, nbatch=nbatch, seed=seed,
                   device=device, inv_mass=tuple(float(v) for v in inv_mass.reshape(-1)))


@dataclasses.dataclass
class CudaControlHMC(CudaMJHMC):
    """Fused control HMC engine (counterpart of ``PallasControlHMC``), the
    engine-class baseline: partial momentum corruption with ``beta`` (β=1
    is full-refresh HMC), an M-step forward trajectory, Metropolis accept,
    momentum flip on reject. Emissions are post-transition positions with
    weight 1; ``evals`` counts exactly M per iteration (2M two-stage)."""

    beta: float = 0.2
    variant: str = "control"


@dataclasses.dataclass
class CudaMALT(CudaMJHMC):
    """Fused MALT engine (counterpart of ``PallasMALT``): ``beta`` carries
    the friction γ (γ=0 is full-refresh HMC). Emissions are post-transition
    positions with weight 1; ``evals`` counts exactly M per iteration.
    Leapfrog only."""

    beta: float = 1.0  # friction γ
    variant: str = "malt"
