"""Fused MJHMC engine on CUDA (counterpart of ``mjhmc_tpu.ops.pallas_mjhmc``).

One kernel launch runs a whole sampling run: per chain, ``num_steps`` jump
iterations, each integrating the forward and backward M-step leapfrog
trajectories, computing the clipped rates and the dwell weight, choosing
L, F or R by inverse CDF, refreshing momentum by Box-Muller and updating
the backward-energy cache; it accumulates Kahan sums of Σw, Σw·x, Σw·x²
and the exact int32 eval counters. The stream form also emits every
``thin``-th iteration's pre-transition x, dwell weight and cumulative evals.

There are two hand-written CUDA C++ kernels, built by ``ops._build``:
``csrc/mjhmc_engine.cu`` for the elementwise energies (rough well,
Gaussian; one thread per chain) and ``csrc/mjhmc_mm_engine.cu`` for the
matmul energies (product of t, sparse coding; tiles of chains per block,
the parameter matrix in shared memory). Beside them this module holds
their plain PyTorch version (``mjhmc_run_reference`` /
``mjhmc_stream_reference``, one for both kinds) with the same contract. The
wrappers ``cuda_mjhmc_run`` / ``cuda_mjhmc_stream_run`` (elementwise) and
``cuda_mjhmc_mm_run`` / ``cuda_mjhmc_mm_stream_run`` (matmul) launch their
kernel for CUDA tensors and call the plain version for CPU tensors.

The elementwise kernel also runs the NUTS step body (``variant="nuts"``
of ``cuda_mjhmc_run`` / ``cuda_mjhmc_stream_run``, counterpart of
``_make_step_nuts``; plain version ``nuts_run_reference`` /
``nuts_stream_reference``, engine ``CudaNUTS``): per chain a fresh
momentum, up to max_depth doubling rounds with progressive multinomial
sampling and the binary-counter U-turn stack, the post-transition x
emitted with weight 1 and the integrated leaves counted as evals.

Random numbers come from Philox4x32-10 keyed by the run seed with counter
(chain, iteration, slot, tag). MJHMC (tag 0): 1 + 2·d words per iteration
in slots of four (word 0 picks the clock, words 1+i and 1+d+i make dim i's
Box-Muller normal). NUTS keys every draw by its position in the tree: tag 1
holds the momentum's 2·d words (dim i from words i and d+i), tag 2 slot jj
the round's direction (word 0) and merge (word 1) uniforms, tag 3 the leaf
uniform of tree position k = 2^jj − 1 + i as word k % 4 of slot k // 4. The
plain versions compute the same words bit for bit. ``fixed_uniform=True``
makes every uniform 2⁻²⁵ in both, which is what the TPU kernel gives in
Pallas interpret mode, so the CPU tests can hold this engine against it.

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

from mjhmc_tpu_torch.models.base import randn
from mjhmc_tpu_torch.models.gaussian import Gaussian
from mjhmc_tpu_torch.models.product_of_t import ProductOfT
from mjhmc_tpu_torch.models.rough_well import RoughWell
from mjhmc_tpu_torch.models.sparse_coding import SparseCoding
from mjhmc_tpu_torch.samplers.state import MJState

Tensor = torch.Tensor

LOG_RATE_MAX = 25.0
NEG_INF = -1e30
#: the uniform every draw takes in fixed-uniform mode (Pallas interpret mode
#: returns zero bits, and _uniform turns those into 2⁻²⁵)
FIXED_UNIFORM = 2.0**-25
#: state dimensions the elementwise kernel is instantiated for
#: (csrc/mjhmc_engine.cu)
KERNEL_DIMS = (2, 50)
#: deepest tree the NUTS kernel holds a U-turn stack for (csrc/mjhmc_engine.cu)
NUTS_MAX_DEPTH = 10
NUTS_DIV_THRESHOLD = 1000.0
#: Philox counter tags (csrc/philox.cuh)
TAG_NUTS_MOMENTUM, TAG_NUTS_ROUND, TAG_NUTS_LEAF = 1, 2, 3
#: the elementwise kernel's variants (csrc/mjhmc_engine.cu)
KERNEL_VARIANTS = {"mjhmc": 0, "nuts": 1}


# --------------------------------------------------------------------------
# energy specs: an energy id for the kernel, scalar constants, per-dim params
# --------------------------------------------------------------------------
def _sum_dims_in_order(t: Tensor) -> Tensor:
    """Σ over dim −2 row after row, the elementwise kernels' order. Torch's
    reduction rounds in another order from three rows on, and a last-ulp
    difference in an energy or a U-turn dot product changes a NUTS tree."""
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


# matmul energies: the state is (..., d, n) and the parameters are whole
# matrices. On the GPU the forward and backward trajectories are simply
# more columns of the same product, so the TPU's block-diagonal pair
# operands, sublane pads and dot-precision knob have no counterpart here.
def _contract(stub: bool, m: Tensor, b: Tensor) -> Tensor:
    """m @ b; with ``stub`` (the ``stub_dots`` ablation of
    ``MatmulEnergySpec._dot``) 1e-3·(row 0 of b) on each of m's rows, for
    each trajectory on its own (JAX's ``has_pair=False`` form)."""
    if not stub:
        return torch.matmul(m, b)
    row = b[..., :1, :] * torch.tensor(1e-3, dtype=b.dtype, device=b.device)
    return row.expand(*b.shape[:-2], m.shape[-2], b.shape[-1])


@dataclasses.dataclass(frozen=True)
class ProductOfTSpec:
    """y = Wᵀx, g = W·(ν+1)y/(ν+y²), U = ½(ν+1)·Σ log1p(y²/ν)."""

    dist: ProductOfT
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
        y = _contract(self.stub_dots, w.T, x)
        return _contract(self.stub_dots, w, (nu + 1.0) * y / (nu + y * y))

    def u_sum(self, x, w):
        nu = self.dist.nu
        y = _contract(self.stub_dots, w.T, x)
        return 0.5 * (nu + 1.0) * torch.log1p(y * y * (1.0 / nu)).sum(dim=-2)


@dataclasses.dataclass(frozen=True)
class SparseCodingSpec:
    """r = patch − Φa, g = λa/√(a²+ε) − σ⁻²Φᵀr, U = λΣ√(a²+ε) + ½σ⁻²‖r‖²."""

    dist: SparseCoding
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
        return patch[:, None] - _contract(self.stub_dots, phi, a)

    def du(self, a, phi, patch):
        d = self.dist
        s = torch.sqrt(a * a + d.smooth_eps)
        r = self._resid(a, phi, patch)
        return d.lam * (a / s) - (1.0 / d.sigma**2) * _contract(self.stub_dots, phi.T, r)

    def u_sum(self, a, phi, patch):
        d = self.dist
        s = torch.sqrt(a * a + d.smooth_eps)
        r = self._resid(a, phi, patch)
        return d.lam * s.sum(dim=-2) + (0.5 / d.sigma**2) * (r * r).sum(dim=-2)


ELEMENTWISE_SPECS = (RoughWellSpec, GaussianSpec)
MATMUL_SPECS = (ProductOfTSpec, SparseCodingSpec)
#: (ndims, aux rows) the matmul kernel is instantiated for, per spec
#: (csrc/mjhmc_mm_engine.cu): the product_of_t and sparse_coding presets
MM_KERNEL_SHAPES = {ProductOfTSpec: (36, 36), SparseCodingSpec: (128, 64)}

_UNPORTED_ENERGIES = (
    "the engine has the rough_well, gaussian, product_of_t and sparse_coding "
    "energies; LogregSpec (matmul kernel) and the Funnel, Banana, Mog and "
    "EightSchools specs (elementwise kernel) are not ported yet "
    "(ROADMAP.md, 'TPU kernels to port', item 8)"
)


def energy_spec_for(dist):
    if isinstance(dist, RoughWell):
        return RoughWellSpec(dist.scale1, dist.scale2, dist.amplitude)
    if isinstance(dist, Gaussian):
        return GaussianSpec(tuple(float(v) for v in 1.0 / dist.variances))
    if isinstance(dist, ProductOfT):
        return ProductOfTSpec(dist)
    if isinstance(dist, SparseCoding):
        return SparseCodingSpec(dist)
    raise NotImplementedError(
        f"no fused CUDA energy for {type(dist).__name__}: {_UNPORTED_ENERGIES}"
    )


def _check_slice(spec, variant, integrator, inv_mass, kinds):
    """Refuse what the kernels do not cover; ``kinds`` are the spec types
    of the calling wrapper's kernel."""
    if variant not in ("mjhmc", "nuts"):
        raise NotImplementedError(
            f"engine variant {variant!r} is not ported yet "
            "(ROADMAP.md, 'TPU kernels to port', items 3 and 6)"
        )
    if integrator != "leapfrog" or inv_mass is not None:
        raise NotImplementedError(
            "the two-stage integrator and inv_mass are not ported yet "
            "(ROADMAP.md, 'TPU kernels to port', item 4)"
        )
    if not isinstance(spec, ELEMENTWISE_SPECS + MATMUL_SPECS):
        raise NotImplementedError(
            f"no fused CUDA energy for {type(spec).__name__}: {_UNPORTED_ENERGIES}"
        )
    if not isinstance(spec, kinds):
        raise ValueError(
            f"{type(spec).__name__} belongs to the other kernel: elementwise "
            "specs take cuda_mjhmc_run/_stream_run, matmul specs "
            "cuda_mjhmc_mm_run/_stream_run"
        )
    if variant == "nuts" and isinstance(spec, MATMUL_SPECS):
        raise NotImplementedError(
            "the NUTS variant is ported for the elementwise kernel only; NUTS "
            "on the matmul kernel is queued (ROADMAP.md, 'TPU kernels to "
            "port', item 7)"
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


def _uniform_of(words: Tensor) -> Tensor:
    """f32 uniforms in (0, 1) from 32-bit words: top 24 bits × 2⁻²⁴ + 2⁻²⁵."""
    return (words >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25


def philox_block(seed: int, nbatch: int, t: int, slot: int, tag: int, device) -> tuple:
    """The four words (int64 tensors of shape (nbatch,)) of counter
    (chain, t, slot, tag) for every chain."""
    chains = torch.arange(nbatch, dtype=torch.int64, device=device)
    return philox4x32((chains, t, slot, tag), (int(seed) & _MASK32, 0))


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
    return _uniform_of(words[:, :nwords])


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


def _param_tensors(spec, ndims: int, device) -> tuple:
    """The spec's parameters as tensors: a matmul spec's matrices, or an
    elementwise spec's per-dim vector as a (d, 1) column."""
    if isinstance(spec, MATMUL_SPECS):
        arrays = spec.param_arrays()
    else:
        arrays = [spec.param_vector(ndims)[:, None]]
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


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
               num_iters, m, thin, emit, fixed_uniform):
    d, n = x.shape
    dev = x.device
    params = _param_tensors(spec, d, dev)
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
            gs2 = spec.du(xs2, *params)
            vs2 = vh - he * gs2
        us2 = spec.u_sum(xs2, *params)
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


def _logaddexp(a: Tensor, b: Tensor) -> Tensor:
    """jnp.logaddexp: max + log1p(exp(−|Δ|)), or a + b where Δ is NaN."""
    d = a - b
    return torch.where(torch.isnan(d), a + b,
                       torch.maximum(a, b) + torch.log1p(torch.exp(-d.abs())))


def _reference_nuts(spec, x, v, g, u, h_back, back_valid, seed, epsilon, max_depth,
                    num_iters, thin, emit, fixed_uniform):
    """The NUTS step body of ``_make_step_nuts``, vectorised over chains
    with masks as the JAX body is: a round or a leaf runs while any chain
    is live in it, and a chain that is done or stopped keeps its state.
    Sums over dims run in the kernel's order, so its roundings are the
    kernel's at any D."""
    d, n = x.shape
    dev = x.device
    params = _param_tensors(spec, d, dev)
    he = 0.5 * epsilon

    def halfsq(v):
        return 0.5 * _sum_dims_in_order(v * v)

    def cdot(a, b):
        return _sum_dims_in_order(a * b)

    def unif(word):
        return torch.full((n,), FIXED_UNIFORM, device=dev) if fixed_uniform else _uniform_of(word)

    def draw(t, slot, tag):
        if fixed_uniform:
            return (None,) * 4
        return philox_block(seed, n, t, slot, tag, dev)

    w = wc = torch.zeros_like(u)
    wx = wxc = wx2 = wx2c = torch.zeros_like(x)
    evals = torch.zeros(n, dtype=torch.int32, device=dev)
    emits = []
    v0 = v
    for t in range(num_iters):
        if fixed_uniform:
            un = torch.full((2 * d, n), FIXED_UNIFORM, device=dev)
        else:
            words = [wd for b in range((2 * d + 3) // 4)
                     for wd in draw(t, b, TAG_NUTS_MOMENTUM)]
            un = _uniform_of(torch.stack(words[: 2 * d]))
        v0 = torch.sqrt(-2.0 * torch.log(un[:d])) * torch.cos((2.0 * math.pi) * un[d:])
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
                if not bool(act.any()):
                    break
                vh = vc - he * gc
                xn = xc + epsilon * vh
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
                if i == 0 or k % 4 == 0:
                    bits = draw(t, k // 4, TAG_NUTS_LEAF)
                lu = torch.log(unif(bits[k % 4]))
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

        # the post-transition x, weight 1
        evals = evals + nl
        w, wc = _kadd(w, wc, torch.ones_like(u))
        wx, wxc = _kadd(wx, wxc, x)
        wx2, wx2c = _kadd(wx2, wx2c, x * x)
        if emit and (t + 1) % thin == 0:
            emits.append((x, torch.ones_like(u), evals))
    out = RunOut(x, v0, g, u, h_back, back_valid, w, wx, wx2, evals)
    if not emit:
        return out
    if not emits:
        return x.new_empty((0, d, n)), u.new_empty((0, n)), evals.new_empty((0, n)), out
    xs, ws, es = (torch.stack(c) for c in zip(*emits))
    return xs, ws, es, out


def nuts_run_reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                       num_steps, max_depth, fixed_uniform=False):
    """Plain PyTorch version of the NUTS run kernel (``beta`` unused, the
    ``num_leapfrog`` slot is max_depth; any device)."""
    return _reference_nuts(spec, x, v, g, u, h_back, back_valid, seed, epsilon,
                           max_depth, num_steps, 1, False, fixed_uniform)


def nuts_stream_reference(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                          num_emits, thin, max_depth, fixed_uniform=False):
    """Plain PyTorch version of the NUTS stream kernel: (xs (E, d, n) of
    post-transition x, ws (E, n) ones, es (E, n) int32, RunOut)."""
    return _reference_nuts(spec, x, v, g, u, h_back, back_valid, seed, epsilon,
                           max_depth, num_emits * thin, thin, True, fixed_uniform)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------
def _launch(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
            num_iters, m, thin, num_emits, fixed_uniform, variant):
    """Check the state, allocate the outputs and launch the spec's kernel."""
    from mjhmc_tpu_torch.ops import _build

    if x.device.type != "cuda":
        raise ValueError(
            f"the CUDA engine takes cuda tensors (or cpu ones for its plain "
            f"version), not {x.device}"
        )
    if x.dim() != 2:
        raise ValueError(f"x must be (ndims, nbatch), got {tuple(x.shape)}")
    d, n = x.shape
    matmul = isinstance(spec, MATMUL_SPECS)
    if matmul:
        shape = (d, spec.aux_rows())
        if shape != MM_KERNEL_SHAPES[type(spec)]:
            raise NotImplementedError(
                f"the matmul kernel is instantiated for {type(spec).__name__} at "
                f"(ndims, aux rows) = {MM_KERNEL_SHAPES[type(spec)]}, not {shape} "
                "(ROADMAP.md, 'TPU kernels to port', item 5)"
            )
    elif d not in KERNEL_DIMS:
        raise NotImplementedError(
            f"the elementwise kernel is instantiated for ndims in {KERNEL_DIMS}, "
            f"not {d} (ROADMAP.md, 'TPU kernels to port': other D instances of "
            "items 1-2)"
        )
    if n == 0 or thin < 1 or num_iters < 0:
        raise ValueError(f"need nbatch > 0, thin >= 1, steps >= 0 (got {n}, {thin}, {num_iters})")
    if matmul and m < 1:  # the endpoint energies reuse the last step's product
        raise ValueError(f"the matmul kernel needs leapfrog steps >= 1, got {m}")
    if variant == "nuts" and not 1 <= m <= NUTS_MAX_DEPTH:
        raise NotImplementedError(
            f"the NUTS kernel holds trees of max_depth 1..{NUTS_MAX_DEPTH}, not {m}")
    if getattr(spec, "stub_dots", False) and (num_emits is not None
                                              or not isinstance(spec, ProductOfTSpec)):
        raise NotImplementedError(
            "the stub_dots kernel is instantiated for the product-of-t run only, "
            "the roofline dossier's ablation row (its plain version takes any spec)"
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
    lib = _build.load()
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
    tail = (n, num_iters, thin, m, int(seed) & _MASK32, float(epsilon), float(beta),
            int(fixed_uniform),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if matmul:
        params = [t.contiguous() for t in _param_tensors(spec, d, x.device)]
        p0, p1 = (params + [None])[:2]
        rc = lib.mjhmc_mm_engine_launch(
            spec.energy_id, d, spec.aux_rows(), int(spec.stub_dots), p0.data_ptr(),
            None if p1 is None else p1.data_ptr(), *spec.constants(), *ptrs, *tail,
        )
    else:
        params = torch.as_tensor(spec.param_vector(d), device=x.device).contiguous()
        rc = lib.mjhmc_engine_launch(KERNEL_VARIANTS[variant], d, spec.energy_id,
                                     params.data_ptr(), *spec.constants(), *ptrs, *tail)
    if rc != 0:
        kernel = "mjhmc_mm_engine_launch" if matmul else "mjhmc_engine_launch"
        raise RuntimeError(f"{kernel} (variant {variant}) failed: CUDA error {rc}")
    return out, emits


def _count(wrapper, spec, variant) -> None:
    """One launch of the wrapper's kernel: the NUTS kernel counts in
    ``nuts_launches``, the stubbed matmul kernel in ``stub_launches``."""
    if variant == "nuts":
        wrapper.nuts_launches += 1
    elif getattr(spec, "stub_dots", False):
        wrapper.stub_launches += 1
    else:
        wrapper.launches += 1


def _run(wrapper, kinds, spec, x, v, g, u, h_back, back_valid, seed, epsilon,
         beta, num_steps, num_leapfrog, inv_mass, variant, integrator,
         fixed_uniform) -> RunOut:
    _check_slice(spec, variant, integrator, inv_mass, kinds)
    if x.device.type == "cpu":
        ref = nuts_run_reference if variant == "nuts" else mjhmc_run_reference
        return ref(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                   num_steps, num_leapfrog, fixed_uniform)
    out, _ = _launch(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                     num_steps, num_leapfrog, 1, None, fixed_uniform, variant)
    _count(wrapper, spec, variant)
    return out


def _stream_run(wrapper, kinds, spec, x, v, g, u, h_back, back_valid, seed,
                epsilon, beta, num_emits, thin, num_leapfrog, inv_mass, variant,
                integrator, fixed_uniform):
    _check_slice(spec, variant, integrator, inv_mass, kinds)
    if x.device.type == "cpu":
        ref = nuts_stream_reference if variant == "nuts" else mjhmc_stream_reference
        return ref(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                   num_emits, thin, num_leapfrog, fixed_uniform)
    out, (xs, ws, es) = _launch(spec, x, v, g, u, h_back, back_valid, seed,
                                epsilon, beta, num_emits * thin, num_leapfrog,
                                thin, num_emits, fixed_uniform, variant)
    _count(wrapper, spec, variant)
    return xs, ws, es, out


def cuda_mjhmc_run(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                   num_steps, num_leapfrog, *, inv_mass=None, variant="mjhmc",
                   integrator="leapfrog", fixed_uniform=False) -> RunOut:
    """Engine run for the elementwise energies (counterpart of
    ``pallas_mjhmc_run``): ``num_steps`` jump iterations in one launch. CUDA
    tensors launch the kernel; CPU tensors take the plain version.
    ``variant="nuts"`` runs ``num_steps`` NUTS iterations (the NUTS kernel,
    or ``nuts_run_reference`` for CPU tensors): ``beta`` is unused and the
    ``num_leapfrog`` slot is max_depth."""
    return _run(cuda_mjhmc_run, ELEMENTWISE_SPECS, spec, x, v, g, u, h_back,
                back_valid, seed, epsilon, beta, num_steps, num_leapfrog,
                inv_mass, variant, integrator, fixed_uniform)


cuda_mjhmc_run.launches = 0
cuda_mjhmc_run.nuts_launches = 0


def cuda_mjhmc_stream_run(spec, x, v, g, u, h_back, back_valid, seed, epsilon,
                          beta, num_emits, thin, num_leapfrog, *, inv_mass=None,
                          variant="mjhmc", integrator="leapfrog",
                          fixed_uniform=False):
    """Streaming engine run for the elementwise energies (counterpart of
    ``pallas_mjhmc_stream_run``): returns (xs (E, d, n), ws (E, n), es (E, n)
    int32, RunOut). With ``variant="nuts"`` the emissions are every
    ``thin``-th iteration's post-transition x, weight 1 and cumulative leaf
    count."""
    return _stream_run(cuda_mjhmc_stream_run, ELEMENTWISE_SPECS, spec, x, v, g,
                       u, h_back, back_valid, seed, epsilon, beta, num_emits,
                       thin, num_leapfrog, inv_mass, variant, integrator,
                       fixed_uniform)


cuda_mjhmc_stream_run.launches = 0
cuda_mjhmc_stream_run.nuts_launches = 0


def cuda_mjhmc_mm_run(spec, x, v, g, u, h_back, back_valid, seed, epsilon, beta,
                      num_steps, num_leapfrog, *, inv_mass=None, variant="mjhmc",
                      integrator="leapfrog", fixed_uniform=False) -> RunOut:
    """Engine run for the matmul energies (counterpart of
    ``pallas_mjhmc_mm_run``), same contract as ``cuda_mjhmc_run``."""
    return _run(cuda_mjhmc_mm_run, MATMUL_SPECS, spec, x, v, g, u, h_back,
                back_valid, seed, epsilon, beta, num_steps, num_leapfrog,
                inv_mass, variant, integrator, fixed_uniform)


cuda_mjhmc_mm_run.launches = 0
cuda_mjhmc_mm_run.stub_launches = 0


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


cuda_mjhmc_mm_stream_run.launches = 0


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CudaMJHMC:
    """High-throughput MJHMC engine (counterpart of ``PallasMJHMC``).

    Takes any ``nbatch``. Matmul energies (product of t, sparse coding) go
    through the matmul kernel, the others through the elementwise one, as
    ``PallasMJHMC`` picks its kernels. ``device="cpu"`` runs the kernels'
    plain version; ``fixed_uniform`` pins every uniform at 2⁻²⁵ (test mode).
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


@dataclasses.dataclass
class CudaNUTS(CudaMJHMC):
    """Fused NUTS engine (counterpart of ``PallasNUTS``) for the elementwise
    energies: ``num_leapfrog_steps`` is max_depth (default 8, at most
    ``NUTS_MAX_DEPTH``), ``beta`` is unused. Emissions are post-transition
    positions with weight 1; ``evals`` counts the integrated leaves of each
    chain exactly. ``from_warmup`` waits for the adaptation of slice D."""

    beta: float = 0.0  # unused scalar slot
    num_leapfrog_steps: int = 8  # max_depth
    variant: str = "nuts"
