"""Ceiling probes of the roofline dossier (counterparts of the Pallas
microkernels in the root ``bench_mfu.py``).

Two hand-written CUDA C++ kernels, ``csrc/ceilings.cu``, built by
``ops._build``, each with its plain PyTorch version beside it:

- ``fma_chain(a, b, iters, transcendental)`` (``measure_vpu_ceiling``'s
  kernel): four chains per element of a (rows, lanes) f32 block, started
  at b·0.2(i+1); each iteration is x <- x·a + b, or x <- sin(x)·a + b.
- ``tc_chain(w, b, iters)`` (``measure_mxu_ceiling``'s kernel): four chains
  started at b + i; each iteration is b <- (W·b)·(1/depth), the product in
  one bf16 pass with f32 accumulation (both operands rounded to bf16).

Each returns the sum of its four chains, so the kernel can be held against
the plain version. CUDA tensors launch the kernel (and count it in the
wrapper's ``launches``); CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mjhmc_tpu_torch.ops.cuda_mjhmc import _full_f32_matmul

Tensor = torch.Tensor
#: independent chains per element, as the JAX probes' ``ilp``
CHAINS = 4
#: largest contraction depth ``tc_chain``'s kernel is instantiated for
TC_MAX_DEPTH = 128


def _stream(t: Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(name: str, t: Tensor, shape, device) -> None:
    if (t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 {tuple(shape)} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _cuda_only(t: Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} takes cuda tensors (or cpu ones for its plain "
                         f"version), not {t.device}")


# --------------------------------------------------------------------------
# FP32 FMA / sinf chain
# --------------------------------------------------------------------------
def fma_chain_reference(a: Tensor, b: Tensor, iters: int,
                        transcendental: bool = False) -> Tensor:
    """Plain PyTorch version of ``fma_chain`` (any device)."""
    xs = [b * np.float32(0.2 * (i + 1)) for i in range(CHAINS)]
    for _ in range(iters):
        xs = [(torch.sin(x) if transcendental else x) * a + b for x in xs]
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def fma_chain(a: Tensor, b: Tensor, iters: int, transcendental: bool = False) -> Tensor:
    """Chained FMA (or sin then FMA) probe; returns the sum of the chains."""
    if a.device.type == "cpu":
        return fma_chain_reference(a, b, iters, transcendental)
    from mjhmc_tpu_torch.ops import _build

    _cuda_only(a, "fma_chain")
    _check("a", a, a.shape, a.device)
    _check("b", b, a.shape, a.device)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    out = torch.empty_like(a)
    rc = _build.load().fma_chain_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                        a.numel(), int(iters), int(transcendental),
                                        _stream(a))
    if rc != 0:
        raise RuntimeError(f"fma_chain_launch failed: CUDA error {rc}")
    fma_chain.launches += 1
    return out


fma_chain.launches = 0


# --------------------------------------------------------------------------
# bf16 tensor-core chain
# --------------------------------------------------------------------------
def tc_scale(depth: int) -> float:
    """The chain's f32 scale 1/depth, as the JAX probe's ``c``."""
    return float(np.float32(1.0 / depth))


def tc_flops_per_iteration(depth: int, lanes: int) -> float:
    """FLOPs of one iteration as the JAX probe counts them: 2·depth²·lanes
    per chain, the unpadded depth."""
    return 2.0 * depth * depth * lanes * CHAINS


@_full_f32_matmul()
def tc_chain_reference(w: Tensor, b: Tensor, iters: int) -> Tensor:
    """Plain PyTorch version of ``tc_chain`` (any device): operands rounded
    to bf16, the product in f32 (TF32 off on the card)."""
    c = tc_scale(w.shape[0])
    wb = w.bfloat16().float()
    xs = [b + float(i) for i in range(CHAINS)]
    for _ in range(iters):
        xs = [torch.matmul(wb, x.bfloat16().float()) * c for x in xs]
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def tc_chain(w: Tensor, b: Tensor, iters: int) -> Tensor:
    """Chained bf16 ``mma.sync`` probe; returns the sum of the chains.
    ``w`` is (depth, depth) with depth <= 128, ``b`` (depth, lanes) with
    lanes a multiple of 32, ``iters`` >= 1."""
    if w.device.type == "cpu":
        return tc_chain_reference(w, b, iters)
    from mjhmc_tpu_torch.ops import _build

    _cuda_only(w, "tc_chain")
    depth = w.shape[0]
    if w.dim() != 2 or b.dim() != 2 or not 0 < depth <= TC_MAX_DEPTH:
        raise ValueError(f"need w (depth, depth) with depth <= {TC_MAX_DEPTH} and b "
                         f"(depth, lanes), got {tuple(w.shape)} and {tuple(b.shape)}")
    lanes = b.shape[1]
    if lanes % 32 or iters < 1:
        raise ValueError(f"need lanes % 32 == 0 and iters >= 1, got {lanes}, {iters}")
    _check("w", w, (depth, depth), w.device)
    _check("b", b, (depth, lanes), w.device)
    out = torch.empty_like(b)
    rc = _build.load().tc_chain_launch(w.data_ptr(), b.data_ptr(), out.data_ptr(), depth,
                                       lanes, int(iters), tc_scale(depth), _stream(w))
    if rc != 0:
        raise RuntimeError(f"tc_chain_launch failed: CUDA error {rc}")
    tc_chain.launches += 1
    return out


tc_chain.launches = 0


def tc_chain_lanes(depth: int) -> int:
    """Lanes that fill the current card with resident ``tc_chain`` blocks at
    this depth (SMs × blocks per SM × lanes per block, rounded down to the
    wrapper's multiple of 32)."""
    from mjhmc_tpu_torch.ops import _build

    lanes = _build.load().tc_chain_lanes(depth)
    if lanes < 32:
        raise RuntimeError(f"tc_chain_lanes({depth}) failed: {lanes}")
    return lanes // 32 * 32
