"""Dictionary pretraining for the sparse-coding posterior (counterpart of
``mjhmc_tpu.models.dictionary_learning``).

Learns the dictionary Φ that ``models.sparse_coding.SparseCoding`` loads
by default, and writes it as ``phi_<p>x<b>.npz`` into the port's data
directory (``sparse_coding.DATA_DIR``), or into ``--out``:

    python -m mjhmc_tpu_torch.models.dictionary_learning --npixels 64 --nbasis 128
    python -m mjhmc_tpu_torch.models.dictionary_learning --device cpu --out /tmp/phi --steps 40 --batch 64

Training data: seeded synthetic patches with a 1/f amplitude spectrum
(white complex noise shaped in the Fourier domain, inverse-transformed,
per-patch centred and scaled to unit std), made on the device inside the
loop. Learner: the Olshausen-Field alternation on

    E(a, Φ) = λ Σ|a| + ½σ⁻² ‖x − Φa‖²

fixed-count ISTA on the codes a (step 1/L, L = σ⁻²·λmax(ΦᵀΦ) by power
iteration with a 10% margin), then a gradient step on Φ from the residual,
columns renormalised to unit norm every step. JAX runs the loop as one
jitted scan of plain XLA (no Pallas kernel); here it is plain PyTorch
(``torch.matmul``, ``torch.fft``) on an explicit device, run eagerly,
reading nothing back to the host inside the loop.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from mjhmc_tpu_torch.models.base import randn
from mjhmc_tpu_torch.models.sparse_coding import DATA_DIR, _phi_path, load_pretrained

Tensor = torch.Tensor

__all__ = ["DATA_DIR", "DictLearnOut", "ista_codes", "learn_dictionary", "load_pretrained",
           "main", "natural_patches", "save_pretrained"]


# ---------------------------------------------------------------------------
# 1/f natural-image-statistics patches
# ---------------------------------------------------------------------------
def natural_patches(generator: torch.Generator | None, n: int, side: int, alpha: float = 1.0,
                    *, device, noise: Tensor | None = None) -> Tensor:
    """(side², n) float32 patches with a 1/f^alpha amplitude spectrum.
    ``noise``: the complex draws (n, side, side) (real and imaginary parts
    standard normal); None draws them from ``generator``, real parts first
    (JAX's ``kr``, ``ki``)."""
    if noise is None:
        noise = torch.complex(randn(generator, (n, side, side), device),
                              randn(generator, (n, side, side), device))
    noise = noise.to(device=device, dtype=torch.complex64)
    fx = torch.fft.fftfreq(side, device=device, dtype=torch.float32)
    rad = torch.sqrt(fx[:, None] ** 2 + fx[None, :] ** 2)
    amp = torch.where(rad > 0, 1.0 / torch.clamp(rad, min=1e-6) ** alpha,
                      torch.zeros((), device=device))
    img = torch.fft.ifft2(noise * amp[None]).real  # (n, side, side)
    img = img - img.mean(dim=(1, 2), keepdim=True)
    img = img / (img.std(dim=(1, 2), keepdim=True, unbiased=False) + 1e-8)
    return img.reshape(n, side * side).T.contiguous().to(torch.float32)  # (p, n)


# ---------------------------------------------------------------------------
# ISTA inner loop + dictionary outer loop
# ---------------------------------------------------------------------------
def _soft(a: Tensor, t: Tensor) -> Tensor:
    return torch.sign(a) * torch.clamp(a.abs() - t, min=0.0)


def _lambda_max(phi: Tensor, iters: int = 8) -> Tensor:
    """λmax(ΦᵀΦ) by power iteration (the Frobenius bound is ~b/λmax× too
    loose for an overcomplete unit-norm Φ, which stalls fixed-count ISTA)."""
    b = phi.shape[1]
    v = torch.ones((b,), dtype=torch.float32, device=phi.device) / np.float32(np.sqrt(b))
    for _ in range(iters):
        w = phi.T @ (phi @ v)
        v = w / (torch.linalg.vector_norm(w) + 1e-12)
    return torch.dot(v, phi.T @ (phi @ v))


def ista_codes(phi: Tensor, x: Tensor, lam: float, sigma: float, num_iters: int) -> Tensor:
    """Sparse codes minimising λ‖a‖₁ + ½σ⁻²‖x − Φa‖² (fixed-count ISTA),
    step size 1/L with L = σ⁻²·λmax(ΦᵀΦ) (power-iterated, 10% margin)."""
    lstep = (sigma ** 2) / (1.1 * _lambda_max(phi))
    a = torch.zeros((phi.shape[1], x.shape[1]), dtype=torch.float32, device=phi.device)
    for _ in range(num_iters):
        resid = x - phi @ a
        a = _soft(a + lstep / (sigma ** 2) * (phi.T @ resid), lstep * lam)
    return a


class DictLearnOut(NamedTuple):
    phi: Tensor  # (npixels, nbasis), unit-norm columns
    recon_err: Tensor  # (num_steps,) mean ‖x−Φa‖²/p per step
    code_l0: Tensor  # (num_steps,) mean active fraction of a


def learn_dictionary(generator: torch.Generator | None, npixels: int = 64, nbasis: int = 128,
                     num_steps: int = 400, batch: int = 256, lam: float = 8.0,
                     sigma: float = 0.316, lr: float = 1.5, ista_iters: int = 40,
                     alpha: float = 1.0, *, device,
                     patches: Callable[[int], Tensor] | Tensor | None = None,
                     phi0: Tensor | None = None) -> DictLearnOut:
    """Olshausen-Field alternating minimisation on ``device``.

    λ/σ are the learning hyperparameters: the activation threshold of a
    unit-norm atom is ≈ λσ² (≈ 0.5 at the defaults), giving ~5-15% active
    codes on unit-std patches; the posterior's λ/σ live on SparseCoding.
    ``phi0`` (npixels, nbasis) replaces the seeded normal start (it is
    normalised as that is); ``patches`` supplies each step's x: a callable
    of the step, or a (num_steps, npixels, batch) stack. Without them both
    come from ``generator``: Φ₀ first, then each step's noise."""
    side = int(round(math.sqrt(npixels)))
    if side * side != npixels:
        raise ValueError(f"npixels must be a perfect square, got {npixels}")
    if phi0 is None:
        phi0 = randn(generator, (npixels, nbasis), device)
    phi = phi0.to(device=device, dtype=torch.float32)
    phi = phi / torch.linalg.vector_norm(phi, dim=0, keepdim=True)
    errs, l0s = [], []
    for step in range(num_steps):
        if patches is None:
            x = natural_patches(generator, batch, side, alpha, device=device)
        elif callable(patches):
            x = patches(step)
        else:
            x = patches[step]
        x = x.to(device=device, dtype=torch.float32)
        a = ista_codes(phi, x, lam, sigma, ista_iters)
        resid = x - phi @ a  # (p, batch)
        # gradient ascent on the reconstruction: Φ += η residual aᵀ / batch
        phi = phi + (lr / batch) * (resid @ a.T)
        phi = phi / (torch.linalg.vector_norm(phi, dim=0, keepdim=True) + 1e-8)
        errs.append((resid * resid).sum(dim=0).mean() / npixels)
        l0s.append((a.abs() > 1e-6).float().mean())
    empty = torch.zeros((0,), dtype=torch.float32, device=device)
    return DictLearnOut(phi, torch.stack(errs) if errs else empty,
                        torch.stack(l0s) if l0s else empty)


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------
def save_pretrained(phi, meta: dict | None = None, out_dir=None) -> str:
    """Write Φ (and ``meta_<key>`` entries) as ``phi_<p>x<b>.npz`` into
    ``out_dir`` (default the port's ``DATA_DIR``); returns the path."""
    phi = np.asarray(phi.detach().cpu() if isinstance(phi, Tensor) else phi, np.float32)
    p, b = phi.shape
    path = _phi_path(p, b, out_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, phi=phi, **{f"meta_{k}": v for k, v in (meta or {}).items()})
    return str(path)


def main(argv=None) -> int:
    """Pretrain a dictionary and write it; prints one JSON line."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--npixels", type=int, default=64)
    ap.add_argument("--nbasis", type=int, default=128)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help=f"directory of the .npz (default {DATA_DIR})")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the learner runs on the card unless --device cpu")
    device = torch.device(a.device)
    gen = torch.Generator(device=device).manual_seed(a.seed)
    out = learn_dictionary(gen, npixels=a.npixels, nbasis=a.nbasis, num_steps=a.steps,
                           batch=a.batch, device=device)
    errs, l0s = out.recon_err.cpu().tolist(), out.code_l0.cpu().tolist()
    path = save_pretrained(out.phi, {"seed": a.seed, "steps": a.steps,
                                     "final_recon_err": errs[-1], "final_code_l0": l0s[-1]},
                           a.out)
    print(json.dumps({"path": path, "recon_err_first": errs[0], "recon_err_last": errs[-1],
                      "code_l0_last": l0s[-1], "device": str(device)}))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
