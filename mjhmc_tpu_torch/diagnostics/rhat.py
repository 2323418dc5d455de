"""Split-R̂ convergence diagnostic, Gelman–Rubin potential scale reduction
(counterpart of ``mjhmc_tpu.diagnostics.rhat``).

Split-chain R̂ per dimension, with a dwell-weighted variant so MJHMC's
Rao-Blackwellized streams are diagnosed on the correctly weighted
posterior rather than the raw jump-chain occupation. Every reduction is a
plain sum over the time and chain axes, on the samples' device.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def potential_scale_reduction(x: Tensor, w: Tensor | None = None) -> Tensor:
    """Split-R̂ per dimension.

    Args:
      x: samples, (T, ndims, nbatch), time-leading, chains last.
      w: optional Rao-Blackwell dwell weights (T, nbatch).

    Returns:
      (ndims,) split-R̂; ≈1 at convergence, ≫1 when chains disagree.

    Each chain is split in half (2·nbatch half-chains). With weights, the
    half-chain means and variances are dwell-weighted and each half-chain's
    effective length is the chain-averaged Kish ratio (Σw)²/Σw², which is
    T/2 for uniform weights.
    """
    t, ndims, nbatch = x.shape
    th = t // 2
    if th < 2:
        raise ValueError("need at least 4 samples per chain for split-R̂")
    # (th, ndims, 2·nbatch): the halves stacked on the chain axis
    xs = torch.cat([x[:th], x[th : 2 * th]], dim=-1)
    if w is None:
        ws = torch.ones((th, 2 * nbatch), dtype=x.dtype, device=x.device)
    else:
        ws = torch.cat([w[:th], w[th : 2 * th]], dim=-1)
    wb = ws[:, None, :]

    wsum = wb.sum(dim=0)  # (1, 2n): each half-chain's weight mass
    mean_j = (wb * xs).sum(dim=0) / wsum  # (ndims, 2n)
    var_j = (wb * (xs - mean_j[None]) ** 2).sum(dim=0) / wsum

    # within-chain variance, weighted by chain mass
    w_chain = wsum[0]  # (2n,)
    w_tot = w_chain.sum()
    w_var = (var_j * w_chain[None, :]).sum(dim=1) / w_tot  # (ndims,)

    # between-chain variance of the half-chain means
    grand = (mean_j * w_chain[None, :]).sum(dim=1) / w_tot
    b_var = (w_chain[None, :] * (mean_j - grand[:, None]) ** 2).sum(dim=1) / w_tot

    # effective per-chain length: the chain-averaged Kish ESS of the weights
    n_eff = ws.sum(dim=0).mean() ** 2 / (ws * ws).sum(dim=0).mean()

    var_plus = (n_eff - 1.0) / n_eff * w_var + b_var
    return torch.sqrt(var_plus / w_var.clamp(min=1e-30))
