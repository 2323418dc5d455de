"""Explicit collectives of the chain-sharded runtime (counterpart of
``mjhmc_tpu.parallel.collectives``).

Each rank holds a block of the chains (``parallel.mesh``); these are the
cross-chain reductions, issued with ``torch.distributed`` over the mesh's
``chains`` group, outside any sampling loop:

- ``sharded_moments``: one all_reduce of the 2d+1 dwell-weighted sums;
- ``chain_mean``: one all_reduce of a sum and a count (the adaptation's
  acceptance mean);
- ``distributed_systematic_resample``: an all_gather of the (small)
  weight vector, the global inversion, then a ring that moves particle
  blocks only as far as ancestors travel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mjhmc_tpu_torch.inference.smc import resample_positions

Tensor = torch.Tensor


def sharded_moments(x: Tensor, w: Tensor, mesh) -> tuple:
    """Dwell-weighted (mean, var) over ALL chains of a sharded batch.

    x: (d, n/P) and w: (n/P,), this rank's block. Returns the (d,) mean and
    var, equal on every rank. One all_reduce of 2d+1 sums (Σw, Σwx, Σwx²).
    """
    d = x.shape[0]
    sums = torch.cat([w.sum()[None], (w * x).sum(dim=1), (w * x * x).sum(dim=1)])
    dist.all_reduce(sums, group=mesh.group())
    sw, swx, swx2 = sums[0], sums[1:1 + d], sums[1 + d:]
    mean = swx / sw
    return mean, swx2 / sw - mean * mean


def chain_mean(t: Tensor, mesh) -> Tensor:
    """Mean of a per-chain (n/P,) block over all chains: one all_reduce."""
    s = torch.stack([t.sum(), torch.tensor(float(t.numel()), dtype=t.dtype, device=t.device)])
    dist.all_reduce(s, group=mesh.group())
    return s[0] / s[1]


def distributed_systematic_resample(x: Tensor, log_w: Tensor, u0, mesh) -> Tensor:
    """Systematic resampling across ranks WITHOUT gathering the particles.

    x: (d, n/P) and log_w: (n/P,), this rank's block; ``u0`` ~ U(0, 1/n),
    the same on every rank. Returns this rank's (d, n/P) block of
    ``inference.smc.systematic_resample(x_global, log_w_global, u0)``, bit
    for bit.

    1. all_gather the log-WEIGHTS only (n floats); every rank computes the
       same global CDF and the ancestor of each of ITS OWN output slots.
    2. a ring over the (d, n/P) blocks: at hop r every rank holds rank
       (me + r) mod P's block and copies whichever of its still-missing
       ancestors live there; an all_reduced remaining count ends the ring
       as soon as every rank is satisfied.

    Per-rank memory is O(n·d/P + n), never a state-sized all_gather.
    """
    group, p, me = mesh.group(), mesh.size(), mesh.axis_index()
    n_local = x.shape[1]
    n = n_local * p
    parts = [torch.empty_like(log_w) for _ in range(p)]
    dist.all_gather(parts, log_w.contiguous(), group=group)
    slots = me * n_local + torch.arange(n_local, device=x.device)
    cdf, pos = resample_positions(torch.cat(parts), u0, slots)
    anc = torch.searchsorted(cdf, pos).clamp(0, n - 1)
    src = anc // n_local
    local_idx = anc - src * n_local
    # hop r: receive from the next rank, send to the previous one
    nxt = dist.get_global_rank(group, (me + 1) % p)
    prv = dist.get_global_rank(group, (me - 1) % p)

    buf, out = x.contiguous(), torch.zeros_like(x)
    remaining = torch.ones(n_local, dtype=torch.bool, device=x.device)
    for r in range(p):
        take = remaining & (src == (me + r) % p)
        out = torch.where(take[None, :], buf[:, local_idx], out)
        remaining = remaining & ~take
        left = remaining.sum(dtype=torch.int64)
        dist.all_reduce(left, group=group)
        if int(left) == 0 or r == p - 1:
            break
        recv = torch.empty_like(buf)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, prv, group),
                                           dist.P2POp(dist.irecv, recv, nxt, group)]):
            req.wait()
        buf = recv
    return out
