"""Model-axis sharding of the sparse-coding energy (counterpart of
``mjhmc_tpu.parallel.model_parallel``).

U(a) = λ·Σ smooth_l1(a) + ½σ⁻²‖x − Φa‖². When Φ (npixels × nbasis)
outgrows one device, the basis axis splits over the ``model`` axis of a
("chains", "model") mesh, the analogue of tensor parallelism:

- each rank holds a column block Φ_s and the matching coefficient rows
  a_s; the partial product Φ_s a_s and the sparsity sum are added over the
  ``model`` group in one all_reduce per energy evaluation, giving the
  shared residual;
- the fit gradient −σ⁻² Φ_sᵀ r and the sparsity gradient are then local.

The contraction is plain ``torch.matmul``: in JAX it is outside any Pallas
kernel, left to XLA. The samplers' own sums over the dims (kinetic
energies, NUTS's U-turn products) go through ``sum_dims``, which adds the
ranks' partial sums the same way; JAX's GSPMD inserts those reductions by
itself.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from mjhmc_tpu_torch.models.sparse_coding import SparseCoding
from mjhmc_tpu_torch.parallel.mesh import ChainMesh, chain_sharding

Tensor = torch.Tensor


def _basis_rows(dist: SparseCoding, mesh: ChainMesh) -> slice:
    q, m = mesh.size("model"), mesh.axis_index("model")
    if dist.nbasis % q:
        raise ValueError(f"nbasis {dist.nbasis} does not split over {q} model ranks")
    b = dist.nbasis // q
    return slice(m * b, (m + 1) * b)


def model_sharded_potential_and_grad(dist: SparseCoding, mesh: ChainMesh):
    """Returns pg(a) = (U, dU/da) for this rank's block ``a``: its basis
    rows on the ``model`` axis and its chains on the ``chains`` axis,
    (..., nbasis/Q, n/P). U is the whole energy of each chain, equal on
    the ranks of a ``model`` group; the gradient is the rank's rows."""
    group = mesh.group("model")
    rows = _basis_rows(dist, mesh)
    inv_sig2 = 1.0 / dist.sigma**2
    lam, seps = dist.lam, dist.smooth_eps
    cache = {}

    def potential_and_grad(a: Tensor):
        if a.device not in cache:
            phi = torch.as_tensor(dist._phi, device=a.device)
            cache[a.device] = (phi[:, rows].contiguous(),
                               torch.as_tensor(dist.patch_array(), device=a.device)[:, None])
        phi_s, patch = cache[a.device]
        s = torch.sqrt(a * a + seps)
        # partial reconstruction and sparsity sum, added over the basis blocks
        part = torch.cat([torch.matmul(phi_s, a), (lam * s.sum(dim=-2)).unsqueeze(-2)], dim=-2)
        tdist.all_reduce(part, group=group)
        resid = patch - part[..., :-1, :]
        u = part[..., -1, :] + 0.5 * inv_sig2 * (resid * resid).sum(dim=-2)
        g = lam * (a / s) - inv_sig2 * torch.matmul(phi_s.T, resid)
        return u, g

    return potential_and_grad


class ModelShardedSparseCoding:
    """Distribution adapter: SparseCoding with the basis axis sharded.

    Drop-in for the plain samplers on a ("chains", "model") mesh: the same
    ``potential_and_grad`` contract on this rank's (nbasis/Q, n/P) block,
    and ``sum_dims``, the hook every sum over the dims of the samplers
    goes through (``models.base.sum_dims``).
    """

    def __init__(self, dist: SparseCoding, mesh: ChainMesh):
        self._dist = dist
        self._mesh = mesh
        self._pg = model_sharded_potential_and_grad(dist, mesh)
        self.rows = _basis_rows(dist, mesh)
        self.ndims = dist.ndims
        self.name = dist.name + "_model_sharded"

    def potential_and_grad(self, a: Tensor):
        return self._pg(a)

    def potential(self, a: Tensor) -> Tensor:
        return self._pg(a)[0]

    def logdensity(self, a: Tensor) -> Tensor:
        return -self.potential(a)

    def sum_dims(self, t: Tensor) -> Tensor:
        """Σ over the dims (−2) of a rank's rows, added over the model group."""
        s = t.sum(dim=-2)
        tdist.all_reduce(s, group=self._mesh.group("model"))
        return s

    def init_x(self, generator: torch.Generator, nbatch: int, device="cpu") -> Tensor:
        """This rank's block of the global (nbasis, nbatch) initial state."""
        x = self._dist.init_x(generator, nbatch, device)
        return x[self.rows, chain_sharding(self._mesh, nbatch)].contiguous()

    def stable_hash(self) -> str:
        return self._dist.stable_hash() + "_msharded"
