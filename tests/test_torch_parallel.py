"""The chain-sharded runtime in one process: a world-size-1 gloo group on
the CPU, and meshes made by hand for another rank's view.

- ``sharded_cuda_mjhmc_run`` (plain version, ``fixed_uniform=True``) on
  ``make_chain_mesh(1)`` against JAX's ``sharded_pallas_mjhmc_run`` in
  interpret mode on ``make_chain_mesh(1)``, rough well and sparse coding,
  by ``test_torch_engine.py``'s rules; in Philox mode the rank's offset
  seed (rank 1 through a hand-made mesh: the function communicates
  nothing, so no group is needed) and its int32 wrap.
- the mesh, ``chain_sharding`` and ``shard_chain_pytree``.
- ``systematic_resample`` against JAX's at JAX's own u0 on every slot
  except those whose position lies within 4 ulp of a CDF step (counted and
  reported), and the ring resample at world size 1.
- the collectives counted: none in the engine, one gather after sharded
  NUTS, one all_reduce per adaptive iteration, one in ``sharded_moments``.
- the ``sum_dims`` hook the samplers sum over dims with.
The several-rank cases are in ``test_torch_multiprocess.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mjhmc_tpu.inference.smc import systematic_resample as jax_systematic_resample
from mjhmc_tpu_torch.inference.smc import systematic_resample
from mjhmc_tpu_torch.models import Gaussian, RoughWell
from mjhmc_tpu_torch.models.base import sum_dims
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm
from mjhmc_tpu_torch.parallel.collectives import (
    distributed_systematic_resample,
    sharded_moments,
)
from mjhmc_tpu_torch.parallel.mesh import (
    ChainMesh,
    chain_sharding,
    make_chain_mesh,
    shard_chain_pytree,
)
from mjhmc_tpu_torch.parallel.multihost import free_port, initialize
from mjhmc_tpu_torch.samplers import MarkovJumpHMC, adaptive_mjhmc_run, da_init
from mjhmc_tpu_torch.samplers.nuts import make_nuts_state, sharded_nuts_run
from mjhmc_tpu_torch.samplers.state import make_mj_state
from test_torch_multiprocess import (
    CASES,
    SEED,
    STEPS,
    counting_collectives,
    hold_against_jax,
    jax_sharded,
    port_inputs,
    port_spec,
    resample_particles,
    resample_patterns,
)

torch.set_num_threads(1)


@pytest.fixture
def mesh1():
    """A world-size-1 gloo group and its ("chains",) mesh, torn down after."""
    info = initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    assert info["initialized"] and info["backend"] == "gloo"
    try:
        yield make_chain_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def rank_mesh(rank, size):
    """Rank ``rank``'s view of a ("chains",) mesh of ``size``, without a
    group (for calls that communicate nothing)."""
    return ChainMesh({"chains": size}, {"chains": rank}, {"chains": None}, torch.device("cpu"))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("steps", STEPS)
def test_world1_matches_jax_sharded_kernel(mesh1, name, steps):
    _, eps, beta, m = CASES[name]
    (st,) = port_inputs(name, 1)
    with counting_collectives() as calls:
        out = cm.sharded_cuda_mjhmc_run(mesh1, port_spec(name), *st, SEED, eps, beta, steps, m,
                                        fixed_uniform=True)
    assert calls == []
    hold_against_jax([out._asdict()], jax_sharded(name, 1, steps), steps,
                     f"{name} after {steps}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_seed_offset_and_wrap(name):
    """Rank r runs at seed + r·131071 wrapped to int32: bit-equal to a
    direct call there, and not to the call without the offset."""
    _, eps, beta, m = CASES[name]
    (st,) = port_inputs(name, 1)
    spec = port_spec(name)
    for seed in (12345, 2**31 - 1):
        got = cm.sharded_cuda_mjhmc_run(rank_mesh(1, 2), spec, *st, seed, eps, beta, 3, m)
        want = cm.run_reference(spec, *st, cm.rank_seed(seed, 1), eps, beta, 3, m)
        same = cm.run_reference(spec, *st, seed + 131071, eps, beta, 3, m)  # unwrapped
        other = cm.run_reference(spec, *st, seed, eps, beta, 3, m)
        for a, b, c in zip(got, want, same):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert not torch.equal(got.evals, other.evals) or not torch.equal(got.x, other.x)
    assert cm.rank_seed(2**31 - 1, 1) == 2**31 - 1 + 131071 - 2**32 < 0
    assert cm.rank_seed(5, 0) == 5 and cm.rank_seed(-3, 2) == 2 * 131071 - 3


def test_sharded_engine_counts_only_card_launches():
    (st,) = port_inputs("rough_well", 1)
    cm.reset_counts()
    cm.sharded_cuda_mjhmc_run(rank_mesh(0, 1), port_spec("rough_well"), *st, 1, 1.0, 0.1, 2, 10)
    assert cm.cuda_mjhmc_run.sharded_launches == 0 == cm.cuda_mjhmc_run.launches


def test_mesh_and_chain_blocks(mesh1):
    assert mesh1.shape == {"chains": 1} and mesh1.axis_index() == 0
    assert mesh1.device == torch.device("cpu")
    with pytest.raises(ValueError):
        make_chain_mesh(2, device="cpu")
    assert chain_sharding(mesh1, 64) == slice(0, 64)
    assert chain_sharding(rank_mesh(3, 8), 64) == slice(24, 32)
    with pytest.raises(ValueError):
        chain_sharding(rank_mesh(0, 8), 60)
    assert mesh1.block(2, 64) == (2, 64, slice(0, 2), slice(0, 64))


def test_shard_chain_pytree_keeps_blocks_and_replicates_the_rest():
    st = make_mj_state(Gaussian(ndims=4, log_conditioning=1.0), torch.Generator().manual_seed(0),
                       128)
    tree = {"state": st, "mass": torch.ones(3), "step": 7}
    out = shard_chain_pytree(tree, rank_mesh(1, 2))
    assert torch.equal(out["state"].chain.x, st.chain.x[:, 64:])
    assert out["state"].h_back.shape == (64,) and out["state"].chain.x.is_contiguous()
    assert torch.equal(out["mass"], tree["mass"]) and out["step"] == 7


def test_systematic_resample_matches_jax_at_its_u0():
    """The port's inversion at JAX's u0 picks JAX's ancestor on every slot
    but those whose position lies within 4 ulp of a CDF step (XLA and torch
    sum the CDF in other orders); those are counted and reported."""
    n, key = 128, jax.random.key(5)
    x = resample_particles(n)
    exempt_total = 0
    for name, lw in resample_patterns(n).items():
        ref = np.asarray(jax_systematic_resample(key, jnp.asarray(x), jnp.asarray(lw)))
        u0 = float(jax.random.uniform(key, (), jnp.float32, 0.0, 1.0 / n))
        got = systematic_resample(torch.as_tensor(x), torch.as_tensor(lw), u0).numpy()
        lw_t = torch.as_tensor(lw)
        cdf = torch.cumsum(torch.exp(lw_t - torch.logsumexp(lw_t, 0)), 0).numpy()
        pos = np.float32(u0) + np.arange(n, dtype=np.float32) / np.float32(n)
        near = (np.abs(pos[:, None] - cdf[None, :]) <= 4 * np.spacing(pos)[:, None]).any(1)
        differ = (got != ref).any(axis=0)
        assert not (differ & ~near).any(), f"{name}: slots {np.flatnonzero(differ & ~near)}"
        exempt_total += int(near.sum())
    print(f"slots within 4 ulp of a CDF step (exempt): {exempt_total} of {5 * n}")
    assert exempt_total <= 5 * n // 20


@pytest.mark.parametrize("pattern", sorted(resample_patterns()))
def test_world1_ring_resample_equals_dense(mesh1, pattern):
    x, lw = resample_particles(), resample_patterns()[pattern]
    u0 = 0.37 / x.shape[1]
    with counting_collectives() as calls:
        got = distributed_systematic_resample(torch.as_tensor(x), torch.as_tensor(lw), u0, mesh1)
    assert torch.equal(got, systematic_resample(torch.as_tensor(x), torch.as_tensor(lw), u0))
    assert calls == ["all_gather", "all_reduce"]  # one hop: every ancestor is local


def test_world1_sharded_moments_match_dense(mesh1):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    with counting_collectives() as calls:
        mean, var = sharded_moments(torch.as_tensor(x), torch.as_tensor(w), mesh1)
    assert calls == ["all_reduce"]
    xd, wd = x.astype(np.float64), w.astype(np.float64)
    m_ref = (wd * xd).sum(axis=1) / wd.sum()
    np.testing.assert_allclose(mean.numpy(), m_ref, rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), (wd * xd**2).sum(axis=1) / wd.sum() - m_ref**2,
                               rtol=1e-4)


def test_world1_adaptive_run_one_all_reduce_per_iteration(mesh1):
    rw = RoughWell(ndims=2)
    st = make_mj_state(rw, torch.Generator().manual_seed(3), 128)
    with counting_collectives() as calls:
        _, da, aux = adaptive_mjhmc_run(rw, st, da_init(1.0), torch.Generator().manual_seed(4), 5,
                                        0.1, 5, mesh=mesh1)
    assert calls == ["all_reduce"] * 5 and da.step == 5
    assert np.isfinite(aux["eps_trace"].numpy()).all() and (aux["moments"].w > 0).all()
    _, da_d, _ = adaptive_mjhmc_run(rw, st, da_init(1.0), torch.Generator().manual_seed(4), 5,
                                    0.1, 5)
    np.testing.assert_allclose(da.log_eps, da_d.log_eps, rtol=1e-5)


def test_world1_sharded_nuts(mesh1):
    """tests/test_collectives.py's sharded-NUTS checks at world size 1: no
    collective in the run, the counters' one gather after it."""
    dist_ = Gaussian(ndims=2, log_conditioning=1.0)
    n, steps, max_depth = 128, 4, 4
    st = make_nuts_state(dist_, torch.Generator().manual_seed(0), n)
    with counting_collectives() as calls:
        st, outs = sharded_nuts_run(mesh1, dist_, st, 1, steps, 0.5, max_depth)
    assert calls == ["all_gather"]
    assert outs["x"].shape == (steps, 2, n) and outs["depth"].shape == (steps, n)
    ev = st.grad_evals.numpy()
    assert ev.min() >= steps and ev.max() <= steps * (2**max_depth - 1)
    assert outs["evals_mean_shards"].shape == (steps, 1)


def test_world1_markov_jump_shard(mesh1):
    kw = dict(epsilon=0.2, beta=1.0, num_leapfrog_steps=5, nbatch=64, seed=1, device="cpu")
    sh = MarkovJumpHMC(RoughWell(ndims=2), **kw).shard()
    de = MarkovJumpHMC(RoughWell(ndims=2), **kw)
    o_sh, o_de = sh.sample(10), de.sample(10)
    assert torch.equal(o_sh["x"], o_de["x"]) and torch.equal(o_sh["sel"], o_de["sel"])
    assert sh.grad_evals == de.grad_evals and sh.mesh.size() == 1


class _SplitDims:
    """A distribution whose sums over the dims come through its hook."""

    def __init__(self):
        self.calls = 0

    def sum_dims(self, t):
        self.calls += 1
        return 2.0 * t.sum(dim=-2)


def test_sum_dims_hook():
    t = torch.arange(12, dtype=torch.float32).reshape(2, 3, 2)
    assert torch.equal(sum_dims(None, t), t.sum(dim=-2))
    assert torch.equal(sum_dims(RoughWell(), t), t.sum(dim=-2))
    d = _SplitDims()
    assert torch.equal(sum_dims(d, t), 2.0 * t.sum(dim=-2)) and d.calls == 1
    # the kinetic energy goes through it
    from mjhmc_tpu_torch.ops.leapfrog import total_energy

    v = torch.ones(3, 5)
    assert torch.equal(total_energy(torch.zeros(5), v, None, d), torch.full((5,), 3.0))
