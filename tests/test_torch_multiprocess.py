"""The chain-sharded runtime across processes: 2 and 4 gloo ranks on the CPU.

Each spawn runs this file's ``__main__`` block once per rank (torch only);
the ranks write their blocks to ``rank<r>.npz`` and the tests here hold
them against JAX and against dense runs of the port:

- ``sharded_cuda_mjhmc_run`` (plain version, ``fixed_uniform=True``) at 2
  ranks against ``sharded_pallas_mjhmc_run`` in interpret mode on
  ``make_chain_mesh(2)``. JAX shards the LANES of the (d, 8, L) layout, so
  device r holds the chains {s·L + l : l in its lane range}; the port's
  rank r is given exactly those chains as its contiguous block, and the
  two are held chain by chain (``test_torch_engine.py``'s rules: counters
  and ``back_valid`` exact, states within rtol 1e-4 after 5 iterations, Σw
  within rtol 1e-4 after 100). In Philox mode rank r equals a direct run on
  its block at seed + r·131071, also where that wraps past 2³¹.
- no collective inside ``sharded_cuda_mjhmc_run``, one (the gather of the
  counters after the run) in ``sharded_nuts_run``, exactly one all_reduce
  per iteration in the adaptive MJHMC run; the ``torch.distributed`` calls
  are wrapped and counted in the ranks.
- ``sharded_moments``, ``MarkovJumpHMC.shard``, the sharded checkpoint, the
  ring resample (4 ranks, against the dense ``systematic_resample``) and
  ``ModelShardedSparseCoding`` on a 2 × 2 (chains × model) mesh.
- ``bench_scaling`` under 2 ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch.distributed as dist  # noqa: E402

from mjhmc_tpu_torch import models as tmodels  # noqa: E402
from mjhmc_tpu_torch.inference.smc import systematic_resample  # noqa: E402
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm  # noqa: E402
from mjhmc_tpu_torch.parallel.multihost import free_port  # noqa: E402

torch.set_num_threads(1)

SEED = 7
#: name -> (chains, ε, β, M) of the JAX comparison
CASES = {"rough_well": (2048, 1.0, 0.1, 10), "sparse_coding": (256, 0.02, 0.1, 10)}
STEPS = (5, 100)
#: the torch.distributed calls counted (isend/irecv stay unwrapped: P2POp
#: checks its op against them; a ring's hop counts as batch_isend_irecv)
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "broadcast", "all_to_all", "all_to_all_single",
               "barrier", "batch_isend_irecv", "reduce", "gather", "scatter", "send", "recv")
RESAMPLE_N = 256
SPAWN_TIMEOUT = 120


# ---- shared with test_torch_parallel.py ------------------------------------
def port_spec(name):
    if name == "rough_well":
        return cm.energy_spec_for(tmodels.RoughWell(ndims=2))
    return dataclasses.replace(cm.energy_spec_for(tmodels.SparseCoding()), precision="highest")


def elementwise(name) -> bool:
    return name == "rough_well"


def rank_block(a, r, p, name):
    """Rank r's block of ``a`` (engine layout: (..., d, 8, L) / (..., 8, L)
    elementwise, (..., d, n) / (..., 1, n) matmul) in the port's layout
    (..., d, n/P) / (..., n/P): JAX's lane shard r, flattened."""
    a = np.asarray(a)
    if elementwise(name):
        lp = a.shape[-1] // p
        blk = a[..., r * lp:(r + 1) * lp]
        return blk.reshape(blk.shape[:-2] + (-1,))
    bp = a.shape[-1] // p
    blk = a[..., r * bp:(r + 1) * bp]
    return blk[..., 0, :] if blk.shape[-2] == 1 else blk


def jax_case(name):
    """(JAX spec, engine-layout JAX state) of a case, from a seed."""
    import jax
    import jax.numpy as jnp

    from mjhmc_tpu import models as jmodels
    from mjhmc_tpu.ops.pallas_mjhmc import energy_spec_for

    n = CASES[name][0]
    if elementwise(name):
        jd = jmodels.RoughWell(ndims=2)
        x = jd.init_x(jax.random.key(0), n)
        v = jax.random.normal(jax.random.key(1), x.shape, jnp.float32)
        u, g = jd.potential_and_grad(x)
        d, s, lanes = jd.ndims, 8, n // 8
        z = jnp.zeros((s, lanes), jnp.float32)
        return energy_spec_for(jd), (x.reshape(d, s, lanes), v.reshape(d, s, lanes),
                                     g.reshape(d, s, lanes), u.reshape(s, lanes), z, z)
    jd = jmodels.SparseCoding()
    rng = np.random.default_rng(0)
    x = jnp.asarray((0.1 * rng.standard_normal((jd.ndims, n))).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((jd.ndims, n)).astype(np.float32))
    u, g = jd.potential_and_grad(x)
    z = jnp.zeros((1, n), jnp.float32)
    spec = dataclasses.replace(energy_spec_for(jd), precision="highest")
    return spec, (x, v, g, u[None], z, z)


def jax_sharded(name, p, steps):
    """``sharded_pallas_mjhmc_run`` on ``make_chain_mesh(p)`` in interpret
    mode: a list over ranks of {field: block in the port's layout}."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from mjhmc_tpu.ops.pallas_mjhmc import sharded_pallas_mjhmc_run
    from mjhmc_tpu.parallel.mesh import make_chain_mesh

    _, eps, beta, m = CASES[name]
    spec, st = jax_case(name)
    out = sharded_pallas_mjhmc_run(make_chain_mesh(p), spec, *st, jnp.int32(SEED),
                                   jnp.float32(eps), jnp.float32(beta), steps, m,
                                   interpret=pltpu.InterpretParams())
    return [{f: rank_block(getattr(out, f), r, p, name) for f in cm.RunOut._fields}
            for r in range(p)]


def port_inputs(name, p):
    """Each rank's block of the JAX start state, in the port's layout."""
    _, st = jax_case(name)
    return [tuple(torch.as_tensor(rank_block(a, r, p, name).copy()) for a in st)
            for r in range(p)]


def _close(a, b, what, rtol=1e-4):
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=rtol,
                               atol=rtol * np.abs(b).max(), err_msg=what)


def hold_against_jax(port_blocks, jax_blocks, steps, what):
    """test_torch_engine.py's rules over every rank's block: counters and
    back_valid exact; after 5 iterations the states per chain, after 100 Σw
    over all chains."""
    for r, (pt, jx) in enumerate(zip(port_blocks, jax_blocks)):
        for f in ("evals", "back_valid"):
            np.testing.assert_array_equal(np.asarray(pt[f]), jx[f], f"{what} rank {r} {f}")
        if steps == 5:
            for f in ("x", "v", "grad", "u", "h_back"):
                _close(pt[f], jx[f], f"{what} rank {r} {f}")
    _close(sum(np.asarray(pt["w"], np.float64).sum() for pt in port_blocks),
           sum(jx["w"].astype(np.float64).sum() for jx in jax_blocks), f"{what} Σw")


@contextlib.contextmanager
def counting_collectives():
    """Wrap the ``torch.distributed`` collectives; yields the list of the
    names called inside the block."""
    calls, saved = [], {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name, fn):
        def counted(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def resample_patterns(n=RESAMPLE_N):
    """Log-weight patterns (tests/test_collectives.py:112 and a random one)."""
    i = np.arange(n)
    return {
        "random": np.random.default_rng(1).standard_normal(n).astype(np.float32),
        "uniform": np.zeros(n, np.float32),
        "first_shard": np.where(i < n // 8, 0.0, -1e30).astype(np.float32),
        "last_shard": np.where(i >= n - n // 8, 0.0, -1e30).astype(np.float32),
        "one_particle": np.where(i == 200, 0.0, -1e30).astype(np.float32),
    }


def resample_particles(n=RESAMPLE_N):
    return np.random.default_rng(3).standard_normal((4, n)).astype(np.float32)


# ---- the ranks ---------------------------------------------------------------
def _save_out(res, key, out):
    for f in cm.RunOut._fields:
        res[f"{key}/{f}"] = getattr(out, f).numpy()


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _job_two(mesh, inputs, res):
    """World size 2: the sharded engine against JAX and in Philox mode,
    the collectives counted, moments, MarkovJumpHMC.shard, the adaptive
    run, sharded NUTS and the sharded checkpoint."""
    from mjhmc_tpu_torch.models import Gaussian, RoughWell
    from mjhmc_tpu_torch.parallel.collectives import sharded_moments
    from mjhmc_tpu_torch.parallel.mesh import shard_chain_pytree
    from mjhmc_tpu_torch.samplers import MarkovJumpHMC, adaptive_mjhmc_run, da_init
    from mjhmc_tpu_torch.samplers.mjhmc import mjhmc_run
    from mjhmc_tpu_torch.samplers.nuts import make_nuts_state, sharded_nuts_run
    from mjhmc_tpu_torch.samplers.state import make_mj_state
    from mjhmc_tpu_torch.utils.checkpoint import load_sharded_pytree, save_sharded_pytree

    r = mesh.axis_index()
    with counting_collectives() as calls:
        for name, (_, eps, beta, m) in CASES.items():
            st = tuple(torch.as_tensor(inputs[f"{name}/{r}/{i}"]) for i in range(6))
            spec = port_spec(name)
            for steps in STEPS:
                out = cm.sharded_cuda_mjhmc_run(mesh, spec, *st, SEED, eps, beta, steps, m,
                                                fixed_uniform=True)
                _save_out(res, f"{name}/{steps}", out)
            # Philox mode: the rank's offset seed, and its int32 wrap
            for seed in (12345, 2**31 - 10):
                sh = cm.sharded_cuda_mjhmc_run(mesh, spec, *st, seed, eps, beta, 5, m)
                direct = cm.run_reference(spec, *st, seed + r * 131071, eps, beta, 5, m)
                plain = cm.run_reference(spec, *st, seed, eps, beta, 5, m)
                res[f"{name}/philox{seed}/equal_offset"] = _equal(sh, direct)
                res[f"{name}/philox{seed}/equal_unoffset"] = _equal(sh, plain)
                res[f"{name}/philox{seed}/rank_seed"] = cm.rank_seed(seed, r)
    res["engine_collectives"] = len(calls)

    # sharded moments of a (3, 64) batch (tests/test_collectives.py:18)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    blk = slice(r * 32, (r + 1) * 32)
    with counting_collectives() as calls:
        mean, var = sharded_moments(torch.as_tensor(x[:, blk]), torch.as_tensor(w[blk]), mesh)
    res["moments/mean"], res["moments/var"] = mean.numpy(), var.numpy()
    res["moments/collectives"] = json.dumps(calls)

    # MarkovJumpHMC.shard against the unsharded sampler (tests/test_parallel.py:44)
    kw = dict(epsilon=0.2, beta=1.0, num_leapfrog_steps=5, nbatch=64, seed=1, device="cpu")
    sharded = MarkovJumpHMC(RoughWell(ndims=2), **kw).shard(mesh)
    dense = MarkovJumpHMC(RoughWell(ndims=2), **kw)
    with counting_collectives() as calls:
        o_sh = sharded.sample(30)
    res["shard/collectives"] = len(calls)
    o_de = dense.sample(30)
    for f in ("x", "sel", "dwell"):
        res[f"shard/{f}"] = o_sh[f].numpy()
        res[f"shard/dense_{f}"] = o_de[f][..., blk].numpy()
    res["shard/grad_evals"], res["shard/dense_grad_evals"] = sharded.grad_evals, dense.grad_evals

    # the adaptive step: one all_reduce per iteration, the unsharded run's ε
    rw = RoughWell(ndims=2)
    state = make_mj_state(rw, torch.Generator().manual_seed(3), 128)
    with counting_collectives() as calls:
        _, da, aux = adaptive_mjhmc_run(rw, shard_chain_pytree(state, mesh), da_init(1.0),
                                        torch.Generator().manual_seed(4), 5, 0.1, 5, mesh=mesh)
    res["adapt/collectives"] = json.dumps(calls)
    res["adapt/eps"] = aux["eps_trace"].numpy()
    _, _, aux_d = adaptive_mjhmc_run(rw, state, da_init(1.0), torch.Generator().manual_seed(4),
                                     5, 0.1, 5)
    res["adapt/dense_eps"] = aux_d["eps_trace"].numpy()
    res["adapt/w"] = aux["moments"].w.numpy()

    # sharded NUTS: nothing inside the run, one gather after it
    g2 = Gaussian(ndims=2, log_conditioning=1.0)
    nst = shard_chain_pytree(make_nuts_state(g2, torch.Generator().manual_seed(0), 128), mesh)
    with counting_collectives() as calls:
        nst, nouts = sharded_nuts_run(mesh, g2, nst, 1, 4, 0.5, 4)
    res["nuts/collectives"] = json.dumps(calls)
    res["nuts/evals_mean_shards"] = nouts["evals_mean_shards"].numpy()
    res["nuts/grad_evals"] = nst.grad_evals.numpy()
    res["nuts/x_shape"] = np.asarray(nouts["x"].shape)

    # the sharded checkpoint: round trip, resume, refusal under another sharding
    gauss3 = Gaussian(ndims=3, log_conditioning=1.0)
    st3 = shard_chain_pytree(make_mj_state(gauss3, torch.Generator().manual_seed(0), 64), mesh)

    def run(s, seed):
        return mjhmc_run(gauss3, s, torch.Generator().manual_seed(seed), 10, 0.5, 0.2, 5,
                         "stats", block=mesh.block(*s.chain.x.shape))[0]

    seg1 = run(st3, 1)
    prefix = os.path.join(inputs["out"].item(), "carry")
    res["ckpt/path"] = save_sharded_pytree(prefix, seg1, mesh)
    fresh = shard_chain_pytree(make_mj_state(gauss3, torch.Generator().manual_seed(9), 64), mesh)
    restored = load_sharded_pytree(prefix, fresh, mesh)
    res["ckpt/roundtrip"] = _equal(restored.chain, seg1.chain) and _equal(restored[1:], seg1[1:])
    res["ckpt/resume"] = _equal(run(restored, 2).chain, run(seg1, 2).chain)
    half = shard_chain_pytree(make_mj_state(gauss3, torch.Generator().manual_seed(9), 32), mesh)
    try:
        load_sharded_pytree(prefix, half, mesh)
        res["ckpt/refused"] = False
    except KeyError:
        res["ckpt/refused"] = True


def _job_four(world_mesh, inputs, res):
    """World size 4: the ring resample on a ("chains",) mesh of 4, and the
    sparse-coding energy and an MJHMC run on a 2 × 2 (chains, model) mesh."""
    from mjhmc_tpu_torch.models import SparseCoding
    from mjhmc_tpu_torch.parallel.collectives import distributed_systematic_resample
    from mjhmc_tpu_torch.parallel.mesh import make_chain_mesh
    from mjhmc_tpu_torch.parallel.model_parallel import ModelShardedSparseCoding
    from mjhmc_tpu_torch.samplers.mjhmc import mjhmc_run
    from mjhmc_tpu_torch.samplers.state import make_mj_state

    r, p = world_mesh.axis_index(), world_mesh.size()
    x = resample_particles()
    b = x.shape[1] // p
    blk = slice(r * b, (r + 1) * b)
    u0 = float(inputs["u0"])
    for pat, lw in resample_patterns().items():
        with counting_collectives() as calls:
            got = distributed_systematic_resample(torch.as_tensor(x[:, blk]),
                                                  torch.as_tensor(lw[blk]), u0, world_mesh)
        res[f"ring/{pat}"] = got.numpy()
        res[f"ring/{pat}/collectives"] = json.dumps(calls)

    mesh = make_chain_mesh(4, model_axis=2, device="cpu")  # chains=2 × model=2
    base = SparseCoding(npixels=64, nbasis=128)
    adapter = ModelShardedSparseCoding(base, mesh)
    a = torch.as_tensor(inputs["a"])
    cols = slice(mesh.axis_index() * 8, (mesh.axis_index() + 1) * 8)
    u, g = adapter.potential_and_grad(a[adapter.rows, cols].contiguous())
    res["model/u"], res["model/g"] = u.numpy(), g.numpy()
    res["model/rows"] = np.asarray([adapter.rows.start, adapter.rows.stop, cols.start, cols.stop])

    # MJHMC on the sharded energy against the dense run (tests/test_model_parallel.py:27)
    dense = make_mj_state(base, torch.Generator().manual_seed(1), 32)
    cols = slice(mesh.axis_index() * 16, (mesh.axis_index() + 1) * 16)
    ch = dense.chain
    state = dense._replace(
        chain=ch._replace(x=ch.x[adapter.rows, cols], v=ch.v[adapter.rows, cols],
                          u=ch.u[cols], grad=ch.grad[adapter.rows, cols]),
        h_back=dense.h_back[cols], back_valid=dense.back_valid[cols],
        grad_evals=dense.grad_evals[cols], dwell_sum=dense.dwell_sum[cols])
    _, out = mjhmc_run(adapter, state, torch.Generator().manual_seed(2), 10, 0.02, 0.1, 3,
                       block=mesh.block(64, 16))
    _, out_d = mjhmc_run(base, dense, torch.Generator().manual_seed(2), 10, 0.02, 0.1, 3)
    res["model/x"] = out["x"].numpy()
    res["model/dense_x"] = out_d["x"][:, adapter.rows, cols].numpy()
    res["model/sel"], res["model/dense_sel"] = out["sel"].numpy(), out_d["sel"][:, cols].numpy()
    res["model/cache_err"] = out["cache_err"].numpy()
    res["model/dwell"] = out["dwell"].numpy()


def _rank_main(job, rank, world, addr, out):
    from mjhmc_tpu_torch.parallel.mesh import make_chain_mesh
    from mjhmc_tpu_torch.parallel.multihost import initialize

    torch.set_num_threads(1)
    info = initialize(addr, world, rank, device="cpu")
    assert info["initialized"] and info["process_count"] == world, info
    inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    inputs["out"] = np.asarray(out)
    res = {"info": json.dumps(info)}
    mesh = make_chain_mesh(world, device="cpu")
    {"two": _job_two, "four": _job_four}[job](mesh, inputs, res)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


# ---- the spawns ----------------------------------------------------------------
def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (REPO, env.get("PYTHONPATH"))))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _run_ranks(cmds, envs):
    """Start one process per command, wait for all (each within
    SPAWN_TIMEOUT, killed past it); returns their outputs."""
    procs = [subprocess.Popen(c, env=e, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c, e in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"rank exited {p.returncode}:\n{o[-3000:]}\n{e[-6000:]}"
    return outs


def _spawn(job, world, out, **inputs):
    np.savez(os.path.join(out, "inputs.npz"), **inputs)
    addr = f"127.0.0.1:{free_port()}"
    _run_ranks([[sys.executable, os.path.abspath(__file__), job, str(r), str(world), addr, out]
                for r in range(world)], [_env()] * world)
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(world)]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("two_ranks"))
    inputs = {f"{name}/{r}/{i}": a.numpy() for name in CASES
              for r, st in enumerate(port_inputs(name, 2)) for i, a in enumerate(st)}
    return _spawn("two", 2, out, **inputs)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    out = str(tmp_path_factory.mktemp("four_ranks"))
    inputs = dict(
        u0=np.float32(jax.random.uniform(jax.random.key(5), (), jnp.float32, 0.0,
                                         1.0 / RESAMPLE_N)),
        a=(0.1 * np.random.default_rng(0).standard_normal((128, 16))).astype(np.float32))
    return _spawn("four", 4, out, **inputs), inputs


# ---- two ranks -------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("steps", STEPS)
def test_two_ranks_match_jax_sharded_kernel(two, name, steps):
    jax_blocks = jax_sharded(name, 2, steps)
    port_blocks = [{f: rk[f"{name}/{steps}/{f}"] for f in cm.RunOut._fields} for rk in two]
    hold_against_jax(port_blocks, jax_blocks, steps, f"{name} after {steps}")


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", (12345, 2**31 - 10))
def test_two_ranks_philox_offset_seed(two, name, seed):
    """Rank r is a direct run on its block at seed + r·131071, bit for bit
    (near 2³¹ the offset wraps to a negative int32: the same words)."""
    for r, rk in enumerate(two):
        assert bool(rk[f"{name}/philox{seed}/equal_offset"]), (name, seed, r)
        assert bool(rk[f"{name}/philox{seed}/equal_unoffset"]) == (r == 0), (name, seed, r)
    wrapped = int(two[1][f"{name}/philox{seed}/rank_seed"])
    assert wrapped == ((seed + 131071 + 2**31) % 2**32) - 2**31
    assert (wrapped < 0) == (seed + 131071 >= 2**31)


def test_two_ranks_engine_issues_no_collective(two):
    assert all(int(rk["engine_collectives"]) == 0 for rk in two)


def test_two_ranks_sharded_moments_match_dense(two):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 64)).astype(np.float32).astype(np.float64)
    w = rng.uniform(0.5, 2.0, 64).astype(np.float32).astype(np.float64)
    m_ref = (w * x).sum(axis=1) / w.sum()
    v_ref = (w * x**2).sum(axis=1) / w.sum() - m_ref**2
    for rk in two:
        np.testing.assert_allclose(rk["moments/mean"], m_ref, rtol=1e-5)
        np.testing.assert_allclose(rk["moments/var"], v_ref, rtol=1e-4)
        assert json.loads(str(rk["moments/collectives"])) == ["all_reduce"]


def test_two_ranks_markov_jump_shard_matches_unsharded(two):
    for rk in two:
        np.testing.assert_allclose(rk["shard/x"], rk["shard/dense_x"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(rk["shard/sel"], rk["shard/dense_sel"])
        np.testing.assert_allclose(rk["shard/dwell"], rk["shard/dense_dwell"], rtol=1e-5)
        assert int(rk["shard/collectives"]) == 0
        assert int(rk["shard/grad_evals"]) == int(rk["shard/dense_grad_evals"])


def test_two_ranks_adaptive_step_one_all_reduce_per_iteration(two):
    for rk in two:
        assert json.loads(str(rk["adapt/collectives"])) == ["all_reduce"] * 5
        np.testing.assert_allclose(rk["adapt/eps"], rk["adapt/dense_eps"], rtol=1e-4)
        assert (rk["adapt/w"] > 0).all()


def test_two_ranks_sharded_nuts_gathers_once_after_the_run(two):
    steps, max_depth = 4, 4
    for rk in two:
        assert json.loads(str(rk["nuts/collectives"])) == ["all_gather"]
        assert rk["nuts/evals_mean_shards"].shape == (steps, 2)
        assert tuple(rk["nuts/x_shape"]) == (steps, 2, 64)
        ev = rk["nuts/grad_evals"]
        assert ev.min() >= steps and ev.max() <= steps * (2**max_depth - 1)
    np.testing.assert_array_equal(two[0]["nuts/evals_mean_shards"],
                                  two[1]["nuts/evals_mean_shards"])
    for r, rk in enumerate(two):  # column r is rank r's own chain mean
        np.testing.assert_allclose(rk["nuts/evals_mean_shards"][-1, r],
                                   rk["nuts/grad_evals"].mean(), rtol=1e-6)


def test_two_ranks_sharded_checkpoint(two):
    for r, rk in enumerate(two):
        assert str(rk["ckpt/path"]).endswith(f".proc{r}of2.npz")
        assert bool(rk["ckpt/roundtrip"]) and bool(rk["ckpt/resume"]) and bool(rk["ckpt/refused"])


# ---- four ranks ----------------------------------------------------------------
@pytest.mark.parametrize("pattern", sorted(resample_patterns()))
def test_four_ranks_ring_resample_equals_dense(four, pattern):
    """Bit-equal to the dense ``systematic_resample`` at the same u0; the
    weights travel by one all_gather, the particles by the ring."""
    ranks, inputs = four
    lw = resample_patterns()[pattern]
    ref = systematic_resample(torch.as_tensor(resample_particles()), torch.as_tensor(lw),
                              float(inputs["u0"]))
    got = np.concatenate([rk[f"ring/{pattern}"] for rk in ranks], axis=1)
    np.testing.assert_array_equal(got, ref.numpy(), pattern)
    for rk in ranks:
        calls = json.loads(str(rk[f"ring/{pattern}/collectives"]))
        assert calls[0] == "all_gather" and calls.count("all_gather") == 1
        assert set(calls[1:]) <= {"all_reduce", "batch_isend_irecv"}


def test_four_ranks_model_sharded_energy_matches_dense(four):
    """The 2 × 2 mesh's blocks of U and dU/da against the dense energy of
    both packages (tests/test_model_parallel.py:16's tolerances)."""
    import jax.numpy as jnp

    from mjhmc_tpu import models as jmodels

    ranks, inputs = four
    a = inputs["a"]
    u_j, g_j = (np.asarray(t) for t in jmodels.SparseCoding(npixels=64, nbasis=128)
                .potential_and_grad(jnp.asarray(a)))
    u_t, g_t = (t.numpy() for t in tmodels.SparseCoding(npixels=64, nbasis=128)
                .potential_and_grad(torch.as_tensor(a)))
    for rk in ranks:
        r0, r1, c0, c1 = (int(v) for v in rk["model/rows"])
        for u_ref, g_ref in ((u_j, g_j), (u_t, g_t)):
            np.testing.assert_allclose(rk["model/u"], u_ref[c0:c1], rtol=2e-4)
            np.testing.assert_allclose(rk["model/g"], g_ref[r0:r1, c0:c1], rtol=2e-3, atol=2e-3)


def test_four_ranks_mjhmc_on_model_sharded_energy(four):
    """An MJHMC run with the basis split over the model axis and the chains
    over the chains axis against the dense run on the same draws
    (tests/test_model_parallel.py:27's tolerances)."""
    ranks, _ = four
    for rk in ranks:
        assert np.isfinite(rk["model/x"]).all() and np.isfinite(rk["model/dwell"]).all()
        assert rk["model/cache_err"].max() < 5e-2
        np.testing.assert_allclose(rk["model/x"], rk["model/dense_x"], rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(rk["model/sel"], rk["model/dense_sel"])


# ---- bench_scaling ---------------------------------------------------------------
def test_bench_scaling_two_ranks():
    """``python -m mjhmc_tpu_torch.bench_scaling`` under two ranks, as
    ``torchrun --nproc_per_node 2`` starts them: one line per size that ran,
    the efficiency line, the size above the world skipped."""
    port = str(free_port())
    argv = [sys.executable, "-m", "mjhmc_tpu_torch.bench_scaling", "--engine", "torch",
            "--device", "cpu", "--devices", "1", "2", "4", "--chains-per-device", "64",
            "--steps", "5"]
    envs = [dict(_env(), RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port) for r in range(2)]
    (out0, err0), (out1, _) = _run_ranks([argv, argv], envs)
    recs = [json.loads(ln) for ln in out0.splitlines() if ln.startswith("{")]
    assert [(r["metric"], r["devices"]) for r in recs] == [
        ("leapfrog_steps_per_sec", 1), ("leapfrog_steps_per_sec", 2),
        ("weak_scaling_efficiency", 2)]
    assert recs[0]["chains"] == 64 and recs[1]["chains"] == 128
    assert all(r["value"] > 0 for r in recs)
    assert "# skipping 4 devices (only 2)" in err0
    assert out1.strip() == ""  # rank 0 prints


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
