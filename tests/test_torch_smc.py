"""The SMC head in the port against ``mjhmc_tpu.inference.smc``.

``smc_stage`` is fed the draws the JAX stage makes from its state's key
(``key, k_rs = split(key)`` for the resample offset, then ``key, k_mut =
split(key)`` and one key a mutation step, split into ``k_v, k_mh`` or, for
ChEES, ``k_j, k_v, k_mh``), from the same start (``convert.
smc_state_from_jax``), for three stages of each mutation. λ, log Z and ε
agree within rtol 1e-4; the resample's ancestors (recorded on both sides)
agree on ≥ 0.999 of the particles, a CDF boundary being able to round
apart; x agrees within rtol 1e-4 on the particles whose lines of ancestors
agree. The statistical tests are the JAX package's oracles of
``tests/test_inference.py`` and ``tests/test_chees_smc.py``. A chain mesh
of one gloo rank gives the direct run's result bit for bit; two ranks
(this file's ``__main__`` block, once per rank) give the direct run's
result bit for bit with HMC mutations.
"""

from __future__ import annotations

import importlib
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
from mjhmc_tpu_torch.inference import SMC, smc_run, smc_stage, systematic_resample  # noqa: E402
from mjhmc_tpu_torch.parallel.mesh import make_chain_mesh  # noqa: E402
from mjhmc_tpu_torch.parallel.multihost import free_port, initialize  # noqa: E402

tsmc = importlib.import_module("mjhmc_tpu_torch.inference.smc")

torch.set_num_threads(1)

PRIOR = 3.0


def _log_z_exact(dist, prior_scale=PRIOR):
    var = np.asarray(dist.analytic_var(), np.float64)
    return 0.5 * np.sum(np.log(var)) - 0.5 * len(var) * np.log(prior_scale**2)


def _recorded(monkeypatch, module, name, ancestors_of):
    """Wrap ``module.name`` (a systematic resample); returns the list of
    each call's ancestors."""
    calls, fn = [], getattr(module, name)

    def wrapped(*a):
        calls.append(ancestors_of(*a))
        return fn(*a)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def _ancestors(log_w, u0):
    """The ancestors of a systematic resample, from the port's own CDF."""
    n = log_w.shape[0]
    cdf, pos = tsmc.resample_positions(log_w, u0, torch.arange(n))
    return torch.searchsorted(cdf, pos).clamp(0, n - 1).numpy()


@pytest.mark.parametrize("mutation,m,l", [("hmc", 5, 5), ("chees", 4, 12)])
def test_smc_stage_matches_jax_with_injected_draws(mutation, m, l, monkeypatch):
    import jax
    import jax.numpy as jnp

    from mjhmc_tpu import models as jmodels
    from mjhmc_tpu_torch.convert import smc_state_from_jax

    jsmc = importlib.import_module("mjhmc_tpu.inference.smc")
    kw = dict(ndims=4, log_conditioning=1.0)
    jd, td = jmodels.Gaussian(**kw), tmodels.Gaussian(**kw)
    n = 512
    x0 = (PRIOR * np.random.default_rng(0).standard_normal((4, n))).astype(np.float32)
    f = jnp.float32
    js = jsmc.SMCState(x=jnp.asarray(x0), log_w=jnp.zeros((n,), f), lam=f(0.0), log_z=f(0.0),
                       eps=f(0.25), key=jax.random.key(3), log_tau=f(np.log(np.float32(0.3))),
                       chees_m=f(0.0), chees_v=f(0.0), chees_step=jnp.int32(0))
    ts = smc_state_from_jax(*(np.asarray(a) for a in js[:5]), None,
                            *(np.asarray(a) for a in js[6:]))

    j_anc = _recorded(monkeypatch, jsmc, "systematic_resample",
                      lambda k, x, lw: np.asarray(jnp.clip(jnp.searchsorted(
                          jnp.cumsum(jnp.exp(lw - jax.scipy.special.logsumexp(lw))),
                          jax.random.uniform(k, (), jnp.float32, 0.0, 1.0 / n)
                          + jnp.arange(n, dtype=jnp.float32) / n), 0, n - 1)))
    t_anc = _recorded(monkeypatch, tsmc, "systematic_resample",
                      lambda x, lw, u0: _ancestors(lw, u0))
    bad = np.zeros(n, bool)  # particles whose line of ancestors parted
    lams = []
    for stage in range(3):
        key = js.key
        js, jo = jsmc.smc_stage(jd, js, PRIOR, 0.5, m, l, mutation=mutation)
        # the draws the JAX stage made
        key, k_rs = jax.random.split(key)
        u0 = np.array(jax.random.uniform(k_rs, (), jnp.float32, 0.0, 1.0 / n))
        key, k_mut = jax.random.split(key)
        v, uni, jit = [], [], []
        for k in jax.random.split(k_mut, m):
            if mutation == "chees":
                k_j, k_v, k_mh = jax.random.split(k, 3)
                jit.append(np.array(jax.random.uniform(k_j, (n,), jnp.float32, 1e-3, 1.0)))
            else:
                k_v, k_mh = jax.random.split(k)
            v.append(np.array(jax.random.normal(k_v, (4, n), jnp.float32)))
            uni.append(np.array(jax.random.uniform(k_mh, (n,))))
        draws = dict(u0=torch.as_tensor(u0), v=torch.as_tensor(np.stack(v)),
                     mh_uniform=torch.as_tensor(np.stack(uni)),
                     jitter=torch.as_tensor(np.stack(jit)) if jit else None)
        ts, to = smc_stage(td, ts, None, PRIOR, 0.5, m, l, mutation=mutation, **draws)

        at = f"stage {stage}"
        for field in ("lam", "log_z", "eps"):
            np.testing.assert_allclose(float(getattr(ts, field)), float(getattr(js, field)),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{field} {at}")
        for field in ("ess", "accept"):
            np.testing.assert_allclose(float(getattr(to, field)), float(getattr(jo, field)),
                                       rtol=1e-4, err_msg=f"{field} {at}")
        same = t_anc[-1] == j_anc[-1]
        assert same.mean() >= 0.999, f"ancestors agree on {same.mean()} ({at})"
        bad = bad[j_anc[-1]] | ~same
        xt, xj = ts.x.numpy(), np.asarray(js.x)
        scale = np.abs(xj).max()
        np.testing.assert_allclose(xt[:, ~bad], xj[:, ~bad], rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"x {at}")
        if mutation == "chees":
            np.testing.assert_allclose(float(ts.log_tau), float(js.log_tau), rtol=1e-4,
                                       err_msg=at)
            assert int(ts.chees_step) == int(js.chees_step) == (stage + 1) * m
        lams.append(float(ts.lam))
    assert 0.0 < lams[0] < lams[1] and (~bad).mean() >= 0.99


def test_find_delta_and_ess_match_jax():
    import jax.numpy as jnp

    jsmc = importlib.import_module("mjhmc_tpu.inference.smc")
    rng = np.random.default_rng(4)
    for lam in (0.0, 0.3, 0.97):
        log_w = rng.standard_normal(1000).astype(np.float32)
        delta = (5.0 * rng.standard_normal(1000)).astype(np.float32)
        dj = float(jsmc._find_delta(jnp.asarray(log_w), jnp.asarray(delta), jnp.float32(lam),
                                    0.5))
        dt = float(tsmc._find_delta(torch.as_tensor(log_w), torch.as_tensor(delta),
                                    torch.tensor(lam, dtype=torch.float32), 0.5))
        np.testing.assert_allclose(dt, dj, rtol=1e-5, err_msg=f"lam {lam}")
        np.testing.assert_allclose(float(tsmc._ess(torch.as_tensor(log_w))),
                                   float(jsmc._ess(jnp.asarray(log_w))), rtol=1e-5)


def test_systematic_resample_unbiased():
    """Ancestor counts are within 1 of n·w (systematic resampling)."""
    n = 10_000
    x = torch.arange(n, dtype=torch.float32)[None, :]
    log_w = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
    xr = systematic_resample(x, log_w, torch.tensor(0.37 / n))
    counts = np.bincount(xr[0].numpy().astype(int), minlength=n)
    w = np.arange(1, n + 1) / np.sum(np.arange(1, n + 1))
    assert np.abs(counts - w * n).max() <= 1.0 + 1e-6


@pytest.mark.parametrize("mutation,l,bound", [("hmc", 5, 0.15), ("chees", 24, 0.2)])
def test_smc_gaussian_evidence_and_moments(mutation, l, bound):
    """Gaussian prior → Gaussian target: log Z and the moments are analytic
    (4,096 particles, 16 stages, as JAX)."""
    dist = tmodels.Gaussian(ndims=4, log_conditioning=1.0)
    state, trace = smc_run(dist, torch.Generator().manual_seed(2), 4096, num_stages=16,
                           prior_scale=PRIOR, num_mutation_steps=5, num_leapfrog_steps=l,
                           mutation=mutation, init_tau=0.3, device="cpu")
    assert float(state.lam) == 1.0
    assert abs(float(state.log_z) - _log_z_exact(dist)) < bound
    var = dist.analytic_var().numpy().astype(np.float64)
    x = state.x.numpy()
    np.testing.assert_allclose(x.mean(axis=1), 0.0, atol=0.2 * np.sqrt(var.max()))
    np.testing.assert_allclose(x.var(axis=1), var, rtol=0.15)
    assert set(trace) == {"lam", "ess", "accept", "eps"} and trace["lam"].shape == (16,)
    if mutation == "chees":  # ChEES moved τ and kept it sane
        tau = float(torch.exp(state.log_tau))
        assert 1e-3 < tau < 1e4 and abs(tau - 0.3) > 1e-3


def test_smc_heavy_tailed_runs():
    """The SMC class on product of t (2,048 particles, 12 stages, as JAX)."""
    head = SMC(tmodels.ProductOfT(ndims=8, nbasis=8, nu=4.0), num_particles=2048,
               num_stages=12, seed=3, device="cpu")
    state, trace = head.run()
    assert float(state.lam) == 1.0 and torch.isfinite(state.x).all()
    assert (np.diff(trace["lam"].numpy()) >= -1e-6).all()


@pytest.mark.parametrize("mutation", ["hmc", "chees"])
def test_smc_under_a_world_size_1_mesh_is_the_direct_run(mutation):
    model = tmodels.Gaussian(ndims=4, log_conditioning=1.0)
    kw = dict(num_stages=4, num_mutation_steps=3, num_leapfrog_steps=6, mutation=mutation)
    direct = smc_run(model, torch.Generator().manual_seed(6), 1024, device="cpu", **kw)
    initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        meshed = smc_run(model, torch.Generator().manual_seed(6), 1024,
                         mesh=make_chain_mesh(device="cpu"), **kw)
    finally:
        dist.destroy_process_group()
    for a, b in zip(direct[0], meshed[0]):
        assert torch.equal(a, b)
    for k in direct[1]:
        assert torch.equal(direct[1][k], meshed[1][k])


def test_smc_over_two_ranks_is_the_direct_run(tmp_path):
    """Two gloo ranks, each holding half the particles: the gathered HMC
    result equals the direct run bit for bit; ChEES (its cross-chain means
    all_reduced) reaches λ = 1 with log Z within 0.02 of the direct run."""
    addr = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "2", addr,
                               str(tmp_path)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    ranks = [dict(np.load(os.path.join(tmp_path, f"rank{r}.npz"))) for r in range(2)]
    model = tmodels.Gaussian(ndims=4, log_conditioning=1.0)
    for mutation in ("hmc", "chees"):
        state, _ = smc_run(model, torch.Generator().manual_seed(6), 1024,
                           **_TWO_RANK_KW, mutation=mutation, device="cpu")
        x = np.concatenate([r[f"{mutation}/x"] for r in ranks], axis=1)
        if mutation == "hmc":
            np.testing.assert_array_equal(x, state.x.numpy())
            for field in ("log_z", "lam", "eps"):
                for r in ranks:
                    assert r[f"hmc/{field}"] == getattr(state, field).numpy()
        else:
            for r in ranks:
                assert r["chees/lam"] == 1.0
                assert abs(float(r["chees/log_z"]) - float(state.log_z)) < 0.02


def test_smc_refuses_particles_the_ranks_do_not_split(tmp_path):
    """Two gloo ranks: 101 particles raise ``ValueError`` on each rank and
    100 run, 50 a rank. JAX's mesh run refuses 101 too (its resample's
    shard_map axis does not divide)."""
    import jax

    from mjhmc_tpu import models as jmodels
    from mjhmc_tpu.inference.smc import smc_run as jax_smc_run
    from mjhmc_tpu.parallel.mesh import make_chain_mesh as jax_chain_mesh

    with pytest.raises(ValueError, match="2 does not evenly divide 101"):
        jax_smc_run(jmodels.Gaussian(2, 1.0), jax.random.key(0), 101, num_stages=2,
                    mesh=jax_chain_mesh(2))
    jstate, _ = jax_smc_run(jmodels.Gaussian(2, 1.0), jax.random.key(0), 100, num_stages=2,
                            mesh=jax_chain_mesh(2))
    assert jstate.x.shape == (2, 100)
    addr = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "2", addr,
                               str(tmp_path), "split"], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    for r in range(2):
        rec = np.load(os.path.join(tmp_path, f"rank{r}.npz"))
        assert "do not split over 2 ranks" in str(rec["refused"])
        assert rec["x_shape"].tolist() == [2, 50] and float(rec["lam"]) > 0.0


_TWO_RANK_KW = dict(num_stages=8, num_mutation_steps=3, num_leapfrog_steps=6, init_tau=0.5)


def _split_rank_main(mesh, out: str) -> None:
    """101 particles over two ranks must raise; 100 must run."""
    model = tmodels.Gaussian(ndims=2, log_conditioning=1.0)
    try:
        smc_run(model, torch.Generator().manual_seed(0), 101, num_stages=2, mesh=mesh)
        refused = "ran"
    except ValueError as e:
        refused = str(e)
    state, _ = smc_run(model, torch.Generator().manual_seed(0), 100, num_stages=2, mesh=mesh)
    np.savez(os.path.join(out, f"rank{mesh.axis_index()}.npz"), refused=refused,
             x_shape=np.array(state.x.shape), lam=state.lam.numpy())


def _rank_main(rank: int, world: int, addr: str, out: str, mode: str = "run") -> None:
    torch.set_num_threads(1)
    initialize(addr, world, rank, device="cpu")
    try:
        mesh = make_chain_mesh(device="cpu")
        if mode == "split":
            return _split_rank_main(mesh, out)
        model = tmodels.Gaussian(ndims=4, log_conditioning=1.0)
        rec = {}
        for mutation in ("hmc", "chees"):
            state, _ = smc_run(model, torch.Generator().manual_seed(6), 1024, mesh=mesh,
                               mutation=mutation, **_TWO_RANK_KW)
            rec.update({f"{mutation}/{k}": getattr(state, k).numpy()
                        for k in ("x", "log_z", "lam", "eps")})
        np.savez(os.path.join(out, f"rank{rank}.npz"), **rec)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], *sys.argv[5:6])
    print(json.dumps({"rank": int(sys.argv[1]), "ok": True}))
