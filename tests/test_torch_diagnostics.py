"""Slice E of the port against the JAX package on the CPU: split-R̂, the
spectral gaps, the algebraic ladder (matrices, and the simulators with
JAX's own draws injected) and the ``diagnostics`` CLI. The same inputs,
made with NumPy from a seed, go through both."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu.__main__ import main as jax_cli
from mjhmc_tpu.diagnostics import rhat as jrhat
from mjhmc_tpu.diagnostics import spectral as jspec
from mjhmc_tpu.samplers import algebraic as jalg
from mjhmc_tpu_torch.__main__ import main as cli
from mjhmc_tpu_torch.diagnostics import rhat as trhat
from mjhmc_tpu_torch.diagnostics import spectral as tspec
from mjhmc_tpu_torch.samplers import algebraic as talg

torch.set_num_threads(1)


def _chains(seed, t, d, n, weighted):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal((t, d, n)), axis=0).astype(np.float32) * 0.1
    x += rng.standard_normal((t, d, n)).astype(np.float32)
    x += rng.standard_normal((1, d, n)).astype(np.float32) * 0.3  # chains disagree a little
    w = rng.uniform(0.2, 1.0, (t, n)).astype(np.float32) if weighted else None
    return x, w


def _both(x, w):
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.as_tensor(w)
    return (jnp.asarray(x), jw), (torch.as_tensor(x), tw)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("t,d,n", [(4, 1, 3), (9, 2, 5), (50, 3, 16), (101, 2, 64), (400, 5, 7)])
def test_potential_scale_reduction(t, d, n, weighted):
    x, w = _chains(t * 100 + d, t, d, n, weighted)
    (jx, jw), (tx, tw) = _both(x, w)
    r_j = np.asarray(jrhat.potential_scale_reduction(jx, jw))
    r_t = trhat.potential_scale_reduction(tx, tw).numpy()
    assert r_t.shape == (d,)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_potential_scale_reduction_too_short(weighted):
    x, w = _chains(0, 3, 2, 4, weighted)
    (jx, jw), (tx, tw) = _both(x, w)
    with pytest.raises(ValueError, match="at least 4 samples"):
        jrhat.potential_scale_reduction(jx, jw)
    with pytest.raises(ValueError, match="at least 4 samples"):
        trhat.potential_scale_reduction(tx, tw)


def _energies(seed, k, scale=1.0):
    return np.random.default_rng(seed).standard_normal(k) * scale


@pytest.mark.parametrize("seed,k,beta", [(0, 6, 0.3), (1, 8, 0.5), (2, 12, 1.0), (3, 10, 0.05)])
def test_ladder_matrices_and_gaps_equal(seed, k, beta):
    e = _energies(seed, k, scale=1.0 + seed)
    np.testing.assert_array_equal(talg.ladder_stationary(e), jalg.ladder_stationary(e))
    pairs = [
        (talg.continuous_rate_matrix(e, beta), jalg.continuous_rate_matrix(e, beta)),
        (talg.discrete_transition_matrix(e, beta), jalg.discrete_transition_matrix(e, beta)),
        (talg.reduced_flip_transition_matrix(e, beta),
         jalg.reduced_flip_transition_matrix(e, beta)),
        (talg.embedded_jump_chain(e, beta), jalg.embedded_jump_chain(e, beta)),
    ]
    if beta == 1.0:
        pairs.append((talg.discrete_transition_matrix(e, beta, flip_on_reject=False),
                      jalg.discrete_transition_matrix(e, beta, flip_on_reject=False)))
    for mt, mj in pairs:
        np.testing.assert_array_equal(mt, mj)
    a, t = pairs[0][0], pairs[1][0]
    assert tspec.spectral_gap_continuous(a) == jspec.spectral_gap_continuous(a)
    assert tspec.spectral_gap_discrete(t) == jspec.spectral_gap_discrete(t)
    for mat, cont in ((a, True), (t, False)):
        np.testing.assert_array_equal(tspec.stationary_distribution(mat, cont),
                                      jspec.stationary_distribution(mat, cont))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("phi,nlags", [(0.5, None), (0.9, None), (0.8, 30)])
def test_empirical_spectral_gap(phi, nlags, weighted):
    rng = np.random.default_rng(int(phi * 10))
    t, d, n = 400, 3, 32
    x = np.zeros((t, d, n), np.float32)
    scale = np.array([0.5, 1.0, 1.0], np.float32)[:, None]  # dim 1 decays slowest
    rates = np.array([phi * 0.5, phi, phi * 0.7], np.float32)[:, None]
    for i in range(1, t):
        x[i] = rates * x[i - 1] + scale * rng.standard_normal((d, n)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, (t, n)).astype(np.float32) if weighted else None
    (jx, jw), (tx, tw) = _both(x, w)
    g_j = jspec.empirical_spectral_gap(jx, jw, nlags)
    g_t = tspec.empirical_spectral_gap(tx, tw, nlags)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-5)
    assert abs(g_t - (1 - phi)) < 0.1


def _jax_jump_draws(key, k, num_steps, nchains):
    """The JAX jump simulator's draws (algebraic.py:199-222): its initial
    rungs, then each step's Gumbel (3, nchains) and direction uniform."""
    key_init, key_scan = jax.random.split(key)
    s0 = jax.random.randint(key_init, (nchains,), 0, 2 * k)

    def step_draws(skey):
        kg, kr = jax.random.split(skey)
        return (jax.random.gumbel(kg, (3, nchains), jnp.float32),
                jax.random.uniform(kr, (nchains,)))

    gum, un = jax.vmap(step_draws)(jax.random.split(key_scan, num_steps))
    return np.array(s0), np.array(gum), np.array(un)


def _jax_discrete_draws(key, k, num_steps, nchains):
    """The JAX discrete simulator's draws (algebraic.py:261-277): its initial
    rungs, then each step's corruption and Metropolis uniforms."""
    ki, ks = jax.random.split(key)
    s0 = jax.random.randint(ki, (nchains,), 0, 2 * k)

    def step_draws(skey):
        kc, km, _ = jax.random.split(skey, 3)
        return jnp.stack([jax.random.uniform(kc, (nchains,)),
                          jax.random.uniform(km, (nchains,))])

    return np.array(s0), np.array(jax.vmap(step_draws)(jax.random.split(ks, num_steps)))


@pytest.mark.parametrize("seed,k,beta,num_steps,nchains", [
    (0, 6, 0.5, 300, 256), (1, 10, 0.1, 200, 128), (2, 4, 1.0, 250, 64)])
def test_simulate_jump_ladder_injected(seed, k, beta, num_steps, nchains):
    e = _energies(seed, k, scale=1.5)
    key = jax.random.key(seed + 7)
    sim_j = jalg.simulate_jump_ladder(e, beta, key, num_steps, nchains)
    s0, gum, un = _jax_jump_draws(key, k, num_steps, nchains)
    sim_t = talg.simulate_jump_ladder(e, beta, None, num_steps, nchains, device="cpu",
                                      s0=s0, gumbel=gum, uniform=un)
    np.testing.assert_allclose(sim_t.occupation.numpy(), np.asarray(sim_j.occupation), rtol=1e-5)
    np.testing.assert_allclose(float(sim_t.mean_dwell), float(sim_j.mean_dwell), rtol=1e-5)


@pytest.mark.parametrize("seed,k,beta,num_steps,nchains", [
    (0, 6, 0.5, 300, 256), (1, 10, 0.1, 200, 128), (2, 4, 1.0, 250, 64)])
def test_simulate_discrete_ladder_injected(seed, k, beta, num_steps, nchains):
    e = _energies(seed, k, scale=1.5)
    key = jax.random.key(seed + 11)
    occ_j = np.asarray(jalg.simulate_discrete_ladder(e, beta, key, num_steps, nchains))
    s0, uniforms = _jax_discrete_draws(key, k, num_steps, nchains)
    occ_t = talg.simulate_discrete_ladder(e, beta, None, num_steps, nchains, device="cpu",
                                          s0=s0, uniforms=uniforms)
    np.testing.assert_allclose(occ_t.numpy(), occ_j, rtol=1e-5)


def test_simulated_ladders_match_eigensolutions():
    """The oracle with the port's own draws (tests/test_ladder.py:56's size
    and tolerance for the jump chain): dwell-weighted occupation of the jump
    chain and occupation of control HMC against the exact stationary law."""
    gen = torch.Generator().manual_seed(1)
    e = talg.random_ladder_energies(gen, 6)
    assert e.dtype == np.float64 and e.shape == (6,)
    pi = talg.ladder_stationary(e)
    np.testing.assert_allclose(
        tspec.stationary_distribution(talg.continuous_rate_matrix(e, 0.5), continuous=True),
        pi, atol=1e-10)
    sim = talg.simulate_jump_ladder(e, 0.5, torch.Generator().manual_seed(42), 4000, 512,
                                    device="cpu")
    tv = 0.5 * np.abs(sim.occupation.numpy() - pi).sum()
    assert tv < 0.02, f"jump chain TV distance {tv}"
    occ = talg.simulate_discrete_ladder(e, 0.5, torch.Generator().manual_seed(43), 2000, 512,
                                        device="cpu")
    tv = 0.5 * np.abs(occ.numpy() - pi).sum()
    assert tv < 0.02, f"control HMC TV distance {tv}"


def test_random_ladder_energies():
    a = talg.random_ladder_energies(torch.Generator().manual_seed(5), 9, scale=2.0)
    b = talg.random_ladder_energies(torch.Generator().manual_seed(5), 9, scale=2.0)
    np.testing.assert_array_equal(a, b)
    z = torch.randn(9, generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a, (2.0 * z).numpy().astype(np.float64))


@pytest.mark.parametrize("sampler", ["mjhmc", "control"])
def test_diagnostics_cli_against_jax(sampler, tmp_path, capsys):
    path = str(tmp_path / f"{sampler}.npz")
    cli(["sample", "--config", "gauss2d", "--engine", "cuda", "--device", "cpu",
         "--sampler", sampler, "--nbatch", "32", "--burn", "20", "--steps", "120",
         "--save", path])
    capsys.readouterr()
    cli(["diagnostics", "--file", path, "--nlags", "40", "--device", "cpu"])
    rec_t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_cli(["diagnostics", "--file", path, "--nlags", "40"])
    rec_j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(rec_t) == sorted(rec_j)
    assert rec_t["file"] == rec_j["file"] and rec_t["shape"] == rec_j["shape"] == [120, 2, 32]
    for key in ("ess", "spectral_gap", "rhat_max", "rhat", "rho_first_lags"):
        np.testing.assert_allclose(rec_t[key], rec_j[key], rtol=1e-5, err_msg=key)


def test_diagnostics_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    path = str(tmp_path / "x.npz")
    np.savez(path, x=np.zeros((8, 2, 4), np.float32))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        cli(["diagnostics", "--file", path])
