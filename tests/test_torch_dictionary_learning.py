"""The port's dictionary learner (``mjhmc_tpu_torch.models.dictionary_learning``)
against JAX's, with JAX's draws injected, JAX's own statistics on the
port's draws, and the port's copy of the shipped Φ."""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu.models import dictionary_learning as jdl
from mjhmc_tpu_torch.models import dictionary_learning as tdl
from mjhmc_tpu_torch.models import sparse_coding as tsc
from mjhmc_tpu_torch.models.sparse_coding import SparseCoding

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


def _jax_noise(key, n, side):
    """JAX's complex draws of natural_patches (kr real parts, ki imaginary)."""
    kr, ki = jax.random.split(key)
    re = np.array(jax.random.normal(kr, (n, side, side), jnp.float32))
    im = np.array(jax.random.normal(ki, (n, side, side), jnp.float32))
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im))


def test_natural_patches_match_jax_on_its_draws():
    # the shape the other tests trace JAX's function at (one compile)
    key, side, n, alpha = jax.random.key(3), 8, 32, 1.0
    want = np.asarray(jdl.natural_patches(key, n, side, alpha))
    got = tdl.natural_patches(None, n, side, alpha, device=CPU, noise=_jax_noise(key, n, side))
    assert got.shape == (side * side, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _codes_case(seed):
    rng = np.random.default_rng(seed)
    phi = rng.standard_normal((64, 128)).astype(np.float32)
    phi /= np.linalg.norm(phi, axis=0, keepdims=True)
    x = np.array(jdl.natural_patches(jax.random.key(seed), 32, 8))
    return phi, x


@pytest.mark.parametrize("seed", [0, 1])
def test_lambda_max_and_ista_codes_match_jax(seed):
    """λmax at rtol 1e-5; the codes at rtol 1e-5 / atol 1e-6, but a code
    within 1e-5 of the soft threshold may land on the other side of it in
    another summation order (counted, at most 0.5% of the codes)."""
    phi, x = _codes_case(seed)
    lm_j = float(jdl._lambda_max(jnp.asarray(phi)))
    lm_t = float(tdl._lambda_max(torch.from_numpy(phi)))
    np.testing.assert_allclose(lm_t, lm_j, rtol=1e-5)
    a_j = np.asarray(jdl.ista_codes(jnp.asarray(phi), jnp.asarray(x), 8.0, 0.316, 20))
    a_t = tdl.ista_codes(torch.from_numpy(phi), torch.from_numpy(x), 8.0, 0.316, 20).numpy()
    close = np.isclose(a_t, a_j, rtol=1e-5, atol=1e-6)
    near = (np.abs(a_j) < 1e-5) | (np.abs(a_t) < 1e-5)
    assert np.all(close | near), np.abs(a_t - a_j)[~(close | near)].max()
    flips = int(np.sum(~close & near))
    assert flips <= 0.005 * a_j.size, flips
    assert 0.02 < float(np.mean(np.abs(a_t) > 1e-6)) < 0.6


def test_learn_dictionary_matches_jax_on_its_start_and_patches():
    """5 steps (batch 32, 10 ISTA iterations) from JAX's Φ₀ and per-step
    patches: Φ at rtol 1e-4, the per-step error and active share close."""
    key, steps, batch, iters = jax.random.key(0), 5, 32, 10
    k0, kloop = jax.random.split(key)
    phi0 = np.array(jax.random.normal(k0, (64, 128), jnp.float32))
    xs = np.stack([np.asarray(jdl.natural_patches(k, batch, 8))
                   for k in jax.random.split(kloop, steps)])
    want = jdl.learn_dictionary(key, num_steps=steps, batch=batch, ista_iters=iters)
    got = tdl.learn_dictionary(None, num_steps=steps, batch=batch, ista_iters=iters,
                               device=CPU, phi0=torch.from_numpy(phi0),
                               patches=torch.from_numpy(xs))
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(want.phi), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.recon_err.numpy(), np.asarray(want.recon_err), rtol=1e-4)
    np.testing.assert_allclose(got.code_l0.numpy(), np.asarray(want.code_l0), atol=2e-3)
    # the callable form gives the same run
    again = tdl.learn_dictionary(None, num_steps=steps, batch=batch, ista_iters=iters,
                                 device=CPU, phi0=torch.from_numpy(phi0),
                                 patches=lambda s: torch.from_numpy(xs[s]))
    torch.testing.assert_close(again.phi, got.phi, rtol=0, atol=0)


# JAX's four statistics (tests/test_dictionary_learning.py) on the port's draws
def test_natural_patches_statistics():
    x = tdl.natural_patches(torch.Generator().manual_seed(0), 64, 8, device=CPU).numpy()
    assert x.shape == (64, 64)
    np.testing.assert_allclose(x.mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(x.std(axis=0), 1.0, atol=0.02)
    f = np.abs(np.fft.fft2(x[:, 0].reshape(8, 8)))
    assert f[0, 1] + f[1, 0] > f[4, 4]


def test_ista_sparsifies_and_reconstructs():
    phi = torch.from_numpy(tdl.load_pretrained(64, 128))
    x = tdl.natural_patches(torch.Generator().manual_seed(1), 32, 8, device=CPU)
    a = tdl.ista_codes(phi, x, lam=8.0, sigma=0.316, num_iters=60)
    assert 0.02 < float((a.abs() > 1e-6).float().mean()) < 0.6
    resid = x - phi @ a
    assert float((resid ** 2).mean()) < 0.6 * float((x ** 2).mean())


def test_learning_reduces_reconstruction_error():
    out = tdl.learn_dictionary(torch.Generator().manual_seed(0), num_steps=40, batch=64,
                               ista_iters=25, device=CPU)
    err = out.recon_err.numpy()
    assert err.shape == (40,) and err[-1] < 0.8 * err[0], (err[0], err[-1])
    np.testing.assert_allclose(torch.linalg.vector_norm(out.phi, dim=0).numpy(), 1.0,
                               atol=1e-4)


def test_shipped_artifact_drives_default_sparse_coding():
    phi = tdl.load_pretrained(64, 128)
    assert phi is not None and phi.shape == (64, 128)
    np.testing.assert_allclose(np.linalg.norm(phi, axis=0), 1.0, atol=1e-4)
    dist = SparseCoding()
    assert dist.uses_pretrained_phi
    np.testing.assert_array_equal(dist._phi, phi)
    x = dist.init_x(torch.Generator().manual_seed(0), 16)
    u, g = dist.potential_and_grad(x)
    assert torch.isfinite(u).all() and torch.isfinite(g).all()
    gab = SparseCoding(phi_source="gabor")
    assert not gab.uses_pretrained_phi and not np.allclose(gab._phi, phi)


def test_port_ships_its_own_phi():
    """The port's Φ is a byte-for-byte copy of the JAX package's, and the
    port reads it from its own tree."""
    ours = ROOT / "mjhmc_tpu_torch" / "data" / "phi_64x128.npz"
    theirs = ROOT / "mjhmc_tpu" / "data" / "phi_64x128.npz"
    assert hashlib.sha256(ours.read_bytes()).digest() == \
        hashlib.sha256(theirs.read_bytes()).digest()
    assert tsc.DATA_DIR.resolve() == (ROOT / "mjhmc_tpu_torch" / "data").resolve()
    assert tsc._phi_path(64, 128).resolve() == ours.resolve()
    assert tdl.DATA_DIR == tsc.DATA_DIR


def test_save_load_and_cli(tmp_path, capsys):
    phi = np.random.default_rng(0).standard_normal((16, 24)).astype(np.float32)
    path = tdl.save_pretrained(phi, {"seed": 7}, tmp_path)
    assert Path(path) == tmp_path / "phi_16x24.npz"
    np.testing.assert_array_equal(tdl.load_pretrained(16, 24, tmp_path), phi)
    assert int(np.load(path)["meta_seed"]) == 7
    assert tdl.load_pretrained(16, 25, tmp_path) is None

    out = tmp_path / "cli"
    assert tdl.main(["--device", "cpu", "--out", str(out), "--npixels", "16", "--nbasis",
                     "24", "--steps", "12", "--batch", "32", "--seed", "3"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["path"] == str(out / "phi_16x24.npz") and rec["device"] == "cpu"
    assert set(rec) >= {"recon_err_first", "recon_err_last", "code_l0_last"}
    art = np.load(rec["path"])
    assert art["phi"].shape == (16, 24) and int(art["meta_steps"]) == 12
    np.testing.assert_allclose(np.linalg.norm(art["phi"], axis=0), 1.0, atol=1e-4)
    assert float(art["meta_final_recon_err"]) == pytest.approx(rec["recon_err_last"])
    # nothing was written into the package
    assert not tsc._phi_path(16, 24).exists()
