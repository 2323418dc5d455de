"""Port integrators vs ``mjhmc_tpu.ops.leapfrog`` (d=2, n=64, M=10)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu import models as jmodels
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.ops import leapfrog as tlf

# the JAX package's ops/__init__ re-exports the function under the module's name
jlf = importlib.import_module("mjhmc_tpu.ops.leapfrog")

torch.set_num_threads(1)

DISTS = [
    ("RoughWell", dict(ndims=2), 1.0),
    ("Gaussian", dict(ndims=2, log_conditioning=2.0), 0.3),
]


def _inputs(jd, n=64, seed=0):
    rng = np.random.default_rng(seed)
    scale = np.sqrt(np.asarray(jd.analytic_var(), np.float64))[:, None]
    x = (scale * rng.standard_normal((jd.ndims, n))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, n)).astype(np.float32)
    return x, v


def _close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("name,kw,eps", DISTS)
@pytest.mark.parametrize("integrator", ["leapfrog", "two_stage"])
@pytest.mark.parametrize("mass", [False, True])
def test_integrator_matches_jax(name, kw, eps, integrator, mass):
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    x, v = _inputs(jd)
    inv_mass = np.asarray([[0.5], [2.0]], np.float32) if mass else None
    _, g = jd.potential_and_grad(jnp.asarray(x))
    g = np.array(g)  # writable copy for torch.as_tensor
    jfn, jcost = jlf.INTEGRATORS[integrator]
    tfn, tcost = tlf.INTEGRATORS[integrator]
    assert jcost == tcost
    outj = jfn(jd.potential_and_grad, jnp.asarray(x), jnp.asarray(v), jnp.asarray(g),
               eps, 10, inv_mass=None if inv_mass is None else jnp.asarray(inv_mass))
    outt = tfn(td.potential_and_grad, torch.as_tensor(x), torch.as_tensor(v),
               torch.as_tensor(g), eps, 10,
               inv_mass=None if inv_mass is None else torch.as_tensor(inv_mass))
    for a, b in zip(outt, outj):
        _close(a, b)


def test_leapfrog_stacked_pair_and_reversibility():
    """A stacked (2, d, n) batch integrates each half as if alone, and
    leapfrog(x', -v') returns to (x, -v)."""
    td = tmodels.RoughWell(ndims=2)
    jd = jmodels.RoughWell(ndims=2)
    x, v = _inputs(jd, seed=3)
    x, v = torch.as_tensor(x), torch.as_tensor(v)
    _, g = td.potential_and_grad(x)
    xs, vs, us, gs = tlf.leapfrog(td.potential_and_grad, torch.stack([x, x]),
                                  torch.stack([v, -v]), torch.stack([g, g]), 1.0, 10)
    xf, vf, uf, gf = tlf.leapfrog(td.potential_and_grad, x, v, g, 1.0, 10)
    xb, vb, ub, gb = tlf.leapfrog(td.potential_and_grad, x, -v, g, 1.0, 10)
    for a, b in ((xs[0], xf), (vs[0], vf), (us[0], uf), (xs[1], xb), (vs[1], vb), (us[1], ub)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x2, v2, _, _ = tlf.leapfrog(td.potential_and_grad, xf, -vf, gf, 1.0, 10)
    torch.testing.assert_close(x2, x, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(-v2, v, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mass", [False, True])
def test_energies_match_jax(mass):
    rng = np.random.default_rng(5)
    v = rng.standard_normal((2, 3, 16)).astype(np.float32)
    u = rng.standard_normal((2, 16)).astype(np.float32)
    im = np.asarray([[0.5], [2.0], [4.0]], np.float32) if mass else None
    jim = None if im is None else jnp.asarray(im)
    tim = None if im is None else torch.as_tensor(im)
    _close(tlf.kinetic_energy(torch.as_tensor(v), tim), jlf.kinetic_energy(jnp.asarray(v), jim))
    _close(tlf.total_energy(torch.as_tensor(u), torch.as_tensor(v), tim),
           jlf.total_energy(jnp.asarray(u), jnp.asarray(v), jim))
    if mass:
        _close(tlf.momentum_scale(tim), jlf.momentum_scale(jim))
    else:
        assert tlf.momentum_scale(None) == jlf.momentum_scale(None) == 1.0
