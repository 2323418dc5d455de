"""The port's matmul-energy models vs the JAX ones: product of t and sparse
coding. Inputs are made with NumPy from a seed and handed to both."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.models import sparse_coding as jsc
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.convert import distribution_from_jax
from mjhmc_tpu_torch.models import sparse_coding as tsc
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

CASES = [
    ("ProductOfT", dict(), 2.0),
    ("ProductOfT", dict(ndims=8, nbasis=12, nu=4.0, basis_seed=3), 2.0),
    ("SparseCoding", dict(), 0.1),
    ("SparseCoding", dict(npixels=16, nbasis=24, phi_source="gabor", lam=0.5), 0.1),
]


def _pair(name, kw):
    return getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)


def _x(dist, scale, prefix=(), n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(prefix + (dist.ndims, n))).astype(np.float32)


@pytest.mark.parametrize("name,kw,scale", CASES)
@pytest.mark.parametrize("prefix", [(), (2,)])
def test_potential_and_grad_match_jax(name, kw, scale, prefix):
    """U and ∇U agree with JAX to rtol 1e-5 (atol 1e-5 of the largest
    value), on (d, n) and on a stacked (2, d, n) batch."""
    jd, td = _pair(name, kw)
    x = _x(jd, scale, prefix)
    uj, gj = (np.asarray(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    ut, gt = (a.numpy() for a in td.potential_and_grad(torch.as_tensor(x)))
    assert ut.shape == uj.shape == x.shape[:-2] + x.shape[-1:] and gt.shape == x.shape
    np.testing.assert_allclose(ut, uj, rtol=1e-5, atol=1e-5 * np.abs(uj).max())
    np.testing.assert_allclose(gt, gj, rtol=1e-5, atol=1e-5 * np.abs(gj).max())
    up = td.potential(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(up, np.asarray(jd.potential(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5 * np.abs(uj).max())
    # the engine spec's forms are the model's
    spec = dataclasses.replace(cm.energy_spec_for(td), precision="highest")  # the model's f32
    p = cm._param_tensors(spec, td.ndims, "cpu")
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(spec.u_sum(xt, *p).numpy(), ut, rtol=1e-5,
                               atol=1e-5 * np.abs(ut).max())
    np.testing.assert_allclose(spec.du(xt, *p).numpy(), gt, rtol=1e-5,
                               atol=1e-5 * np.abs(gt).max())


@pytest.mark.parametrize("name,kw,scale", CASES)
def test_hash_parameters_and_init_match_jax(name, kw, scale):
    """Same config_dict and stable_hash; W, or Φ and the patch, bit-equal to
    the JAX package's; the converted distribution is equal; init_x has the
    JAX init's scale."""
    jd, td = _pair(name, kw)
    assert td.config_dict() == jd.config_dict()
    assert td.stable_hash() == jd.stable_hash()
    back = distribution_from_jax(jd.config_dict())
    assert back == td and back.stable_hash() == jd.stable_hash()
    if name == "ProductOfT":
        np.testing.assert_array_equal(td._basis, jd._basis)
        np.testing.assert_array_equal(td.basis().numpy(), np.asarray(jd.basis))
    else:
        np.testing.assert_array_equal(td._phi, jd._phi)
        np.testing.assert_array_equal(td._patch, jd._patch)
        np.testing.assert_array_equal(td.patch_array()[:, None], np.asarray(jd.patch))
        assert td.uses_pretrained_phi == jd.uses_pretrained_phi
    a = td.init_x(torch.Generator().manual_seed(4), 4096, "cpu")
    assert a.shape == (td.ndims, 4096) and a.dtype == torch.float32
    assert abs(float(a.std()) / scale - 1) < 0.02


def test_pretrained_phi_is_read_by_path():
    """The config-5 dictionary comes from the port's own copy of the shipped
    file (``mjhmc_tpu_torch/data``), read with NumPy, and equals JAX's;
    without it the Gabor bank is the fallback, as in JAX."""
    td = tmodels.SparseCoding()
    assert td.uses_pretrained_phi and tsc._phi_path(64, 128).exists()
    assert tsc._phi_path(64, 128).parent.parent.name == "mjhmc_tpu_torch"
    np.testing.assert_array_equal(tsc.load_pretrained(64, 128),
                                  jmodels.SparseCoding()._phi)
    assert tsc.load_pretrained(16, 24) is None
    np.testing.assert_array_equal(tsc._gabor_dictionary(16, 24, 5),
                                  jsc._gabor_dictionary(16, 24, 5))
    with pytest.raises(FileNotFoundError):
        tmodels.SparseCoding(npixels=16, nbasis=24, phi_source="pretrained")._phi


def test_analytic_moments_match_jax():
    for kw in (dict(), dict(ndims=8, nbasis=8, nu=4.0, basis_seed=3)):
        jd, td = _pair("ProductOfT", kw)
        np.testing.assert_allclose(td.analytic_var().numpy(), np.asarray(jd.analytic_var()),
                                   rtol=1e-6)
        np.testing.assert_array_equal(td.analytic_mean().numpy(),
                                      np.asarray(jd.analytic_mean()))
    assert tmodels.ProductOfT(ndims=8, nbasis=12).analytic_var() is None
    assert tmodels.ProductOfT(nu=2.0).analytic_var() is None


def test_with_patch_round_trips_from_jax():
    """A user patch: the JAX config_dict carries it as a list, the converted
    distribution holds it as a tuple, and energies agree."""
    rng = np.random.default_rng(2)
    patch = rng.standard_normal(16).astype(np.float32)
    jd = jmodels.SparseCoding.with_patch(patch, nbasis=24, lam=0.7)
    td = distribution_from_jax(jd.config_dict())
    assert td == tmodels.SparseCoding.with_patch(patch, nbasis=24, lam=0.7)
    assert isinstance(td.custom_patch, tuple) and td.stable_hash() == jd.stable_hash()
    np.testing.assert_array_equal(td.patch_array(), patch)
    x = _x(jd, 0.1)
    uj, gj = (np.asarray(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    ut, gt = (a.numpy() for a in td.potential_and_grad(torch.as_tensor(x)))
    np.testing.assert_allclose(ut, uj, rtol=1e-5)
    np.testing.assert_allclose(gt, gj, rtol=1e-5, atol=1e-5 * np.abs(gj).max())
