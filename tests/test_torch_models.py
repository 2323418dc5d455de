"""Port models vs the JAX models: energies, gradients, hashes, presets.

Inputs are made with NumPy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu import config as jconfig
from mjhmc_tpu import models as jmodels
from mjhmc_tpu_torch import config as tconfig
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.convert import distribution_from_jax

torch.set_num_threads(1)

CASES = [
    ("RoughWell", dict(ndims=2)),
    ("RoughWell", dict(ndims=3, scale1=50.0, scale2=2.0, amplitude=3.0)),
    ("Gaussian", dict(ndims=2, log_conditioning=2.0)),
    ("Gaussian", dict(ndims=50, log_conditioning=4.0)),
]


def _pair(name, kw):
    return getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)


def _x(dist, shape_prefix=(), n=64, seed=0):
    scale = np.sqrt(np.asarray(dist.analytic_var(), np.float64))[:, None]
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape_prefix + (dist.ndims, n))).astype(np.float32)


@pytest.mark.parametrize("name,kw", CASES)
@pytest.mark.parametrize("prefix", [(), (2,)])
def test_potential_and_grad_match_jax(name, kw, prefix):
    """U and ∇U agree with JAX to rtol 1e-5, on (d, n) and on a stacked
    (2, d, n) batch (energies reduce axis −2)."""
    jd, td = _pair(name, kw)
    x = _x(jd, prefix)
    uj, gj = (np.asarray(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    ut, gt = (a.numpy() for a in td.potential_and_grad(torch.as_tensor(x)))
    assert ut.shape == uj.shape == x.shape[:-2] + x.shape[-1:]
    np.testing.assert_allclose(ut, uj, rtol=1e-5, atol=1e-5 * np.abs(uj).max())
    np.testing.assert_allclose(gt, gj, rtol=1e-5, atol=1e-5 * np.abs(gj).max())
    np.testing.assert_allclose(td.E(torch.as_tensor(x)).numpy(), uj, rtol=1e-5,
                               atol=1e-5 * np.abs(uj).max())
    np.testing.assert_allclose(td.dEdX(torch.as_tensor(x)).numpy(), gj, rtol=1e-5,
                               atol=1e-5 * np.abs(gj).max())


@pytest.mark.parametrize("name,kw", CASES)
def test_autograd_fallback_matches_analytic_gradient(name, kw):
    _, td = _pair(name, kw)
    x = torch.as_tensor(_x(td, seed=1))
    u_a, g_a = tmodels.Distribution.potential_and_grad(td, x)
    u, g = td.potential_and_grad(x)
    assert not g_a.requires_grad and not u_a.requires_grad
    torch.testing.assert_close(u_a, u, rtol=1e-5, atol=1e-5 * float(u.abs().max()))
    torch.testing.assert_close(g_a, g, rtol=1e-5, atol=1e-5 * float(g.abs().max()))


@pytest.mark.parametrize("name,kw", CASES)
def test_stable_hash_and_config_match_jax(name, kw):
    jd, td = _pair(name, kw)
    assert td.config_dict() == jd.config_dict()
    assert td.stable_hash() == jd.stable_hash()
    back = distribution_from_jax(jd.config_dict())
    assert back == td and back.stable_hash() == jd.stable_hash()


@pytest.mark.parametrize("name,kw", CASES)
def test_analytic_moments_match_jax(name, kw):
    jd, td = _pair(name, kw)
    np.testing.assert_allclose(td.analytic_var().numpy(), np.asarray(jd.analytic_var()),
                               rtol=1e-6)
    np.testing.assert_array_equal(td.analytic_mean().numpy(), np.asarray(jd.analytic_mean()))


@pytest.mark.parametrize("name,kw", CASES)
def test_init_x_shape_scale_and_generator(name, kw):
    """init_x draws from the explicit generator: same seed, same chains;
    the init_X alias agrees; the spread matches the target's scale."""
    _, td = _pair(name, kw)
    a = td.init_x(torch.Generator().manual_seed(4), 4096, "cpu")
    b = td.init_X(torch.Generator().manual_seed(4), 4096, "cpu")
    assert a.shape == (td.ndims, 4096) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    if name == "Gaussian":
        ratio = a.var(dim=1) / td.analytic_var()
        assert float((ratio - 1).abs().max()) < 0.1
    else:
        assert abs(float(a.std()) / td.scale1 - 1) < 0.05


def test_registry_and_presets():
    """Every JAX model is registered under its JAX name; every preset's
    distribution hashes alike in both packages; unknown names raise."""
    from mjhmc_tpu.models import registry as jregistry

    assert set(tmodels.registry()) == set(jregistry())
    assert isinstance(tmodels.get_distribution("rough_well"), tmodels.RoughWell)
    assert isinstance(tmodels.get_distribution("funnel"), tmodels.Funnel)
    with pytest.raises(KeyError, match="no distribution"):
        tmodels.get_distribution("nope")
    with pytest.raises(KeyError, match="no distribution"):
        distribution_from_jax({"__class__": "Nope"})
    jc, tc = jconfig.BENCHMARK_CONFIGS, tconfig.BENCHMARK_CONFIGS
    assert set(jc) == set(tc)
    for key in jc:
        assert dataclass_values(jc[key]) == dataclass_values(tc[key])
        jd, td = jc[key].make_distribution(), tc[key].make_distribution()
        assert td.stable_hash() == jd.stable_hash()


def dataclass_values(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
