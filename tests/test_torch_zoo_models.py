"""The zoo models (funnel, banana, Gaussian mixture, eight schools) and
their engine specs in the port, against the JAX package.

Inputs are made from a seed (the JAX models' exact or overdispersed
initial draws, as NumPy) and handed to both packages. Energies, gradients
and the specs' kernel forms agree to rtol 2e-5 (atol 2e-5 of the largest
value: XLA contracts and reorders float32 operations that torch rounds
one by one, and ``exp`` may round one ulp apart); the oracles are the same
float32 values, eight schools' float64 quadrature moments agree to rtol
1e-12 (the same NumPy grid code).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.models import eight_schools as jes
from mjhmc_tpu.ops.pallas_mjhmc import energy_spec_for
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.convert import distribution_from_jax
from mjhmc_tpu_torch.models import eight_schools as tes
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

MOG2 = dict(ndims=2, means=((-3.0, 1.0), (2.0, 0.0)), scales=(1.0, 0.5), weights=(0.3, 0.7))
CASES = [
    ("Funnel", dict(ndims=8)),
    ("Funnel", {}),
    ("Banana", dict(ndims=4)),
    ("Banana", {}),
    ("GaussianMixture", {}),
    ("GaussianMixture", MOG2),
    ("EightSchools", {}),
    ("EightSchools", dict(parameterization="noncentered")),
]
IDS = [f"{n}-{i}" for i, (n, _) in enumerate(CASES)]


def _pair(name, kw):
    return getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)


def _x(jd, prefix=(), n=64, seed=0):
    """The JAX model's own initial draws, as float32 NumPy."""
    x = np.asarray(jd.init_x(jax.random.key(seed), n * int(np.prod(prefix, dtype=int))))
    return x.reshape(jd.ndims, *prefix, n).transpose(*range(1, len(prefix) + 1), 0,
                                                       len(prefix) + 1).copy()


def _close(a, b, what, rtol=2e-5):
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=rtol,
                               atol=rtol * np.abs(b).max(), err_msg=what)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
@pytest.mark.parametrize("prefix", [(), (2,)])
def test_zoo_potential_and_grad_match_jax(name, kw, prefix):
    """U and ∇U on (d, n) and on a stacked (2, d, n) batch."""
    jd, td = _pair(name, kw)
    x = _x(jd, prefix)
    uj, gj = jd.potential_and_grad(jnp.asarray(x))
    ut, gt = td.potential_and_grad(torch.as_tensor(x))
    assert ut.shape == tuple(uj.shape) and gt.shape == tuple(gj.shape) == x.shape
    _close(ut, uj, "u")
    _close(gt, gj, "grad")
    _close(td.potential(torch.as_tensor(x)), jd.potential(jnp.asarray(x)), "potential")
    # the analytic gradient is the potential's (autograd fallback)
    u_a, g_a = tmodels.Distribution.potential_and_grad(td, torch.as_tensor(x))
    _close(g_a, gt, "autograd")


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_zoo_specs_match_jax_specs_and_models(name, kw):
    """The specs' kernel forms (du, u_sum on (d, n), params as the kernel
    takes them) against the JAX specs on the (d, 8, L) layout and against
    the port's own model."""
    jd, td = _pair(name, kw)
    x = _x(jd, n=128, seed=1)
    jspec, tspec = energy_spec_for(jd), cm.energy_spec_for(td)
    d = jd.ndims
    x3 = jnp.asarray(x).reshape(d, 8, 16)
    pv = np.asarray(jspec.param_vector(d))
    p3 = jnp.asarray(pv).reshape(-1, 1, 1) * jnp.ones((1, 8, 16), jnp.float32)
    if name != "GaussianMixture":  # JAX bakes the mixture's values into its kernel
        np.testing.assert_array_equal(tspec.param_vector(d), pv)
    assert len(tspec.constants()) == 5
    p = torch.as_tensor(tspec.param_vector(d))[:, None]
    xt = torch.as_tensor(x)
    ut, gt = tspec.u_sum(xt, p), tspec.du(xt, p)
    _close(ut, np.asarray(jspec.u_sum(x3, p3)).reshape(-1), "u vs JAX spec")
    _close(gt, np.asarray(jspec.du(x3, p3)).reshape(d, -1), "grad vs JAX spec")
    um, gm = td.potential_and_grad(xt)
    _close(ut, um, "u vs model")
    _close(gt, gm, "grad vs model")
    # a stacked pair of trajectories (the MJHMC body's forward and backward)
    st = torch.stack([xt, xt.flip(1)])
    assert torch.equal(tspec.du(st, p)[1], tspec.du(xt.flip(1), p))
    assert torch.equal(tspec.u_sum(st, p)[0], ut)


def test_zoo_spec_constants_and_routing():
    """energy_spec_for routes each model to its spec with JAX's fields;
    eight schools' two forms are two energies of the kernel; the mixture
    ships μ and its per-component constants in the params vector."""
    ids = set()
    for name, kw in CASES:
        jd, td = _pair(name, kw)
        jspec, tspec = energy_spec_for(jd), cm.energy_spec_for(td)
        assert isinstance(tspec, cm.ELEMENTWISE_SPECS)
        for f in ("ndims", "sigma_v", "a", "b", "means", "scales", "weights", "mu_scale",
                  "log_tau_scale", "y", "inv_sig2", "centered"):
            if hasattr(jspec, f):
                assert getattr(tspec, f) == getattr(jspec, f), f
        ids.add(tspec.energy_id)
    assert ids == {2, 3, 4, 5, 6}
    mog = cm.energy_spec_for(tmodels.GaussianMixture(**MOG2))
    pv = mog.param_vector(2)
    assert pv.shape == (2 * 2 + 4 * 2,) and mog.constants()[0] == 2.0
    np.testing.assert_array_equal(pv[:4], np.float32([-3.0, 1.0, 2.0, 0.0]))
    np.testing.assert_allclose(pv[4:6], [np.log(0.3) - 2 * np.log(1.0), np.log(0.7) - 2 * np.log(0.5)],
                               rtol=1e-6)
    np.testing.assert_allclose(pv[-2:], [10.0, 4.0], rtol=1e-6)  # ‖μ_k‖²


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_zoo_oracles_match_jax(name, kw):
    jd, td = _pair(name, kw)
    np.testing.assert_array_equal(td.analytic_mean().numpy(), np.asarray(jd.analytic_mean()))
    np.testing.assert_array_equal(td.analytic_var().numpy(), np.asarray(jd.analytic_var()))
    assert td.analytic_var().dtype == torch.float32


@pytest.mark.parametrize("param", ["centered", "noncentered"])
def test_eight_schools_quadrature_matches_jax(param):
    jd, td = _pair("EightSchools", dict(parameterization=param))
    for a, b in zip(tes._quad_moments(td), jes._quad_moments(jd)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    gt, gj = tes._quad_grid(td), jes._quad_grid(jd)
    np.testing.assert_array_equal(gt.w, gj.w)
    assert (gt.dmu, gt.dell) == (gj.dmu, gj.dell)
    np.testing.assert_array_equal(td.exact_sample(3, 500), jd.exact_sample(3, 500))


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_zoo_carry_across_and_hash(name, kw):
    """distribution_from_jax rebuilds the model from the JAX config_dict, as
    given and after a JSON round trip (tuples come back as lists): equal,
    hashable, the same stable hash and the same potential."""
    jd, td = _pair(name, kw)
    assert td.config_dict() == jd.config_dict()
    assert td.stable_hash() == jd.stable_hash()
    for cfg in (jd.config_dict(), json.loads(json.dumps(jd.config_dict()))):
        back = distribution_from_jax(cfg)
        assert back == td and hash(back) == hash(td)
        assert back.stable_hash() == jd.stable_hash()
        x = _x(jd, seed=2)
        _close(back.potential(torch.as_tensor(x)), jd.potential(jnp.asarray(x)), "potential")


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_zoo_init_x_draws_from_the_generator(name, kw):
    """Same seed, same chains; float32 (ndims, nbatch); the exact draws
    (funnel, banana, mixture) have the analytic variances."""
    _, td = _pair(name, kw)
    a = td.init_x(torch.Generator().manual_seed(4), 8192, "cpu")
    b = td.init_X(torch.Generator().manual_seed(4), 8192, "cpu")
    assert a.shape == (td.ndims, 8192) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert not torch.equal(a, td.init_x(torch.Generator().manual_seed(5), 8192, "cpu"))
    if name == "EightSchools":
        return  # an overdispersed start, not a posterior draw
    var = a.double().var(dim=1)
    ratio = var / td.analytic_var().double()
    # the funnel's x_i have heavy tails (E[e^{2v}] is e^{2σ_v²}): v only
    rows = ratio[:1] if name == "Funnel" else ratio
    assert float((rows - 1).abs().max()) < 0.1, ratio
