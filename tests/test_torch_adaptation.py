"""Dual-averaging adaptation and the Stan-style warmups in the port
(``samplers/adaptation.py``), against ``mjhmc_tpu.samplers.adaptation``, and
the engines' ``from_warmup``.

``da_update`` fed the same acceptance means must track the JAX update to
float32 rounding (rtol 2e-6: both take the same float32 operations in the
same order; ``log``, ``sqrt`` and ``pow`` may round one ulp apart). The
warmups run the port's own samplers, so they are held to what the JAX
tests hold theirs to: a variance-estimated M⁻¹ on gauss2d (variances 1 and
100) whose spread is > 3, a finite, positive ε, and an ε that brings HMC's
acceptance near its target.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjhmc_tpu.samplers import adaptation as jad
from mjhmc_tpu_torch.models import Gaussian, ProductOfT
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm
from mjhmc_tpu_torch.samplers import (
    adaptive_hmc_run,
    adaptive_malt_run,
    adaptive_mjhmc_run,
    da_epsilon,
    da_init,
    da_update,
    hmc_run,
    make_hmc_state,
    make_mj_state,
    mjhmc_full_warmup,
    nuts_full_warmup,
)

torch.set_num_threads(1)

G2 = dict(ndims=2, log_conditioning=2.0)


@pytest.mark.parametrize("eps0,target", [(0.5, 0.65), (8.0, 0.8)])
def test_da_update_matches_jax(eps0, target):
    accepts = np.random.default_rng(0).uniform(size=60).astype(np.float32)
    dt, dj = da_init(eps0), jad.da_init(eps0)
    for a in accepts:
        dt = da_update(dt, torch.tensor(a), target=target)
        dj = jad.da_update(dj, jnp.float32(a), target=target)
        assert dt.step == int(dj.step)
        for f in ("log_eps", "log_eps_bar", "h_bar", "mu"):
            assert isinstance(getattr(dt, f), np.float32)
            np.testing.assert_allclose(getattr(dt, f), np.asarray(getattr(dj, f)), rtol=2e-6,
                                       atol=1e-7, err_msg=f)
    for frozen in (False, True):
        np.testing.assert_allclose(da_epsilon(dt, frozen), float(jad.da_epsilon(dj, frozen)),
                                   rtol=4e-6)


def test_da_update_monotone_response():
    """Acceptance above target must raise ε, below target lower it."""
    hi, lo = da_init(0.5), da_init(0.5)
    for _ in range(20):
        hi, lo = da_update(hi, 0.99), da_update(lo, 0.10)
    assert da_epsilon(hi) > 0.5 > da_epsilon(lo)


def test_hmc_adaptation_reaches_target():
    dist = Gaussian(ndims=10, log_conditioning=2.0)
    gen = torch.Generator().manual_seed(0)
    state = make_hmc_state(dist, gen, 128)
    state, da, aux = adaptive_hmc_run(dist, state, da_init(8.0), gen, 200, 1.0, 5, 0.65)
    assert aux["eps_trace"].shape == (200,) and aux["moments"].w.shape == (128,)
    eps = da_epsilon(da, frozen=True)
    assert 0.005 < eps < 4.0  # pulled back below the stability limit
    _, out = hmc_run(dist, state, gen, 100, eps, 1.0, 5)
    assert 0.45 < float(out["accept_stat"].mean()) < 0.95


@pytest.mark.parametrize("which", ["mjhmc", "malt"])
def test_adaptive_runs_stabilize(which):
    dist = ProductOfT(ndims=8, nbasis=8, nu=4.0)
    gen = torch.Generator().manual_seed(3)
    if which == "mjhmc":
        state = make_mj_state(dist, gen, 64)
        state, da, aux = adaptive_mjhmc_run(dist, state, da_init(2.0), gen, 150, 0.1, 5)
    else:
        state = make_hmc_state(dist, gen, 64)
        state, da, aux = adaptive_malt_run(dist, state, da_init(2.0), gen, 150, 1.0, 5)
    trace = aux["eps_trace"].numpy()
    assert np.isfinite(trace).all()
    late = trace[-50:]
    assert late.std() / late.mean() < 0.5
    assert 1e-4 < da_epsilon(da, frozen=True) < 10.0
    assert bool(torch.isfinite(aux["moments"].var()).all())


@pytest.mark.parametrize("which", ["nuts", "mjhmc"])
def test_full_warmup_learns_the_metric(which):
    gen = torch.Generator().manual_seed(3)
    if which == "nuts":
        state, eps, inv_mass = nuts_full_warmup(Gaussian(**G2), gen, 128, max_depth=6, phase1=8,
                                                phase2=8, phase3=6, device="cpu")
        assert state.x.shape == (2, 128)
    else:
        state, eps, inv_mass = mjhmc_full_warmup(Gaussian(**G2), gen, 128, beta=0.2,
                                                 num_leapfrog_steps=5, phase1=40, phase2=60,
                                                 phase3=20, device="cpu")
        assert state.chain.x.shape == (2, 128) and state.back_valid.dtype == torch.bool
    iv = inv_mass.double().numpy().ravel()
    assert inv_mass.shape == (2, 1) and (iv > 0).all() and eps > 0.0
    # the variance-estimated M⁻¹ must reflect the 10² conditioning spread
    assert iv.max() / iv.min() > 3.0, iv


def test_from_warmup_builds_tuned_engines():
    """device='cpu': the engines take the warmup's (ε, M⁻¹); MJHMC also
    its warmed chains; NUTS starts from fresh inits and is capped at 1,024
    warmup chains."""
    dist = Gaussian(**G2)
    nuts = cm.CudaNUTS.from_warmup(dist, seed=3, nbatch=256, max_depth=6, device="cpu",
                                   phase1=8, phase2=8, phase3=6)
    assert (nuts.variant, nuts.num_leapfrog_steps, nuts.nbatch) == ("nuts", 6, 256)
    iv = np.asarray(nuts.inv_mass, np.float64)
    assert nuts.epsilon > 0.0 and iv.shape == (2,) and (iv > 0).all() and iv.max() / iv.min() > 3
    out = nuts.run(3)
    assert bool((out.w == 3).all()) and int(out.evals.min()) >= 3

    mj = cm.CudaMJHMC.from_warmup(dist, seed=4, nbatch=128, beta=0.2, num_leapfrog_steps=5,
                                  device="cpu", phase1=40, phase2=60, phase3=20)
    iv = np.asarray(mj.inv_mass, np.float64)
    assert mj.epsilon > 0.0 and iv.shape == (2,) and iv.max() / iv.min() > 3
    assert mj.x.shape == (2, 128) and mj.back_valid.dtype == torch.float32
    # the warmed chains: their energies are the state's own
    u, g = dist.potential_and_grad(mj.x)
    torch.testing.assert_close(mj.u, u)
    torch.testing.assert_close(mj.g, g)
    out = mj.run(5)
    assert int(out.evals.min()) >= 25 and bool(torch.isfinite(out.x).all())


def test_nuts_from_warmup_tunes_at_depth_8(monkeypatch):
    """CudaNUTS.from_warmup runs nuts_full_warmup at its own default depth
    (8), whatever max_depth the engine takes, as PallasNUTS.from_warmup does;
    the engine then runs at its max_depth."""
    seen = {}
    default = inspect.signature(nuts_full_warmup).parameters["max_depth"].default

    def fake_warmup(dist, gen, nbatch, **kw):
        seen.update(kw, nbatch=nbatch, depth=kw.get("max_depth", default))
        return None, 0.3, torch.ones((dist.ndims, 1))

    monkeypatch.setattr(cm, "nuts_full_warmup", fake_warmup)
    eng = cm.CudaNUTS.from_warmup(Gaussian(**G2), seed=1, nbatch=64, max_depth=4, device="cpu",
                                  phase1=2)
    assert seen["depth"] == 8 and "max_depth" not in seen
    assert seen["phase1"] == 2 and seen["nbatch"] == 64 and seen["device"] == "cpu"
    assert eng.num_leapfrog_steps == 4 and eng.epsilon == 0.3
