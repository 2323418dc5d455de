"""The plain NUTS sampler (``samplers/nuts.py``): the invariants of the JAX
package's ``tests/test_nuts.py`` (depth bounds, leaf counting, divergence at
a huge ε, none at a small one), its law against analytic Gaussian variances
and the JAX ``NUTS``'s mean tree size, and ``sample --engine torch
--sampler nuts``.

The two samplers draw from different generators, so they agree in law: the
variances within the JAX test's 20% (4-D, 400 iterations of 256 chains)
and the mean leaves per iteration within 6% of the JAX sampler's at the
same ε and max_depth (a few percent of Monte Carlo error at these sizes).
"""

import json

import numpy as np
import torch

from mjhmc_tpu.models import Gaussian as JGaussian
from mjhmc_tpu.samplers import NUTS as JNUTS
from mjhmc_tpu_torch.__main__ import main as cli
from mjhmc_tpu_torch.models import Gaussian
from mjhmc_tpu_torch.samplers import NUTS, make_nuts_state, nuts_step

torch.set_num_threads(1)


def test_gaussian_moments_and_tree_size_match_jax():
    kw = dict(ndims=4, log_conditioning=1.5)
    s = NUTS(Gaussian(**kw), epsilon=0.4, max_depth=6, nbatch=256, seed=0, device="cpu")
    s.burn_in(100)
    out = s.sample(400)
    xs = out["x"].double().numpy()
    tgt = Gaussian(**kw).analytic_var().double().numpy()
    np.testing.assert_allclose(xs.mean(axis=(0, 2)), 0.0, atol=3.5 * np.sqrt(tgt.max() / 400))
    np.testing.assert_allclose(xs.var(axis=(0, 2)), tgt, rtol=0.2)
    ev = out["evals_mean"].double().numpy()
    leaves = (ev[-1] - ev[0]) / 399

    ref = JNUTS(JGaussian(**kw), epsilon=0.4, max_depth=6, nbatch=256, seed=1)
    ref.burn_in(100)
    ev = np.asarray(ref.sample(400)["evals_mean"], np.float64)
    leaves_jax = (ev[-1] - ev[0]) / 399
    assert abs(leaves / leaves_jax - 1) < 0.06, (leaves, leaves_jax)


def test_depth_scales_with_epsilon():
    """Smaller ε ⇒ more leapfrogs to the U-turn ⇒ deeper trees."""
    dist = Gaussian(ndims=2, log_conditioning=0.0)
    deep = NUTS(dist, epsilon=0.05, max_depth=7, nbatch=128, seed=1, device="cpu")
    shallow = NUTS(dist, epsilon=0.8, max_depth=7, nbatch=128, seed=1, device="cpu")
    d_deep = float(deep.sample(20)["depth"].double().mean())
    d_shallow = float(shallow.sample(20)["depth"].double().mean())
    assert d_deep > d_shallow + 1.0, (d_deep, d_shallow)


def test_leaves_counted_and_bounded():
    """Each iteration integrates 1..2^max_depth − 1 leaves per chain, at
    least the 2^depth − 1 of the rounds it completed, and the counter sums
    them."""
    dist = Gaussian(ndims=2)
    md, steps, n = 5, 10, 64
    gen = torch.Generator().manual_seed(3)
    state = make_nuts_state(dist, gen, n)
    total = torch.zeros(n, dtype=torch.int32)
    for _ in range(steps):
        state, o = nuts_step(dist, state, gen, 0.3, max_depth=md)
        assert o.n_leaves.dtype == o.depth.dtype == torch.int32
        assert bool((o.n_leaves >= 1).all()) and bool((o.n_leaves <= 2**md - 1).all())
        assert bool((o.depth <= md).all()) and bool((o.n_leaves >= 2**o.depth - 1).all())
        total += o.n_leaves
        assert torch.equal(state.x, o.x)
    assert torch.equal(state.grad_evals, total)
    s = NUTS(dist, epsilon=0.3, max_depth=md, nbatch=n, device="cpu")
    assert s.sample(steps)["x"].shape == (steps, 2, n)
    per_chain = s.state.grad_evals
    assert bool((per_chain <= steps * (2**md - 1)).all()) and bool((per_chain >= steps).all())
    s.burn_in(2)
    assert s.grad_evals == 0


def test_divergence_detection():
    """Huge ε on an ill-conditioned target must flag divergences."""
    s = NUTS(Gaussian(ndims=10, log_conditioning=3.0), epsilon=50.0, max_depth=4, nbatch=64,
             seed=2, device="cpu")
    assert bool(s.sample(10)["diverged"].any())


def test_no_divergence_small_eps():
    s = NUTS(Gaussian(ndims=2, log_conditioning=0.0), epsilon=0.05, max_depth=5, nbatch=64,
             seed=3, device="cpu")
    out = s.sample(10)
    assert not bool(out["diverged"].any())
    assert float(out["accept_stat"].mean()) > 0.95


def test_mass_diag_preconditions():
    """With M = 1/variance the 100:1 target is isotropic to the sampler:
    one ε explores both dims, and the variances hit analytic."""
    dist = Gaussian(ndims=2, log_conditioning=2.0)
    var = dist.analytic_var().numpy()
    s = NUTS(dist, epsilon=0.5, max_depth=6, nbatch=256, seed=4, device="cpu",
             mass_diag=tuple(1.0 / var))
    s.burn_in(50)
    xs = s.sample(300)["x"].double().numpy()
    np.testing.assert_allclose(xs.var(axis=(0, 2)), var, rtol=0.12)


def test_cli_torch_engine_nuts(capsys):
    cli(["sample", "--config", "gauss2d", "--engine", "torch", "--sampler", "nuts",
         "--device", "cpu", "--nbatch", "32", "--burn", "5", "--steps", "20"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"config", "sampler", "engine", "steps", "chains", "grad_evals", "mean",
                        "var", "ess", "ess_per_grad_eval"}
    assert rec["sampler"] == "nuts" and rec["engine"] == "torch" and rec["chains"] == 32
    assert 20 * 32 <= rec["grad_evals"] <= 20 * 32 * 255  # burn-in resets the counter
    assert len(rec["var"]) == 2 and all(np.isfinite(rec["var"])) and rec["ess"] > 0
