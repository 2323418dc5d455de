"""The port's main path as a whole, on the CPU: the engine class from a
JAX state, the CLI, the ESS diagnostic, and the JAX-free import."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.diagnostics import autocorr as jac
from mjhmc_tpu.ops.pallas_mjhmc import (
    energy_spec_for,
    pallas_mjhmc_run,
    pallas_mjhmc_stream_run,
)
from mjhmc_tpu_torch import diagnostics as tdiag
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.__main__ import main as cli
from mjhmc_tpu_torch.convert import state_from_jax
from mjhmc_tpu_torch.ops.cuda_mjhmc import CudaMJHMC

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, S = 1024, 8


@pytest.mark.parametrize(
    "name,kw,eps,beta,m,burn,emits,thin",
    [
        ("RoughWell", dict(ndims=2), 1.0, 0.1, 10, 3, 2, 1),
        ("Gaussian", dict(ndims=2, log_conditioning=2.0), 1.0, 0.1, 5, 30, 10, 2),
    ],
)
def test_engine_run_and_sample_match_interpret_kernels(name, kw, eps, beta, m, burn,
                                                       emits, thin):
    """CudaMJHMC(device='cpu') run + sample from a converted JAX state, in
    fixed-uniform mode, equals the two interpret-mode JAX kernels."""
    jd, td = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    d, l = jd.ndims, N // S
    x = jd.init_x(jax.random.key(5), N)
    v = jax.random.normal(jax.random.key(6), x.shape, jnp.float32)
    u, g = jd.potential_and_grad(x)
    z = jnp.zeros((S, l), jnp.float32)
    js = (x.reshape(d, S, l), v.reshape(d, S, l), g.reshape(d, S, l), u.reshape(S, l), z, z)
    ip = pltpu.InterpretParams()
    scal = (jnp.int32(1), jnp.float32(eps), jnp.float32(beta))
    out_j = pallas_mjhmc_run(energy_spec_for(jd), *js, *scal, burn, m, interpret=ip)
    xs_j, ws_j, es_j, sout_j = pallas_mjhmc_stream_run(
        energy_spec_for(jd), *out_j[:6], *scal, emits, thin, m, interpret=ip)

    eng = CudaMJHMC(td, epsilon=eps, beta=beta, num_leapfrog_steps=m, nbatch=N,
                    device="cpu", fixed_uniform=True)
    eng.load_state(state_from_jax(*(np.array(a) for a in js)))
    out_t = eng.run(burn)
    xs_t, ws_t, es_t = eng.sample(emits, thin=thin, return_evals=True)

    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).reshape(N))
    np.testing.assert_array_equal(es_t.numpy(), np.asarray(es_j).reshape(emits, N))
    assert eng.grad_evals == int(np.asarray(out_j.evals).sum() + np.asarray(es_j[-1]).sum())
    assert eng.steps_total == burn + emits * thin
    xs_j = np.asarray(xs_j).reshape(emits, d, N)
    atol = 1e-4 * np.abs(xs_j).max()
    np.testing.assert_allclose(xs_t.numpy(), xs_j, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(ws_t.numpy(), np.asarray(ws_j).reshape(emits, N), rtol=1e-4)
    np.testing.assert_allclose(eng.x.numpy(), np.asarray(sout_j.x).reshape(d, N),
                               rtol=1e-4, atol=atol)
    mean, var = CudaMJHMC.moments(eng.last_out)
    assert mean.shape == var.shape == (d,)


def test_cli_sample_gauss2d_subprocess(tmp_path):
    """`python -m mjhmc_tpu_torch sample` on the CPU: the variance is within
    20% of [1, 100] and grad_evals is the sum of the per-chain counters."""
    save = tmp_path / "s.npz"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "mjhmc_tpu_torch", "sample", "--config", "gauss2d",
         "--engine", "cuda", "--device", "cpu", "--steps", "300", "--burn", "100",
         "--nbatch", "256", "--save", str(save)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["engine"] == "cuda" and rec["chains"] == 256 and rec["steps"] == 300
    np.testing.assert_allclose(rec["var"], [1.0, 100.0], rtol=0.2)
    data = np.load(save)
    evals = data["evals"]
    assert rec["grad_evals"] == int(evals.sum())
    extra = evals - 5 * 400
    assert (extra >= 5).all() and (extra % 5 == 0).all()
    assert data["x"].shape == (300, 2, 256) and data["dwell"].shape == (300, 256)
    assert rec["ess"] > 0 and rec["ess_per_grad_eval"] == rec["ess"] / rec["grad_evals"]


def test_cli_plain_engine_and_rejections(capsys, monkeypatch):
    cli(["sample", "--config", "gauss2d", "--engine", "torch", "--device", "cpu",
         "--steps", "60", "--burn", "20", "--nbatch", "64"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["engine"] == "torch" and rec["chains"] == 64 and rec["grad_evals"] >= 60 * 64 * 5
    for argv in (["figures"], ["sample", "--sampler", "nuts"], ["sample", "--engine", "xla"]):
        with pytest.raises(SystemExit):
            cli(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        cli(["sample", "--config", "gauss2d", "--steps", "2", "--burn", "1"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        CudaMJHMC(tmodels.RoughWell(), device="cuda")


@pytest.mark.parametrize("weighted", [True, False])
def test_ess_and_autocorrelation_match_jax(weighted):
    rng = np.random.default_rng(1)
    t, d, n = 400, 2, 32
    x = np.cumsum(rng.standard_normal((t, d, n)), axis=0).astype(np.float32) * 0.1
    x += rng.standard_normal((t, d, n)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (t, n)).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.as_tensor(w)
    ess_j = float(jac.effective_sample_size(jnp.asarray(x), jw))
    ess_t = float(tdiag.effective_sample_size(torch.as_tensor(x), tw))
    np.testing.assert_allclose(ess_t, ess_j, rtol=1e-4)
    rho_j = np.asarray(jac.weighted_autocorrelation(jnp.asarray(x), jw, nlags=50))
    rho_t = tdiag.weighted_autocorrelation(torch.as_tensor(x), tw, nlags=50).numpy()
    np.testing.assert_allclose(rho_t, rho_j, rtol=1e-4, atol=1e-5)
    ev_j, r_j = jac.autocorrelation_vs_grad_evals(jnp.asarray(x), 7.5, jw, nlags=20)
    ev_t, r_t = tdiag.autocorrelation_vs_grad_evals(torch.as_tensor(x), 7.5, tw, nlags=20)
    np.testing.assert_allclose(ev_t.numpy(), np.asarray(ev_j))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-4, atol=1e-5)
    if not weighted:
        np.testing.assert_allclose(tdiag.autocorrelation(torch.as_tensor(x), 30).numpy(),
                                   np.asarray(jac.autocorrelation(jnp.asarray(x), 30)),
                                   rtol=1e-4, atol=1e-5)
    # chain chunking (small FFT budget) is exact
    small = tdiag.weighted_autocorrelation(torch.as_tensor(x), tw, nlags=50,
                                           max_fft_bytes=1 << 14)
    np.testing.assert_allclose(small.numpy(), rho_t, rtol=1e-5, atol=1e-6)


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import mjhmc_tpu_torch, mjhmc_tpu_torch.__main__, mjhmc_tpu_torch.bench\n"
        "import mjhmc_tpu_torch.convert, mjhmc_tpu_torch.ops.cuda_mjhmc\n"
        "import mjhmc_tpu_torch.ops._build, mjhmc_tpu_torch.ops.leapfrog\n"
        "import mjhmc_tpu_torch.samplers.mjhmc, mjhmc_tpu_torch.diagnostics.autocorr\n"
        "import mjhmc_tpu_torch.models.product_of_t, mjhmc_tpu_torch.models.sparse_coding\n"
        "import mjhmc_tpu_torch.bench_ess, mjhmc_tpu_torch.experiments.autocorr_experiment\n"
        "import mjhmc_tpu_torch.diagnostics.rhat, mjhmc_tpu_torch.diagnostics.spectral\n"
        "import mjhmc_tpu_torch.samplers.algebraic, mjhmc_tpu_torch.utils.init_cache\n"
        "mjhmc_tpu_torch.models.SparseCoding()._phi\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mjhmc_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
