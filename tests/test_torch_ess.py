"""Slice B of the port against the JAX package on the CPU: the ESS/s harness
(``bench_ess``), the autocorrelation experiment and the burned-in inits.
The same inputs, made with NumPy from a seed, go through both."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_ess as jbe
from mjhmc_tpu import models as jmodels
from mjhmc_tpu.config import BENCHMARK_CONFIGS as JCONFIGS
from mjhmc_tpu.diagnostics import autocorr as jac
from mjhmc_tpu.experiments import autocorr_experiment as jae
from mjhmc_tpu_torch import bench_ess as tbe
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS
from mjhmc_tpu_torch.experiments import autocorr_experiment as tae
from mjhmc_tpu_torch.utils import init_cache

torch.set_num_threads(1)

ROWS = ("mjhmc", "control", "malt", "nuts-engine", "control-xla", "nuts")


# ---- the autocorrelation experiment's NumPy helpers -----------------------
def _counters(kind, t, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "steady":
        inc = np.full(t, 10.0)
    elif kind == "bursty":  # MJHMC at small beta: refresh bursts
        inc = 10.0 + 40.0 * (rng.uniform(size=t) < 0.1)
    else:  # "ramp": a rate that grows through the window
        inc = np.linspace(5.0, 20.0, t)
    return np.cumsum(inc) + rng.uniform(0, 3)


@pytest.mark.parametrize("kind,t,nlags", [
    ("steady", 50, 20), ("bursty", 200, 60), ("ramp", 80, 80), ("bursty", 10, 25),
    ("ramp", 1, 4), ("steady", 2, 7)])
def test_exact_evals_axis_equal(kind, t, nlags):
    e = _counters(kind, t, seed=t)
    np.testing.assert_array_equal(tae._exact_evals_axis(e, nlags), jae._exact_evals_axis(e, nlags))
    assert len(tae._exact_evals_axis(e, nlags)) == nlags


def _curve(kind, n=40):
    lags = np.arange(n)
    if kind == "falls":
        return np.exp(-lags / 7.3)
    if kind == "never":  # never below 1/e: censored at the window end
        return 0.5 + 0.5 * np.exp(-lags / 3.0)
    if kind == "first":  # below the level from lag 0
        return np.full(n, 0.2)
    if kind == "noisy":
        return np.exp(-lags / 4.0) + np.random.default_rng(3).normal(0, 0.05, n)
    return np.where(lags < 5, 1.0 - 0.1 * lags, np.e**-1)  # "touches": equals the level


@pytest.mark.parametrize("kind", ["falls", "never", "first", "noisy", "touches"])
@pytest.mark.parametrize("level", [np.e**-1, 0.5])
def test_decay_time_equal(kind, level):
    rho = _curve(kind)
    evals = jae._exact_evals_axis(_counters("bursty", 100), len(rho))
    assert tae._decay_time(evals, rho, level) == jae._decay_time(evals, rho, level)
    assert tae._decay_time(evals, rho) == jae._decay_time(evals, rho)


# ---- bench_ess ------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(BENCHMARK_CONFIGS))
def test_window_cap_equal(name):
    jcfg, tcfg = JCONFIGS[name], BENCHMARK_CONFIGS[name]
    assert tbe._window_cap(tcfg, tcfg.make_distribution()) == jbe._window_cap(
        jcfg, jcfg.make_distribution())


def _scripted(values, walls):
    """A stand-in for ``measure`` returning ``values`` in turn (and their
    wall seconds), recording each call's (steps, thin, seed)."""
    calls, it = [], iter(zip(values, walls))

    def measure(config, sampler, steps, burn, epsilon, beta, m, **kw):
        v, w = next(it)
        calls.append((steps, kw["thin"], kw["seed"]))
        return {"value": v, "detail": {"sampling_wall_s": w, "steps": steps}}

    return measure, calls


@pytest.mark.parametrize("config,sampler,values,walls,kw", [
    # settles after one lengthening of the window
    ("rough_well", "mjhmc", [1, 2, 3, 10, 10.5, 11], [1] * 6, {}),
    # never settles: stops after max_doublings
    ("rough_well", "control", [1, 3, 2, 5, 1, 9, 4, 1, 6], [1] * 9, dict(repeats=3)),
    # sparse coding's emit cap: thin doubles on an engine row ...
    ("sparse_coding", "malt", [1, 5, 2, 7, 1, 1.1, 1.05, 1.0, 1.02], [1] * 9,
     dict(repeats=3, steps=400)),
    # ... and a plain row at its cap reports the spread as it is
    ("sparse_coding", "nuts", [1, 5, 2], [1] * 3, dict(repeats=3, steps=400)),
    # a window over 20 s wall stops the lengthening
    ("rough_well", "nuts-engine", [1, 9, 4], [25, 30, 21], dict(repeats=3)),
    # a tight spread at once
    ("gauss2d", "control-xla", [5, 5.1, 4.95, 5.05, 5.0], [2] * 5, dict(spread_tol=0.05)),
])
def test_measure_repeats_lengthening(monkeypatch, config, sampler, values, walls, kw):
    kw = {"steps": 2000, "repeats": 2, **kw}
    results = []
    for mod in (jbe, tbe):
        stub, calls = _scripted(values, walls)
        monkeypatch.setattr(mod, "measure", stub)
        rec = mod.measure_repeats(config, sampler, **kw)
        results.append((rec["value"], rec["detail"]["repeats"], calls))
    (v_j, rep_j, calls_j), (v_t, rep_t, calls_t) = results
    assert calls_t == calls_j and calls_t
    assert v_t == v_j and rep_t == rep_j


class _FakeEngine:
    """Stand-in for a Pallas engine class (they run on a TPU only), so JAX's
    ``measure`` writes its engine-row record here."""

    def __init__(self, dist, epsilon, beta, num_leapfrog_steps, nbatch, seed, **kw):
        self.d, self.nbatch = dist.ndims, nbatch
        self.rng = np.random.default_rng(seed)

    def run(self, n):
        return None

    def sample(self, n, thin=1):
        xs = jnp.asarray(self.rng.standard_normal((n, self.d, self.nbatch)).astype(np.float32))
        return xs, jnp.ones((n, self.nbatch), jnp.float32)


def _jax_record(sampler, monkeypatch):
    if sampler in tbe.ENGINE_SAMPLERS:
        from mjhmc_tpu.ops import pallas_mjhmc

        for name in ("PallasMJHMC", "PallasControlHMC", "PallasMALT", "PallasNUTS"):
            monkeypatch.setattr(pallas_mjhmc, name, _FakeEngine)
    return jbe.measure("gauss2d", sampler, steps=100, burn=5, trials=1)


@pytest.mark.parametrize("sampler", ROWS)
def test_measure_record_on_cpu(sampler, monkeypatch):
    rec = tbe.measure("gauss2d", sampler, steps=100, burn=10, trials=1, device="cpu")
    jrec = _jax_record(sampler, monkeypatch)
    assert set(rec) == set(jrec) | {"device_name", "power_limit"}
    assert set(rec["detail"]) == set(jrec["detail"])
    det = rec["detail"]
    assert rec["metric"] == "effective_samples_per_sec_per_chip" and rec["unit"] == "ess/s"
    assert rec["device_name"] == "cpu" and rec["power_limit"] is None
    assert det["engine"] == ("cuda" if sampler in tbe.ENGINE_SAMPLERS else "torch")
    assert det["chains"] == 100 and det["steps"] == 100 and det["raw_samples"] == 10_000
    assert 0 < det["ess_total"] <= det["raw_samples"]
    assert rec["value"] == det["ess_total"] / det["sampling_wall_s"]
    for key in ("config", "sampler", "steps", "chains", "raw_samples", "epsilon",
                "num_leapfrog_steps"):
        assert det[key] == jrec["detail"][key], key
    if sampler == "nuts":
        assert sum(det["depth_hist"].values()) == 100 * 100


def test_main_table_on_the_cpu(tmp_path, capsys):
    """``--table`` on the plain versions: a row per sampler, printed and
    written, each the median of its repeats (the window kept: a spread
    tolerance no pair of repeats exceeds)."""
    out = tmp_path / "rows.json"
    assert tbe.main(["--table", "--configs", "gauss2d", "--samplers", "mjhmc,control",
                     "--repeats", "2", "--steps", "200", "--burn", "50", "--spread-tol", "1e9",
                     "--device", "cpu", "--json-out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = json.loads(out.read_text())
    assert [json.loads(ln) for ln in lines] == rows
    assert [(r["detail"]["config"], r["detail"]["sampler"]) for r in rows] == [
        ("gauss2d", "mjhmc"), ("gauss2d", "control")]
    for r in rows:
        det = r["detail"]
        assert det["tuned"] is False and "boundary" not in det and det["engine"] == "cuda"
        assert det["repeats"]["n"] == 2 and det["repeats"]["window_steps"] == 200
        assert abs(r["value"] / np.median(det["repeats"]["values"]) - 1) < 1e-5  # 6 digits


def test_main_needs_a_card_or_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbe.main(["--config", "gauss2d"]) != 0
    assert "needs a CUDA device" in capsys.readouterr().err
    assert tbe.main(["--config", "gauss2d", "--device", "cpu", "--steps", "100",
                     "--burn", "10"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["detail"]["engine"] == "cuda" and rec["detail"]["sampler"] == "mjhmc"


# ---- burned-in inits ------------------------------------------------------
def test_burned_in_init_cache_round_trip(tmp_path):
    dist = tmodels.Gaussian(ndims=2, log_conditioning=2.0)
    jdist = jmodels.Gaussian(ndims=2, log_conditioning=2.0)
    x = init_cache.burned_in_init(dist, 2048, cache_dir=str(tmp_path), burn_steps=200, seed=3,
                                  device="cpu")
    # the JAX package's cache key
    name = f"{jdist.stable_hash()}_n2048_b200_s3.npz"
    assert os.listdir(tmp_path) == [name]
    # a second call reads the file
    marked = x.numpy().copy()
    marked[0, 0] = 123.0
    np.savez(tmp_path / name, x=marked)
    again = init_cache.burned_in_init(dist, 2048, cache_dir=str(tmp_path), burn_steps=200,
                                      seed=3, device="cpu")
    np.testing.assert_array_equal(again.numpy(), marked)
    # refresh regenerates it, deterministically
    fresh = init_cache.burned_in_init(dist, 2048, cache_dir=str(tmp_path), burn_steps=200,
                                      seed=3, refresh=True, device="cpu")
    np.testing.assert_array_equal(fresh.numpy(), x.numpy())
    # burned in: gauss2d's variances (1, 100) within 12% (2,048 chains: the
    # sample variance's standard error is 3.1%)
    np.testing.assert_allclose(x.var(dim=1).numpy(), [1.0, 100.0], rtol=0.12)


def test_burned_in_init_default_dir_is_the_ports(monkeypatch, tmp_path):
    assert init_cache.DEFAULT_CACHE_DIR.endswith(os.path.join(".cache", "mjhmc_tpu_torch", "init"))
    monkeypatch.setattr(init_cache, "DEFAULT_CACHE_DIR", str(tmp_path / "c"))
    dist = tmodels.RoughWell()
    init_cache.burned_in_init(dist, 16, burn_steps=3, seed=0, device="cpu")
    assert os.listdir(tmp_path / "c") == [f"{dist.stable_hash()}_n16_b3_s0.npz"]


# ---- calculate_autocorrelation --------------------------------------------
def _recording(monkeypatch):
    """Record what the experiment hands to ``weighted_autocorrelation`` and
    ``_exact_evals_axis``."""
    seen = {}
    wac, axis = tae.weighted_autocorrelation, tae._exact_evals_axis

    def rec_wac(x, w=None, nlags=None):
        seen["x"], seen["w"], seen["nlags"] = x, w, nlags
        return wac(x, w, nlags=nlags)

    def rec_axis(evals_mean, nlags):
        seen["evals_mean"] = evals_mean
        return axis(evals_mean, nlags)

    monkeypatch.setattr(tae, "weighted_autocorrelation", rec_wac)
    monkeypatch.setattr(tae, "_exact_evals_axis", rec_axis)
    return seen


@pytest.mark.parametrize("engine,sampler,kw", [
    ("torch", "mjhmc", dict(epsilon=1.0, beta=0.1, num_leapfrog_steps=5)),
    ("torch", "control", dict(epsilon=1.0, beta=0.1, num_leapfrog_steps=5)),
    ("torch", "malt", dict(epsilon=0.8, gamma=0.5, num_leapfrog_steps=5)),
    ("torch", "nuts", dict(epsilon=0.8)),
    ("cuda", "mjhmc", dict(epsilon=1.0, beta=0.1, num_leapfrog_steps=5)),
])
def test_calculate_autocorrelation_against_jax(engine, sampler, kw, monkeypatch, tmp_path):
    monkeypatch.setattr(init_cache, "DEFAULT_CACHE_DIR", str(tmp_path))
    seen = _recording(monkeypatch)
    dist = tmodels.Gaussian(ndims=2, log_conditioning=2.0)
    res = tae.calculate_autocorrelation(dist, sampler, num_steps=200, nbatch=32, nlags=30,
                                        burn_steps=50, seed=1, engine=engine, device="cpu", **kw)
    assert res.name == ("mjhmc[cuda]" if engine == "cuda" else sampler)
    x = jnp.asarray(seen["x"].numpy())
    w = None if seen["w"] is None else jnp.asarray(seen["w"].numpy())
    assert (w is not None) == (sampler == "mjhmc")
    rho_j = np.asarray(jac.weighted_autocorrelation(x, w, nlags=30))
    # atol: float32's resolution at ρ(0) = 1, for the lags where ρ crosses 0
    np.testing.assert_allclose(res.rho, rho_j, rtol=1e-5, atol=1.2e-7)
    assert res.rho[0] == 1.0 and res.rho.shape == (30,)
    ev = np.asarray(seen["evals_mean"])
    assert ev.shape == (200,)
    np.testing.assert_allclose(res.grad_evals, jae._exact_evals_axis(ev, 30), rtol=1e-5)
    assert np.all(np.diff(res.grad_evals) >= 0)
    assert res.decay_evals == jae._decay_time(res.grad_evals, res.rho)
    assert res.censored == bool(res.decay_evals >= res.grad_evals[-1] * 0.999)
    assert res.total_grad_evals > 0
    frame = res.to_frame()
    assert list(frame.columns) == ["sampler", "lag", "grad_evals", "autocorrelation"]
    assert len(frame) == 30


@pytest.mark.parametrize("seed", range(10))
def test_decay_evals_against_jax(seed):
    """gauss2d MJHMC at its preset (ε 1, β 0.1, M 5), 256 chains, 1,000
    steps: JAX's decay is ~14.6 evals; the port's plain sampler and engine
    are held within 3% of it at each of ten seeds."""
    kw = dict(epsilon=1.0, beta=0.1, num_leapfrog_steps=5)
    jres = jae.calculate_autocorrelation(
        jmodels.Gaussian(ndims=2, log_conditioning=2.0), "mjhmc", 1000, 256, 100, 200, seed,
        use_cached_init=False, engine="xla", **kw)
    assert not jres.censored
    for engine in ("torch", "cuda"):
        tres = tae.calculate_autocorrelation(
            tmodels.Gaussian(ndims=2, log_conditioning=2.0), "mjhmc", 1000, 256, 100, 200, seed,
            use_cached_init=False, engine=engine, device="cpu", **kw)
        assert not tres.censored
        np.testing.assert_allclose(tres.decay_evals, jres.decay_evals, rtol=0.03, err_msg=engine)


@pytest.mark.parametrize("engine,sampler,match", [
    ("cuda", "reduced_flip", "MJHMC only"),
    ("cuda", "pt", "MJHMC only"),
    ("cuda", "control", "MJHMC only"),
    ("pallas", "mjhmc", "unknown engine"),
])
def test_calculate_autocorrelation_refusals(engine, sampler, match):
    with pytest.raises(ValueError, match=match):
        tae.calculate_autocorrelation(tmodels.RoughWell(), sampler, engine=engine, device="cpu")
