"""The port's figures and efficiency claim against
``mjhmc_tpu.experiments`` on the CPU, at the ``--quick`` sizes.

The spectral figure is deterministic given its ladder energies: with
JAX's draws injected (``figures.ladder_energies``) its ``.npz`` equals
JAX's within rtol 1e-6. The quick overlay's curves decay within a factor
2 of JAX's. The sampling figures are held by the rules of
``tests/test_figures_bundle.py`` (tempering's mode recovery from the
stuck start; the exact density). The efficiency claim's protocol (the
grid it sweeps, the regime-diverse confirmations, the choice among them,
the ratios) runs in both packages over the same stubbed searches and
autocorrelation runs and must make the same calls and the same rows; its
quick battery's record carries the keys of the JAX package's
``docs/figures/efficiency_claim.json``. Without matplotlib the ``.npz``
(and ``.json``) files are still written and the error names matplotlib.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import types
import zlib

import jax
import numpy as np
import pytest
import torch

from mjhmc_tpu.experiments import efficiency_claim as jclaim
from mjhmc_tpu.experiments import figures as jfigures
from mjhmc_tpu.experiments.autocorr_experiment import _decay_time
from mjhmc_tpu.samplers.algebraic import random_ladder_energies as jax_ladder_energies
from mjhmc_tpu_torch.experiments import efficiency_claim, figures
from mjhmc_tpu_torch.experiments.autocorr_experiment import ACResult
from mjhmc_tpu_torch.utils import init_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _jax_energies(seed, k):
    return jax_ladder_energies(jax.random.key(seed), k)


def test_spectral_gap_npz_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(figures, "ladder_energies", _jax_energies)
    figures.main(["--quick", "--only", "spectral", "--out", str(tmp_path / "t"),
                  "--device", "cpu"])
    jfigures.fig_spectral_gap(str(tmp_path), quick=True)
    got = np.load(tmp_path / "t" / "spectral_gap.npz")
    want = np.load(tmp_path / "spectral_gap.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)
    assert (tmp_path / "t" / "spectral_gap.png").exists()


def test_ladder_energies_are_seeded_draws():
    a, b = figures.ladder_energies(3, 16), figures.ladder_energies(3, 16)
    assert a.shape == (16,) and a.dtype == np.float64 and np.array_equal(a, b)
    assert not np.array_equal(a, figures.ladder_energies(103, 16))


def test_tempering_recovers_both_modes():
    """The bundle test's rule (``tests/test_figures_bundle.py:98``): PT
    from x = −4 splits its mass over both modes, HMC stays in its basin,
    every adjacent pair exchanges, and the exact density integrates to 1."""
    from mjhmc_tpu_torch.models import GaussianMixture

    z = figures.fig_tempering(quick=True, device="cpu")
    right_pt, right_hmc = float(np.mean(z["pt"] > 0.0)), float(np.mean(z["hmc"] > 0.0))
    assert 0.3 < right_pt < 0.7, right_pt
    assert right_hmc < 0.05, right_hmc
    assert (z["swap_rates"] > 0.05).all()
    assert len(z["hmc"]) == len(z["pt"]) == 400 * 64
    grid, exact = z["grid"], z["exact"]
    assert abs(np.trapezoid(exact, grid) - 1.0) < 1e-6
    dist = GaussianMixture()
    recomputed = np.exp(-np.asarray(dist.potential(torch.as_tensor(grid)[None, :]), np.float64))
    np.testing.assert_allclose(exact, recomputed / np.trapezoid(recomputed, grid), atol=1e-4)


def test_trajectory_fan_explores():
    z = figures.fig_trajectory_fan(quick=True, device="cpu")
    for name in ("mjhmc", "control_hmc"):
        assert z[name].shape == (100, 2, 16) and np.isfinite(z[name]).all()
        assert z[name].std() > 10.0


def test_quick_efficiency_battery(tmp_path, monkeypatch):
    """``--quick``: two rows with the JAX receipt's keys, a finite positive
    ratio, and the ``.npz``, ``.json`` and ``.png`` written."""
    monkeypatch.setattr(init_cache, "DEFAULT_CACHE_DIR", str(tmp_path / "init"))
    out = str(tmp_path / "claim" / "efficiency_claim")
    assert efficiency_claim.main(["--quick", "--out", out, "--device", "cpu"]) == 0
    with open(out + ".json") as f:
        rec = json.load(f)
    with open(os.path.join(REPO, "docs", "figures", "efficiency_claim.json")) as f:
        jax_rec = json.load(f)
    assert set(rec) == {"rows", "ratios"}
    assert len(rec["rows"]) == 2 and all(set(r) == set(jax_rec["rows"][0]) for r in rec["rows"])
    assert [r["sampler"] for r in rec["rows"]] == ["mjhmc", "control"]
    ratio = rec["ratios"]["rough_well[a=2]"]
    assert set(ratio) == set(next(iter(jax_rec["ratios"].values())))
    assert np.isfinite(ratio["ratio_control_over_mjhmc"]) and ratio["ratio_control_over_mjhmc"] > 0
    z = np.load(out + ".npz")
    assert sorted(z.files) == sorted(f"rough_well[a=2]/{s}/{k}" for s in ("mjhmc", "control")
                                     for k in ("evals", "rho"))
    assert os.path.exists(out + ".png")


def _u(*parts) -> float:
    """A value in [0, 1) fixed by ``parts``, the same in both packages."""
    parts = tuple(int(p) if isinstance(p, (int, np.integer)) else float(p)
                  if isinstance(p, (float, np.floating)) else p for p in parts)
    return zlib.crc32(repr(parts).encode()) / 2**32


def _plain(v):
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return int(v)
    return float(v) if isinstance(v, (float, np.floating)) else v


def _describe(dist):
    return type(dist).__name__, {f.name: _plain(getattr(dist, f.name))
                                 for f in dataclasses.fields(dist)
                                 if isinstance(getattr(dist, f.name), (int, float, str))}


def _stub_claim(monkeypatch, module, calls, mode):
    """Replace ``module``'s search and autocorrelation run by stand-ins
    whose decays and censoring are fixed by their arguments, and record
    every call. ``mode`` censors every grid point, or every confirmation,
    or (``mixed``) a share of each, with a few non-finite grid decays."""

    def grid_search(dist, **kw):
        calls.append(("grid", _describe(dist), kw))
        table = []
        for m in kw["m_grid"]:
            for eps in kw["eps_grid"]:
                for beta in kw["beta_grid"]:
                    u = _u(kw["sampler"], eps, beta, m)
                    table.append(dict(epsilon=float(eps), beta=float(beta),
                                      num_leapfrog_steps=int(m),
                                      decay_evals=float("inf") if u < 0.08 else 40.0 + 4e3 * u,
                                      censored=mode == "grid censored" or u > 0.85))
        return types.SimpleNamespace(table=table, best=table[0])

    def calculate_autocorrelation(dist, **kw):
        calls.append(("confirm", _describe(dist), kw))
        u = _u(kw["sampler"], kw["epsilon"], kw["beta"], kw["num_leapfrog_steps"],
               kw["num_steps"], kw["nlags"], kw["seed"])
        return types.SimpleNamespace(grad_evals=np.arange(1.0, 6.0), rho=np.linspace(1, 0, 5),
                                     decay_evals=30.0 + 3e3 * u, total_grad_evals=5,
                                     censored=mode == "confirm censored" or u > 0.6)

    monkeypatch.setattr(module, "grid_search", grid_search)
    monkeypatch.setattr(module, "calculate_autocorrelation", calculate_autocorrelation)


def _same_calls(got, want):
    for _, _, kw in got:
        assert str(kw.pop("device")) == "cpu"
    assert [(k, d, _plain(sorted(kw.items()))) for k, d, kw in got] == \
        [(k, d, _plain(sorted(kw.items()))) for k, d, kw in want]


@pytest.mark.parametrize("mode", ["mixed", "grid censored", "confirm censored"])
def test_claim_protocol_matches_jax(mode, monkeypatch):
    """``run_claim`` over ``DEFAULT_TARGETS`` with both packages' searches
    and runs stubbed alike: the same grids (ε, β, M, steps, chains, lags,
    seed), the same confirmations (the best point of each β decade, up to
    4, at ``seed + 7`` with JAX's ``nlags_c`` and ``steps_c``), the same
    choice among them by (not censored, -decay), the same rows and
    ratios."""
    got, want = [], []
    _stub_claim(monkeypatch, efficiency_claim, got, mode)
    _stub_claim(monkeypatch, jclaim, want, mode)
    res = efficiency_claim.run_claim(seed=3, verbose=False, device="cpu")
    jres = jclaim.run_claim(seed=3, verbose=False)
    confirms = [kw for k, _, kw in want if k == "confirm"]
    assert len(confirms) > 2 * len(jclaim.DEFAULT_TARGETS) * 2  # several a row
    assert {kw["seed"] for kw in confirms} == {10}
    assert {kw["num_leapfrog_steps"] for kw in confirms} & {1, 2, 5}  # nlags_c widened
    _same_calls(got, want)
    assert res["rows"] == jres["rows"] and len(res["rows"]) == 14
    assert res["ratios"] == jres["ratios"]
    if mode == "confirm censored":
        assert all(r["censored"] for r in res["rows"])


def test_quick_claim_main_matches_jax(tmp_path, monkeypatch):
    """``main --quick`` over the stand-ins: the port's quick battery makes
    JAX's calls and writes JAX's ``.json`` record and ``.npz`` curves."""
    got, want = [], []
    _stub_claim(monkeypatch, efficiency_claim, got, "mixed")
    _stub_claim(monkeypatch, jclaim, want, "mixed")
    out, jout = str(tmp_path / "t" / "claim"), str(tmp_path / "j" / "claim")
    assert efficiency_claim.main(["--quick", "--seed", "2", "--out", out, "--device", "cpu"]) == 0
    assert jclaim.main(["--quick", "--seed", "2", "--out", jout]) == 0
    assert len(want) > 2
    _same_calls(got, want)
    with open(out + ".json") as f, open(jout + ".json") as g:
        assert json.load(f) == json.load(g)
    z, jz = np.load(out + ".npz"), np.load(jout + ".npz")
    assert sorted(z.files) == sorted(jz.files)
    for k in jz.files:
        np.testing.assert_array_equal(z[k], jz[k])


def test_quick_overlay_decays_match_jax(tmp_path):
    """The quick overlay's twelve curves against JAX's (same sizes and
    hand-set points, different streams): the parameters equal, ρ(0) = 1,
    the same censoring, and each decay within a factor 2 of JAX's. The
    product of t's two uncensored curves are held to being uncensored
    only: at 64 chains and 400 steps its heavy tails scatter the decay
    more than 2x from seed to seed (JAX's own over seeds 0-3: 22.7-54.3
    evals for MJHMC, 28.3-158.5 for control)."""
    got = figures.fig_autocorr_overlay(quick=True, device="cpu")
    jfigures.fig_autocorr_overlay(str(tmp_path), quick=True)
    want = np.load(tmp_path / "autocorr_overlay.npz")
    assert sorted(got) == sorted(want.files) and len(want.files) == 36
    for k in want.files:
        assert got[k].shape == want[k].shape, k
        if k.endswith("_params"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in (k for k in want.files if k.endswith("_rho")):
        ev = k[: -len("rho")] + "evals"
        d, jd = _decay_time(got[ev], got[k]), _decay_time(want[ev], want[k])
        censored = d >= got[ev][-1] * 0.999
        assert censored == (jd >= want[ev][-1] * 0.999), (k, d, jd)
        assert abs(got[k][0] - 1.0) <= 0.02 and np.isfinite(got[k]).all(), k
        if k.startswith("product_of_t") and not k.endswith("malt_rho"):
            assert not censored, (k, d)
        else:
            assert 0.5 <= d / jd <= 2.0, (k, d, jd)


def test_without_matplotlib_the_arrays_are_written(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        figures.main(["--quick", "--only", "spectral", "--out", str(tmp_path), "--device", "cpu"])
    assert (tmp_path / "spectral_gap.npz").exists()
    assert not (tmp_path / "spectral_gap.png").exists()
    ac = ACResult(name="mjhmc", grad_evals=np.arange(5.0), rho=np.linspace(1, 0, 5),
                  decay_evals=2.5, total_grad_evals=10)
    result = {"curves": {"t": {"mjhmc": ac}}, "ratios": {}}
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        efficiency_claim.save_figure(result, str(tmp_path / "e.png"), str(tmp_path / "e.npz"))
    assert sorted(np.load(tmp_path / "e.npz").files) == ["t/mjhmc/evals", "t/mjhmc/rho"]
    assert not (tmp_path / "e.png").exists()


def test_overlay_full_path_tunes_each_sampler_as_jax(monkeypatch):
    """Without ``quick`` each (distribution, sampler) is tuned by
    ``bayes_search`` with JAX's arguments (``figures.py:88-96``) and its
    best point (γ for MALT) drives a long run from the cached inits."""
    from mjhmc_tpu_torch.search import SearchResult, bayes

    searches, runs = [], []

    def fake_search(dist, **kw):
        searches.append((type(dist).__name__, kw))
        return SearchResult(best=dict(epsilon=0.5, beta=0.25, num_leapfrog_steps=10,
                                      decay_evals=1.0, censored=False), table=[])

    def fake_run(dist, sampler, **kw):
        runs.append((type(dist).__name__, sampler, kw))
        n = kw["nlags"]
        return ACResult(name=sampler, grad_evals=np.arange(1.0, n + 1), rho=np.ones(n),
                        decay_evals=float(n), total_grad_evals=n, censored=True)

    monkeypatch.setattr(bayes, "bayes_search", fake_search)
    monkeypatch.setattr(figures, "calculate_autocorrelation", fake_run)
    a = figures.fig_autocorr_overlay(quick=False, device="cpu")
    assert len(searches) == len(runs) == 12 and len(a) == 36
    eps = {"Gaussian": (0.05, 10.0), "RoughWell": (0.1, 20.0), "ProductOfT": (0.01, 3.0),
           "SparseCoding": (0.002, 0.3)}
    for (name, kw), (rname, sampler, rkw) in zip(searches, runs):
        assert kw == dict(sampler=sampler, num_init=8, num_iters=12, num_steps=600, nbatch=128,
                          nlags=150, m_grid=(2, 5, 10, 20), device="cpu", eps_range=eps[name])
        second = "gamma" if sampler == "malt" else "beta"
        assert rname == name and rkw[second] == 0.25 and rkw["epsilon"] == 0.5
        assert rkw["num_leapfrog_steps"] == 10 and rkw["use_cached_init"] is True
        steps = 1200 if name == "SparseCoding" else 3000
        nb = 256 if name in ("ProductOfT", "SparseCoding") else 512
        assert (rkw["num_steps"], rkw["nbatch"], rkw["nlags"]) == (steps, nb, 200)
    np.testing.assert_array_equal(a["product_of_t_malt_params"], [0.5, 0.25, 10])
