"""``bench_ess --table``/``--tune``, ``bench_two_stage`` and the sharded SMC
receipt of the port against the JAX package on the CPU.

JAX's harness drives the Pallas engines, which need a TPU, so in both
packages ``grid_search``, ``measure``, ``measure_repeats`` and
``nuts_full_warmup`` are replaced alike by stand-ins whose outputs are fixed
by their arguments; the tests assert the same calls (the port's adds
``device``; JAX's its lane block, ``None`` on the plain NUTS path and never
asked for) and the same results. ``_tune_nuts`` also runs for real on
gauss2d in both (other draws: ε within a factor 1.25 of JAX's, the mass
within 15%), and the sharded receipt on two gloo ranks.
"""

import argparse
import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import bench_ess as jbe
from mjhmc_tpu.config import BENCHMARK_CONFIGS as JCONFIGS
from mjhmc_tpu_torch import bench_ess as tbe
from mjhmc_tpu_torch import bench_heads, bench_two_stage
from mjhmc_tpu_torch.config import BENCHMARK_CONFIGS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(v):
    """JSON-comparable: tuples to lists, NumPy scalars to floats."""
    return json.loads(json.dumps(v, default=float))


def _text(v) -> str:
    """Comparable where NaN is (the preset candidate's decay)."""
    return json.dumps(v, sort_keys=True, default=float)


def _landscape(opt):
    """A grid decay with its minimum at ``opt`` = (ε, β, M) in log space."""
    e0, b0, m0 = opt

    def decay(eps, beta, m):
        return 100.0 + 40.0 * np.log(eps / e0) ** 2 + 9.0 * np.log(beta / b0) ** 2 \
            + 25.0 * np.log(m / m0) ** 2
    return decay


def _grid_stub(calls, opt, censor_above=1e9):
    decay = _landscape(opt)

    def grid_search(dist, **kw):
        calls.append(("grid", type(dist).__name__, _plain({k: v for k, v in kw.items()
                                                            if k != "device"})))
        table = [dict(epsilon=float(e), beta=float(b), num_leapfrog_steps=int(m),
                      decay_evals=decay(e, b, m), censored=decay(e, b, m) > censor_above)
                 for m in kw["m_grid"] for e in kw["eps_grid"] for b in kw["beta_grid"]]
        good = [r for r in table if not r["censored"]] or table
        return types.SimpleNamespace(best=min(good, key=lambda r: r["decay_evals"]), table=table)
    return grid_search


def _measure_stub(calls, opt=(1.0, 0.1, 5), depth_rates=None):
    """ESS/s fixed by the operating point: a peak at ``opt``, two-stage ×1.1;
    NUTS rows by max_depth from ``depth_rates``."""
    decay = _landscape(opt)

    def measure(config, sampler, steps=2000, burn=500, epsilon=None, beta=None, m=None, **kw):
        kw.pop("device", None)
        if kw.get("lane_block", 1) is None:
            kw.pop("lane_block")
        calls.append(("measure", config, sampler, steps, burn,
                      _plain(epsilon), _plain(beta), m, _plain(sorted(kw.items()))))
        if sampler in ("nuts", "nuts-engine"):
            value = depth_rates[m]
        else:
            value = 1e7 / decay(epsilon, max(beta, 1e-6), m)
            value *= 1.1 if kw.get("integrator") == "two_stage" else 1.0
        return {"value": value, "detail": {"config": config, "sampler": sampler}}
    return measure


def _repeats_stub(calls):
    def measure_repeats(config, sampler, steps=2000, burn=500, epsilon=None, beta=None, m=None,
                        **kw):
        kw.pop("device", None)
        if kw.get("lane_block", 1) is None:
            kw.pop("lane_block")
        calls.append(("repeats", config, sampler, steps, burn, _plain(epsilon), _plain(beta), m,
                      _plain(sorted(kw.items()))))
        thin = kw.get("thin", 1)
        window = steps * (3 if sampler == "malt" and thin == 1 else 1)
        value = 1e5 + 10.0 * len(sampler.replace("-engine", "")) + steps + (0 if epsilon is None else 7e3 * epsilon)
        return {"metric": "effective_samples_per_sec_per_chip", "value": value,
                "device_name": "stub card", "power_limit": "700.00 W",
                "detail": {"config": config, "sampler": sampler, "epsilon": epsilon or 1.0,
                           "beta": 0.1 if beta is None else beta,
                           "num_leapfrog_steps": m or 5,
                           "integrator": kw.get("integrator", "leapfrog"),
                           "repeats": {"n": kw.get("repeats", 1), "values": [value],
                                       "rel_spread": 0.01, "window_steps": window,
                                       "thin": thin, "lengthened": 0}}}
    return measure_repeats


def _warmup_stub(calls):
    def nuts_full_warmup(dist, key, nbatch, eps0=0.5, **kw):
        kw.pop("device", None)
        calls.append(("warmup", type(dist).__name__, nbatch, eps0, sorted(kw)))
        d = dist.ndims
        return None, 0.3 + 0.01 * d, np.linspace(0.5, 2.0, d)[:, None]
    return nuts_full_warmup


def _stub_both(monkeypatch, opt=(1.0, 0.1, 5), depth_rates=None, censor_above=1e9):
    """Both packages' stand-ins; returns (port calls, JAX calls)."""
    import mjhmc_tpu.samplers.adaptation as jadapt
    import mjhmc_tpu.search.grid as jgrid
    import mjhmc_tpu_torch.samplers.adaptation as tadapt
    import mjhmc_tpu_torch.search.grid as tgrid

    got, want = [], []
    for calls, grid, adapt, be in ((got, tgrid, tadapt, tbe), (want, jgrid, jadapt, jbe)):
        monkeypatch.setattr(grid, "grid_search", _grid_stub(calls, opt, censor_above))
        monkeypatch.setattr(adapt, "nuts_full_warmup", _warmup_stub(calls))
        monkeypatch.setattr(be, "measure", _measure_stub(calls, opt, depth_rates))
        monkeypatch.setattr(be, "measure_repeats", _repeats_stub(calls))
    return got, want


# ---- _tune: the boundary audit ---------------------------------------------
# (config, sampler, integrator, optimum as multiples of the preset ε, β, M, kw, verdict)
TUNE_CASES = [
    ("interior", "gauss2d", "mjhmc", "leapfrog", (1.0, 0.1, 10), {}, "interior"),
    ("eps_hi then interior", "gauss2d", "control", "leapfrog", (20.0, 0.1, 10), {}, "interior"),
    ("beta_lo to the floor", "gauss2d", "mjhmc", "leapfrog", (1.0, 1e-5, 5), {}, "physical"),
    ("the M ladder", "product_of_t", "mjhmc", "leapfrog", (1.0, 0.3, 100), {}, "interior"),
    ("gamma_hi", "gauss2d", "malt", "leapfrog", (1.0, 10.0, 10), {}, "interior"),
    ("pinned", "gauss2d", "mjhmc", "leapfrog", (1e4, 0.1, 10), {"max_rounds": 2},
     "pinned:eps_hi"),
    ("two-stage eps0", "rough_well", "mjhmc", "two_stage", (2.0, 0.05, 5), {}, "interior"),
]


@pytest.mark.parametrize("case,config,sampler,integrator,opt,kw,verdict", TUNE_CASES,
                         ids=[c[0] for c in TUNE_CASES])
def test_tune_audit_matches_jax(case, config, sampler, integrator, opt, kw, verdict, monkeypatch):
    """The same grids, round by round (ε widened at the edge it is pinned
    to, β down to the floor, M along the ladder, MALT's γ upward, two-stage
    centred at 2ε₀), the same best point, verdict and table."""
    cfg, jcfg = BENCHMARK_CONFIGS[config], JCONFIGS[config]
    got, want = _stub_both(monkeypatch, (cfg.epsilon * opt[0], opt[1], opt[2]))
    res = tbe._tune(cfg.make_distribution(), sampler, cfg, integrator=integrator, device="cpu",
                    **kw)
    jres = jbe._tune(jcfg.make_distribution(), sampler, jcfg, integrator=integrator, **kw)
    assert got == want and len(got) >= (1 if case in ("interior", "two-stage eps0") else 2)
    assert _plain(res) == _plain(jres)
    assert res[1] == verdict
    if integrator == "two_stage":
        assert np.isclose(np.sqrt(got[0][2]["eps_grid"][0] * got[0][2]["eps_grid"][-1]),
                          2 * cfg.epsilon)


# ---- _candidates -------------------------------------------------------------
def _table(seed, all_censored=False):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(60):
        decay = float(rng.uniform(10, 500)) if rng.uniform() > 0.1 else float("inf")
        rows.append(dict(epsilon=float(rng.choice([0.1, 0.3, 1.0, 3.0])),
                         beta=float(rng.choice([2e-4, 5e-3, 0.02, 0.1, 0.5, 1.0])),
                         num_leapfrog_steps=int(rng.choice([2, 5, 10, 20])),
                         decay_evals=decay, censored=all_censored or bool(rng.uniform() < 0.2)))
    return rows


@pytest.mark.parametrize("seed,all_censored,k", [(0, False, 7), (1, False, 5), (2, False, 3),
                                                 (3, True, 7)])
def test_candidates_match_jax(seed, all_censored, k):
    table = _table(seed, all_censored)
    best = min(table, key=lambda r: r["decay_evals"])
    for config in ("gauss2d", "rough_well_a3"):
        got = tbe._candidates(best, table, BENCHMARK_CONFIGS[config], k=k)
        assert _text(got) == _text(jbe._candidates(best, table, JCONFIGS[config], k=k))
        assert got[0] is best and len(got) <= k
    assert _text(tbe._candidates(best, table)) == _text(jbe._candidates(best, table))


# ---- the arbitrations --------------------------------------------------------
def _args(**kw):
    return argparse.Namespace(**{"steps": 2000, "burn": 500, "device": "cpu", **kw})


@pytest.mark.parametrize("config", ["rough_well", "gauss2d"])
@pytest.mark.parametrize("sampler", ["mjhmc", "control", "malt"])
def test_arbitrate_sampler_matches_jax(config, sampler, monkeypatch):
    """A barrier config tunes two-stage jointly (k = 5 of its grid), the
    other tries matched-budget transforms of its top two; the same
    candidates measured in the same order on the same short windows, the
    same winner and relabelled boundary."""
    cfg = BENCHMARK_CONFIGS[config]
    got, want = _stub_both(monkeypatch, (cfg.epsilon * 0.7, 0.03, 10))
    res = tbe._arbitrate_sampler(config, sampler, cfg, _args())
    jres = jbe._arbitrate_sampler(config, sampler, JCONFIGS[config], _args())
    assert got == want and _plain(res) == _plain(jres)
    measured = [c for c in got if c[0] == "measure"]
    assert {c[3:5] for c in measured} == {(600, 250)} and len(measured) == res[5]
    two_stage = [c for c in measured if ["integrator", "two_stage"] in c[-1]]
    assert bool(two_stage) == (sampler != "malt")


@pytest.mark.parametrize("rates,depth,boundary", [
    ({4: 1.0, 6: 2.0, 8: 3.0, 10: 4.0, 12: 5.0}, 12, "warmup-adapted+arbitrated:depth_hi"),
    ({4: 1.0, 6: 2.0, 8: 3.0, 10: 4.0, 12: 3.5}, 10, "warmup-adapted+arbitrated"),
    ({4: 1.0, 6: 5.0, 8: 3.0, 10: 4.0, 12: 9.0}, 6, "warmup-adapted+arbitrated"),
], ids=["10 wins, 12 wins", "10 wins, 12 loses", "6 wins"])
@pytest.mark.parametrize("sampler", ["nuts-engine", "nuts"])
def test_arbitrate_nuts_matches_jax_without_lanes(rates, depth, boundary, sampler, monkeypatch):
    """Depths {4, 6, 8, 10}, 12 measured only when 10 wins: the port's calls
    (either row) are JAX's plain-NUTS calls, which have no lane axis."""
    got, want = _stub_both(monkeypatch, depth_rates=rates)
    cfg = BENCHMARK_CONFIGS["product_of_t"]
    mass = (1.0,) * 36
    res = tbe._arbitrate_nuts("product_of_t", sampler, cfg, _args(), 0.15, mass)
    jres = jbe._arbitrate_nuts("product_of_t", "nuts", JCONFIGS["product_of_t"], _args(), 0.15,
                               mass)
    assert [c[:2] + c[3:] for c in got] == [c[:2] + c[3:] for c in want]
    assert res == (jres[0], jres[2], jres[3]) and jres[1] is None
    assert res[:2] == (depth, boundary)
    assert [c[7] for c in got] == ([4, 6, 8, 10, 12] if rates[10] == 4.0 and depth != 6
                                   else [4, 6, 8, 10])
    assert set(res[2]) == {f"d{d}" for d in (c[7] for c in got)}


def test_equalize_config_windows_matches_jax(monkeypatch):
    """Rows below the config's longest window (steps × thin) are measured
    again at it (emits capped, thin making up the rest, none on the plain
    rows), keeping their tune fields."""
    got, want = _stub_both(monkeypatch)

    def rows_of(window):
        out = []
        for s, (steps, thin) in zip(("mjhmc", "malt", "nuts", "control"), window):
            out.append({"value": 1.0 + len(s), "detail": {
                "config": "rough_well", "sampler": s, "tuned": True, "boundary": "interior",
                "depth_lane_rates": {"d8": 1.0}, "arbitration": "x",
                "repeats": {"window_steps": steps, "thin": thin}}})
        return out
    window = ((2000, 1), (4000, 2), (1000, 1), (8000, 1))
    entries = [(i, s, dict(epsilon=0.5, beta=0.1, m=5, mass=None, lane=None,
                           integrator="leapfrog"))
               for i, s in enumerate(("mjhmc", "malt", "nuts", "control"))]
    rows, jrows = rows_of(window), rows_of(window)
    tbe._equalize_config_windows("rough_well", entries, rows, 3, 0.2, device="cpu")
    jbe._equalize_config_windows("rough_well", entries, jrows, 3, 0.2)
    assert got == want and [c[2] for c in got] == ["mjhmc", "nuts"]
    assert _plain(rows) == _plain(jrows)
    assert rows[3]["detail"].get("window_equalized_to") is None
    assert rows[0]["detail"]["window_equalized_to"] == 8000
    assert rows[2]["detail"]["depth_lane_rates"] == {"d8": 1.0}


# ---- main --table [--tune] -----------------------------------------------------
@pytest.mark.parametrize("flags", [["--table"], ["--table", "--tune"],
                                   ["--table", "--tune", "--repeats", "2"]],
                         ids=["table", "table tune", "table tune repeats 2"])
def test_main_table_matches_jax(flags, tmp_path, monkeypatch, capsys):
    """The default samplers: the same rows printed as measured (then the
    equalized rows) and the same ``--json-out``, with every stand-in called
    alike. JAX's engine NUTS row arbitrates lane blocks too, so the port's
    ``nuts-engine`` row is held to JAX's plain ``nuts`` row, which has none
    (the engine's name apart)."""
    got, want = _stub_both(monkeypatch, (0.8, 0.03, 10), {4: 1.0, 6: 2.0, 8: 3.0, 10: 4.0,
                                                          12: 5.0})
    argv = [*flags, "--configs", "gauss2d,rough_well", "--steps", "1200", "--burn", "300"]
    assert tbe.main([*argv, "--device", "cpu", "--json-out", str(tmp_path / "t.json")]) == 0
    out = capsys.readouterr().out
    assert jbe.main([*argv, "--samplers", "mjhmc,control,malt,nuts,nuts",
                     "--json-out", str(tmp_path / "j.json")]) == 0
    jout = capsys.readouterr().out

    def engine_as_plain(v):
        return json.loads(json.dumps(v).replace('"nuts-engine"', '"nuts"'))
    assert engine_as_plain(got) == _plain(want)
    assert [engine_as_plain(json.loads(ln)) for ln in out.splitlines()] == \
        [json.loads(ln) for ln in jout.splitlines()]
    rows = json.loads((tmp_path / "t.json").read_text())
    assert engine_as_plain(rows) == json.loads((tmp_path / "j.json").read_text())
    assert len(rows) == 10
    assert [r["detail"]["sampler"] for r in rows] == ["mjhmc", "control", "malt", "nuts-engine",
                                                      "nuts"] * 2
    tuned = "--tune" in flags
    assert all(r["detail"]["tuned"] == tuned for r in rows)
    assert all(("depth_lane_rates" in r["detail"]) == (tuned and "nuts" in r["detail"]["sampler"])
               for r in rows)
    n = int(flags[-1]) if flags[-2:-1] == ["--repeats"] else 5
    assert all(["repeats", n] in c[-1] for c in got if c[0] == "repeats")


# ---- bench_two_stage -----------------------------------------------------------
def _jax_two_stage():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_two_stage", os.path.join(REPO, "tools", "bench_two_stage.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_two_stage_matches_jax(tmp_path, monkeypatch, capsys):
    """A receipts file with a leapfrog mjhmc row, a committed two-stage
    control row, a MALT row and another config's: both integrators at each
    mjhmc/control row's own point (a two-stage row mapped back to leapfrog
    first), JAX's fields; the port adds the card's name and limit."""
    got, want = _stub_both(monkeypatch)
    rows = [{"value": 1.5e6, "detail": {"config": "gauss2d", "sampler": "mjhmc",
                                        "epsilon": 0.9, "beta": 0.05, "num_leapfrog_steps": 7,
                                        "integrator": "leapfrog"}},
            {"value": 2.5e6, "detail": {"config": "rough_well", "sampler": "control",
                                        "epsilon": 2.4, "beta": 0.2, "num_leapfrog_steps": 5,
                                        "integrator": "two_stage"}},
            {"value": 1e6, "detail": {"config": "gauss2d", "sampler": "malt", "epsilon": 0.5,
                                      "beta": 1.0, "num_leapfrog_steps": 5}},
            {"value": 1e6, "detail": {"config": "gauss50d", "sampler": "mjhmc", "epsilon": 0.5,
                                      "beta": 0.1, "num_leapfrog_steps": 5}}]
    receipts = tmp_path / "receipts.json"
    receipts.write_text(json.dumps(rows))
    monkeypatch.setattr(sys, "path", list(sys.path))  # the tool inserts "." at import
    jtool = _jax_two_stage()
    import jax
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    (tmp_path / "docs" / "figures").mkdir(parents=True)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["bench_two_stage.py", "--receipts", str(receipts),
                                      "--repeats", "3"])
    assert jtool.main() == 0
    jout = capsys.readouterr().out
    assert bench_two_stage.main(["--receipts", str(receipts), "--out", str(tmp_path / "t.json"),
                                 "--repeats", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert got == want and len(got) == 4
    jab = json.loads((tmp_path / "docs" / "figures" / "two_stage_receipt.json").read_text())
    ab = json.loads((tmp_path / "t.json").read_text())
    assert [json.loads(ln) for ln in out.splitlines()] == ab
    assert [json.loads(ln) for ln in jout.splitlines()] == jab
    assert all((r.pop("device_name"), r.pop("power_limit")) == ("stub card", "700.00 W")
               for r in ab)
    assert ab == jab
    assert [(r["integrator"], r["epsilon"], r["num_leapfrog_steps"]) for r in ab] == [
        ("leapfrog", 0.9, 7), ("two_stage", 1.8, 3), ("leapfrog", 1.2, 10), ("two_stage", 2.4, 5)]
    with pytest.raises(SystemExit):  # no default receipts or output: JAX's are TPU records
        bench_two_stage.main(["--device", "cpu"])


# ---- the sharded SMC receipt ---------------------------------------------------
def test_sharded_path_receipt_on_two_gloo_ranks():
    """JAX's receipt keys from a mesh of two gloo processes; a rank that
    fails (particles the ranks do not split) makes the call raise."""
    row = bench_heads.sharded_path_receipt(ranks=2, particles=256, stages=4, timeout=120)
    assert set(row) == {"backend", "num_stages", "particles", "wall_s", "stages_per_s",
                        "reached_lambda1"}
    assert row["backend"] == "cpu-gloo-2rank" and (row["num_stages"], row["particles"]) == (4, 256)
    assert row["wall_s"] > 0 and isinstance(row["reached_lambda1"], bool)
    with pytest.raises(RuntimeError, match="ranks failed"):
        bench_heads.sharded_path_receipt(ranks=2, particles=255, stages=2, timeout=120)


# ---- _tune_nuts for real ------------------------------------------------------
def test_tune_nuts_on_gauss2d_against_jax():
    """The warmup at min(256, 100) chains from seed 11 (JAX: key(11)): ε
    within a factor 1.25 of JAX's, the mass (1/variance: 1 and 0.01) within
    15% of JAX's per dim."""
    eps, mass = tbe._tune_nuts(BENCHMARK_CONFIGS["gauss2d"].make_distribution(),
                               BENCHMARK_CONFIGS["gauss2d"], device="cpu")
    jeps, jmass = jbe._tune_nuts(JCONFIGS["gauss2d"].make_distribution(), JCONFIGS["gauss2d"])
    assert isinstance(eps, float) and len(mass) == 2
    assert 1 / 1.25 < eps / jeps < 1.25
    np.testing.assert_allclose(mass, jmass, rtol=0.15)
