"""The port's CLI for slice H (``search``, ``figures``, ``efficiency``,
``bench --profile``) and ``examples/quickstart_torch.py``, on the CPU at
small sizes: the records carry the JAX package's keys
(``mjhmc_tpu/__main__.py``), the outputs land under ``--out``, the card is
the default device and its absence an error, and no new module imports
JAX."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mjhmc_tpu_torch.__main__ import main
from mjhmc_tpu_torch.utils import init_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_KEYS = {"epsilon", "beta", "num_leapfrog_steps", "decay_evals", "censored"}

torch.set_num_threads(1)


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("method,rows", [("grid", 9), ("bayes", 6 + 2)])
def test_search_command(method, rows):
    rec = json.loads(_run(["search", "--config", "gauss2d", "--method", method, "--iters", "2",
                           "--steps", "60", "--nbatch", "16", "--device", "cpu"]
                          ).strip().splitlines()[-1])
    assert set(rec) == {"best", "table"} and len(rec["table"]) == rows
    assert all(set(r) == ROW_KEYS for r in rec["table"]) and rec["best"] in rec["table"]
    if method == "grid":  # JAX's default grid, M 5
        assert [(r["epsilon"], r["beta"]) for r in rec["table"][:2]] == [(0.1, 0.05), (0.1, 0.2)]
        assert {r["num_leapfrog_steps"] for r in rec["table"]} == {5}


def test_figures_command_writes_under_out(tmp_path):
    out = _run(["figures", "--quick", "--only", "spectral", "--out", str(tmp_path),
                "--device", "cpu"])
    assert "[figures] spectral" in out and sorted(os.listdir(tmp_path)) == [
        "spectral_gap.npz", "spectral_gap.png"]
    z = np.load(tmp_path / "spectral_gap.npz")
    assert z["ks"].tolist() == [4, 8, 16] and len(z["betas"]) == 5
    assert (z["cont_k"] > 0).all() and np.isfinite(z["disc_b"]).all()


def test_efficiency_command_writes_under_out(tmp_path, monkeypatch):
    monkeypatch.setattr(init_cache, "DEFAULT_CACHE_DIR", str(tmp_path / "init"))
    out = str(tmp_path / "e" / "claim")
    rec = json.loads(_run(["efficiency", "--quick", "--out", out, "--device", "cpu"]
                          ).strip().splitlines()[-1])
    assert rec["out"] == out and set(rec["ratios"]) == {"rough_well[a=2]"}
    assert sorted(os.listdir(tmp_path / "e")) == ["claim.json", "claim.npz", "claim.png"]


def test_bench_profile_writes_a_trace(tmp_path, monkeypatch, capsys):
    """``bench --profile DIR``: ``bench.main`` (here a small CPU call in its
    place) runs under the profiler and ``DIR/trace.json`` is written."""
    from mjhmc_tpu_torch import bench

    def small_bench():
        x = torch.randn(64, 64)
        print(json.dumps({"value": float((x @ x).sum())}))
        return 0

    monkeypatch.setattr(bench, "main", small_bench)
    with pytest.raises(SystemExit) as e:
        main(["bench", "--profile", str(tmp_path)])
    assert e.value.code == 0
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    assert "trace written to" in capsys.readouterr().err


def test_quickstart_runs_on_the_cpu():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "examples", "quickstart_torch.py"),
                           "--device", "cpu", "--quick"], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("dwell-weighted variance") and "PT variance" in lines[2]
    assert lines[3].startswith("mjhmc: grad evals") and lines[4].startswith("control: grad evals")


def test_bench_battery_projects_each_target(monkeypatch, tmp_path):
    """The battery's cost, projected from one tiny target: n_eps · n_beta
    points at each M, linear in M between the two timed grid points, plus
    4 confirmations and the shared init; the cache is left as it was."""
    from mjhmc_tpu_torch import bench_battery
    from mjhmc_tpu_torch.models import RoughWell

    monkeypatch.setattr(init_cache, "DEFAULT_CACHE_DIR", str(tmp_path / "init"))
    tiny = (("rw", lambda: RoughWell(2, 100.0, 4.0, amplitude=2.0),
             dict(num_steps=40, nlags=12, search_steps=30, search_nlags=10, n_eps=2, n_beta=3,
                  m_grid=(1, 2, 3), nbatch=8)),)
    rec = bench_battery.time_battery(tiny, device="cpu")
    assert rec["device_name"] == "cpu" and len(rec["rows"]) == 1
    row = rec["rows"][0]
    assert (row["points_per_m"], row["confirm_nlags"], row["confirm_steps"]) == (6, 12, 40)
    assert (row["epsilon"], row["beta"]) == pytest.approx((1.0, np.sqrt(2e-4)))  # the defaults
    total = row["init_s"]
    for sampler in ("mjhmc", "control"):
        r = row["samplers"][sampler]
        p1, p3 = r["point_s"]["1"], r["point_s"]["3"]
        assert r["projected_sweep_s"] == pytest.approx(6 * (p1 + (p1 + p3) / 2 + p3))
        assert r["projected_confirm_s"] == pytest.approx(4 * r["confirm_s"])
        assert r["ms_an_iteration"]["3"] == pytest.approx(1e3 * p3 / 30)
        total += r["projected_sweep_s"] + r["projected_confirm_s"]
    assert rec["projected_hours"] == pytest.approx(total / 3600)
    assert not (tmp_path / "init").exists()


@pytest.mark.parametrize("argv", [
    ["search", "--config", "gauss2d"],
    ["figures", "--quick", "--only", "spectral"],
    ["efficiency", "--quick"],
], ids=["search", "figures", "efficiency"])
def test_new_subcommands_default_to_the_card(argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        main(argv)
    assert not os.listdir(tmp_path)


def test_slice_h_modules_import_no_jax():
    """Nor matplotlib at import, nor ``torch._dynamo`` (the import
    ``torch.optim``'s optimizers make at first use) in a GP-EI search."""
    code = (
        "import sys\n"
        "import mjhmc_tpu_torch.search, mjhmc_tpu_torch.search.bayes\n"
        "import mjhmc_tpu_torch.experiments.figures, mjhmc_tpu_torch.experiments.efficiency_claim\n"
        "import mjhmc_tpu_torch.__main__, mjhmc_tpu_torch.config, mjhmc_tpu_torch.bench_battery\n"
        "from mjhmc_tpu_torch.search.bayes import bayes_minimize\n"
        "bayes_minimize(lambda p: float(p[0] ** 2), [(-1.0, 1.0)], num_init=3, num_iters=1,\n"
        "               num_candidates=64, device='cpu')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'mjhmc_tpu.', 'matplotlib',\n"
        "                                            'torch._dynamo')))\n"
        "assert not bad, bad\n"
        "from mjhmc_tpu_torch import ControlHMCConfig, MJHMCConfig, NUTSConfig\n"
        "assert ControlHMCConfig().beta == 0.2 and ControlHMCConfig().flip_on_reject\n"
        "assert MJHMCConfig().beta == 0.1 and NUTSConfig().max_depth == 8\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
