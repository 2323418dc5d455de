"""The port's CLI for slices D and F (``sample --sampler reduced_flip|pt``,
``smc``, ``vi``), ``bench_heads``, and the rules every new entry point
keeps: the records carry the JAX package's keys
(``mjhmc_tpu/__main__.py``), the card is the default device and its
absence an error, the fused engine refuses the samplers it lacks, and no
module of the port imports JAX."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from mjhmc_tpu_torch import bench_heads
from mjhmc_tpu_torch.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

#: the JAX CLI's record keys (mjhmc_tpu/__main__.py cmd_sample, cmd_smc, cmd_vi)
SAMPLE_KEYS = {"config", "sampler", "steps", "chains", "grad_evals", "mean", "var", "ess",
               "ess_per_grad_eval"}
PT_KEYS = {"betas", "swap_rates", "round_trip_rate"}
SMC_KEYS = {"config", "log_evidence", "final_lambda", "particles", "mean", "var"}
VI_KEYS = {"config", "rank", "final_elbo", "mu", "sigma"}


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_sample_pt_with_adapted_ladder():
    rec = _run(["sample", "--config", "mog", "--sampler", "pt", "--engine", "torch",
                "--adapt-ladder", "--device", "cpu", "--nbatch", "32", "--burn", "20",
                "--steps", "40", "--num-temps", "4", "--beta-min", "0.05"])
    assert set(rec) == SAMPLE_KEYS | PT_KEYS | {"engine"}
    assert rec["grad_evals"] == 40 * 32 * 4 * 5  # T·M per iteration, after burn-in
    assert len(rec["betas"]) == 4 and rec["betas"][-1] == 1.0
    assert len(rec["swap_rates"]) == 3 and rec["round_trip_rate"] >= 0.0


def test_sample_reduced_flip():
    rec = _run(["sample", "--config", "rough_well", "--sampler", "reduced_flip", "--engine",
                "torch", "--device", "cpu", "--nbatch", "64", "--burn", "20", "--steps", "40"])
    assert set(rec) == SAMPLE_KEYS | {"engine"}
    assert rec["grad_evals"] == 40 * 64 * 2 * 10 and rec["chains"] == 64


@pytest.mark.parametrize("sampler", ["pt", "reduced_flip"])
def test_engine_cuda_refuses_the_plain_only_samplers(sampler):
    with pytest.raises(SystemExit, match="cuda supports mjhmc/control/malt/nuts"):
        main(["sample", "--config", "gauss2d", "--sampler", sampler, "--engine", "cuda",
              "--device", "cpu", "--steps", "10", "--nbatch", "32"])


def test_smc_command():
    rec = _run(["smc", "--config", "product_of_t", "--device", "cpu", "--nbatch", "256",
                "--stages", "6"])
    assert set(rec) == SMC_KEYS
    assert rec["particles"] == 256 and len(rec["mean"]) == 8
    assert 0.0 < rec["final_lambda"] <= 1.0


@pytest.mark.parametrize("rank", [0, 2])
def test_vi_command(rank):
    rec = _run(["vi", "--config", "gauss2d", "--device", "cpu", "--rank", str(rank)])
    assert set(rec) == VI_KEYS | ({"cov_diag"} if rank else set())
    assert len(rec["mu"]) == len(rec["sigma"]) == 2
    # gauss2d: the marginal sds → (1, 10); with a low-rank factor, σ is
    # only D's part and the marginals are the covariance's diagonal
    sd = [v**0.5 for v in rec["cov_diag"]] if rank else rec["sigma"]
    assert abs(sd[0] - 1.0) < 0.15 and abs(sd[1] - 10.0) < 1.5


@pytest.mark.parametrize("cmd", ["smc", "vi"])
def test_heads_default_to_the_card(cmd, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        main([cmd, "--config", "gauss2d"])


@pytest.mark.parametrize("name", ["ReducedFlipHMC", "ParallelTempering", "SMC", "ADVI",
                                  "smc_run", "advi_fit"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Without ``device`` the new classes and the heads' runners run on the
    card: on a machine without one they refuse rather than run on the CPU."""
    from mjhmc_tpu_torch import inference, models, samplers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entry = getattr(samplers, name, None) or getattr(inference, name)
    args = {"smc_run": (torch.Generator(), 64), "advi_fit": (None,)}.get(name, ())
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        entry(models.Gaussian(ndims=2), *args)


def test_bench_heads_rows_on_the_cpu(capsys, monkeypatch):
    """Every row, at a test's size (256 particles, 100 VI steps; the sharded
    path on 2 gloo ranks, 4 stages)."""
    for name, value in (("SWEEP_PARTICLES", 256), ("SWEEP_STAGES", (6, 12)),
                        ("ANNEAL_PARTICLES", 256), ("ANNEAL_STAGES", 10), ("VI_STEPS", 100),
                        ("SHARDED_RANKS", 2), ("SHARDED_PARTICLES", 256),
                        ("SHARDED_STAGES", 4)):
        monkeypatch.setattr(bench_heads, name, value)
    assert bench_heads.main(["--device", "cpu", "--repeats", "1"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 2 + 1 + 3 + 1
    assert rows.pop()["backend"] == "cpu-gloo-2rank"  # a CPU path receipt, not the device's
    assert all(r["device_name"] == "cpu" and "power_limit" in r for r in rows)
    assert [r["num_stages"] for r in rows[:3]] == [6, 12, 10]
    assert [r["target"] for r in rows[3:]] == ["gauss50d(mean-field)",
                                               "sparse_coding(mean-field)",
                                               "sparse_coding(rank16)"]
    assert all(r["wall_s"] > 0 for r in rows) and "kl_gap_nats" in rows[3]


def test_bench_heads_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_heads.main(["--repeats", "1"]) == 1


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import mjhmc_tpu_torch.samplers.reduced_flip, mjhmc_tpu_torch.samplers.tempering\n"
        "import mjhmc_tpu_torch.samplers.chees, mjhmc_tpu_torch.inference.smc\n"
        "import mjhmc_tpu_torch.inference.vi, mjhmc_tpu_torch.bench_heads\n"
        "import mjhmc_tpu_torch.bench_ess, mjhmc_tpu_torch.bench_two_stage\n"
        "import mjhmc_tpu_torch.convert, mjhmc_tpu_torch.__main__\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'mjhmc_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
