"""The port's roofline dossier (``mjhmc_tpu_torch/bench_mfu.py``) against
the JAX one (root ``bench_mfu.py``), on the CPU.

Both ``engine_rows`` run with their timers and engines replaced by fakes
(no kernel runs here), so that the rows' op counts and keys can be held
against each other: the port keeps the JAX op counts exactly and the
presets' JAX default precisions (product of t one bf16 pass, sparse coding
``[bf16x3]``, executed FLOPs 3× the useful ones), renames ``pair=on`` to
``full`` and drops the ``pair=off`` row. ``main`` exits 1 without a CUDA
device and writes a file only when ``--json-out`` is given.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bench_mfu as jax_mfu
from mjhmc_tpu.ops import pallas_mjhmc
from mjhmc_tpu_torch import bench as tbench
from mjhmc_tpu_torch import bench_mfu
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

#: port row name -> JAX row name
ROWS = {
    "mjhmc_roughwell_elementwise": "mjhmc_roughwell_elementwise",
    "mjhmc_product_of_t[full]": "mjhmc_product_of_t[pair=on]",
    "mjhmc_product_of_t[dots=stubbed]": "mjhmc_product_of_t[dots=stubbed]",
    "mjhmc_product_of_t[ablation_verdict]": "mjhmc_product_of_t[ablation_verdict]",
    "mjhmc_sparse_coding[bf16x3]": "mjhmc_sparse_coding[bf16x3]",
    "nuts_gauss2d_elementwise": "nuts_gauss2d_elementwise",
}
COUNTS = ("flops_per_iteration", "transcendentals_per_iteration",
          "matmul_flops_per_iteration", "matmul_flops_per_iteration_useful", "flops_per_leaf")


def _jax_rows(monkeypatch):
    monkeypatch.setattr(jax_mfu, "_engine_steps_per_s", lambda eng, steps: 1000.0)
    monkeypatch.setattr(jax_mfu, "_timed", lambda fn, *a, reps=3: 1.0)
    monkeypatch.setattr(pallas_mjhmc.PallasNUTS, "run",
                        lambda self, n: SimpleNamespace(evals=np.ones((self.nbatch,), np.int32)))
    return {r["engine"]: r for r in jax_mfu.engine_rows(steps=1)}


class _FakeEngine:
    """Stands in for CudaMJHMC / CudaNUTS: the real energy spec, no run."""

    def __init__(self, dist, nbatch, **kw):
        self.spec, self.nbatch = cm.energy_spec_for(dist), nbatch
        self.last_out = None

    def run(self, n):
        self.last_out = SimpleNamespace(evals=torch.ones(self.nbatch, dtype=torch.int32))


def _port_rows(monkeypatch):
    monkeypatch.setattr(bench_mfu, "_iterations_per_s", lambda eng, steps: 1000.0)
    monkeypatch.setattr(bench_mfu, "_events_s", lambda fn: (fn(), 1.0)[1])
    monkeypatch.setattr(bench_mfu, "warp_leaf_utilization", lambda eng: 0.5)
    monkeypatch.setattr(cm, "CudaMJHMC", _FakeEngine)
    monkeypatch.setattr(cm, "CudaNUTS", _FakeEngine)
    return bench_mfu.engine_rows(steps=5)


def test_engine_rows_keep_the_jax_op_counts_and_keys(monkeypatch):
    jrows = _jax_rows(monkeypatch)
    rows = _port_rows(monkeypatch)
    assert [r["engine"] for r in rows] == list(ROWS)
    assert set(jrows) - set(ROWS.values()) == {"mjhmc_product_of_t[pair=off]"}
    for r in rows:
        j = jrows[ROWS[r["engine"]]]
        assert set(j) <= set(r), (r["engine"], set(j) - set(r))
        for k in COUNTS:
            if k in j:
                assert r[k] == j[k], (r["engine"], k)
    assert (bench_mfu.ROUGH_WELL_FLOPS, bench_mfu.ROUGH_WELL_SINS) == (400, 40)
    assert bench_mfu.PRODUCT_OF_T_MM_FLOPS == 103_680
    assert bench_mfu.SPARSE_CODING_MM_FLOPS == 655_360
    assert bench_mfu.NUTS_FLOPS_PER_LEAF == 60
    # the presets' precisions: bf16x3 executes 3× the useful FLOPs, as on
    # the TPU; product of t one pass
    sc = rows[4]
    assert sc["precision"] == "bf16x3" and rows[1]["precision"] == "default"
    assert sc["matmul_flops_per_iteration_executed"] == 3 * sc["matmul_flops_per_iteration_useful"]
    assert jrows["mjhmc_sparse_coding[bf16x3]"]["matmul_flops_per_iteration_executed"] == 3 * 655_360
    assert (rows[0]["ceiling"], rows[1]["ceiling"], sc["ceiling"], rows[5]["ceiling"]) == (
        "fp32_fma", "tc_mma_sync", "tc_mma_sync", "fp32_fma")
    # the stubbed row ran the stub: its spec carries the flag
    assert rows[2]["matmul_flops_per_iteration"] == 0
    assert rows[5]["tree_leaves_per_s"] == 10_240 and rows[5]["warp_leaf_utilization"] == 0.5


def test_main_exits_1_without_a_cuda_device(monkeypatch, tmp_path, capsys):
    out = tmp_path / "dossier.json"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_mfu.main(["--json-out", str(out)]) == 1
    assert not out.exists()
    assert "CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("json_out", [False, True])
def test_main_shares_against_the_fp32_ceiling(monkeypatch, tmp_path, capsys, json_out):
    """mfu = achieved / the FP32 FMA ceiling on the rough well and NUTS,
    / the mma.sync ceiling on the matmul rows (executed FLOPs); the rough
    well's sinf share against the sinf ceiling; a file only with
    --json-out."""
    ceilings = {"tc_bf16_mma_sync_flops_per_s": 4e14, "tc_depth_occupancy_flops_per_s": {},
                "fp32_fma_flops_per_s": 6e13, "fp32_sinf_chain_flops_per_s": 2e12,
                "sinf_per_s": 1e12, "probes": {}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tbench, "gpu_name_and_power_limit", lambda: ("card", "700.00 W"))
    monkeypatch.setattr(bench_mfu, "measure_ceilings", lambda: ceilings)
    rows = _port_rows(monkeypatch)
    monkeypatch.setattr(bench_mfu, "engine_rows", lambda steps: [dict(r) for r in rows])
    monkeypatch.chdir(tmp_path)
    argv = ["--steps", "7"] + (["--json-out", "d.json"] if json_out else [])
    assert bench_mfu.main(argv) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["ceilings"] == ceilings
    assert lines[0]["device"] == {"name": "card", "power_limit": "700.00 W", "steps": 7}
    got = {r["engine"]: r for r in lines[1:]}
    rw = got["mjhmc_roughwell_elementwise"]
    assert rw["mfu"] == pytest.approx(1000.0 * 400 / 6e13)
    assert rw["sinf_share"] == pytest.approx(1000.0 * 40 / 1e12)
    assert got["mjhmc_sparse_coding[bf16x3]"]["mfu"] == pytest.approx(1000.0 * 3 * 655_360 / 4e14)
    assert got["mjhmc_product_of_t[full]"]["mfu"] == pytest.approx(1000.0 * 103_680 / 4e14)
    assert got["nuts_gauss2d_elementwise"]["mfu"] == pytest.approx(10_240 * 60 / 6e13)
    assert "mfu" not in got["mjhmc_product_of_t[ablation_verdict]"]
    assert "mfu" not in got["mjhmc_product_of_t[dots=stubbed]"]
    assert (tmp_path / "d.json").exists() == json_out
    assert [p.name for p in tmp_path.iterdir()] == (["d.json"] if json_out else [])
