"""``utils.profiling.parse_trace_collectives`` (counterpart of JAX's, on the
torch profiler's trace) and the ``collective_time_fraction`` line of
``bench_scaling --profile``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from mjhmc_tpu_torch import bench_scaling
from mjhmc_tpu_torch.parallel.multihost import free_port
from mjhmc_tpu_torch.utils.profiling import parse_trace_collectives

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _write(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_fraction_of_a_hand_written_trace(tmp_path):
    """Device kernels present: kernels alone count, NCCL's are the
    collectives. Else the outermost CPU ops of each thread count, and the
    outermost gloo/c10d op of a nest is the collective."""
    kernels = [
        _ev("sm90_mjhmc_kernel", "kernel", 0, 300.0),
        _ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "kernel", 300, 100.0),
        _ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "kernel", 500, 50.0),
        _ev("aten::mul", "cpu_op", 0, 10_000.0),  # host ops are not counted here
        _ev("c10d::allreduce_", "cpu_op", 0, 5_000.0),
    ]
    _write(str(tmp_path / "gpu" / "rank0" / "trace.json"), kernels)
    got = parse_trace_collectives(str(tmp_path / "gpu"))
    assert got["total_us"] == 450.0 and got["collective_us"] == 150.0
    assert got["fraction"] == pytest.approx(150.0 / 450.0, rel=0, abs=1e-15)
    assert got["by_op"] == {"ncclDevKernel_AllReduce_Sum_f32_RING_LL": 150.0}

    cpu = [
        _ev("aten::add", "cpu_op", 0, 40.0),
        _ev("aten::to", "cpu_op", 5, 10.0),            # inside aten::add
        _ev("c10d::allreduce_", "cpu_op", 100, 60.0),
        _ev("record_param_comms", "cpu_op", 110, 20.0),  # inside the collective
        _ev("gloo:all_reduce", "user_annotation", 200, 30.0, tid=2),  # gloo's thread
        _ev("Trace PyTorch Profiler", "Trace", 0, 1e6),  # not an op
        {"ph": "i", "name": "marker", "ts": 5},
    ]
    _write(str(tmp_path / "cpu" / "trace.json"), cpu)
    got = parse_trace_collectives(str(tmp_path / "cpu"))
    assert got["total_us"] == 130.0 and got["collective_us"] == 90.0
    assert got["fraction"] == pytest.approx(90.0 / 130.0, rel=0, abs=1e-15)
    assert got["by_op"] == {"c10d::allreduce_": 60.0, "gloo:all_reduce": 30.0}

    empty = parse_trace_collectives(str(tmp_path / "none"))
    assert empty["fraction"] == 0.0 and empty["trace"] is None


#: one gloo rank of the real trace: four all_reduces inside ``trace()``
#: (``python -c`` for rank 1, ``exec`` here for rank 0)
_RANK = """
import os, sys, torch
import torch.distributed as dist
from mjhmc_tpu_torch.utils.profiling import trace

def gloo_rank(rank, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    try:
        t = torch.ones(4096)
        with trace(os.path.join(out, f"rank{rank}")):
            for _ in range(4):
                t = t * 0.5 + 1.0
                dist.all_reduce(t)
        dist.barrier()
    finally:
        dist.destroy_process_group()

if __name__ == "__main__":
    gloo_rank(int(sys.argv[1]), sys.argv[2], sys.argv[3])
"""


def test_fraction_of_a_real_two_rank_gloo_trace(tmp_path):
    """Rank 1 in a process of its own, rank 0 here."""
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, (REPO, os.environ.get("PYTHONPATH")))))
    other = subprocess.Popen([sys.executable, "-c", _RANK, "1", port, str(tmp_path)], env=env,
                             cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        here = {"__name__": "rank0"}
        exec(_RANK, here)
        here["gloo_rank"](0, port, str(tmp_path))
        _, err = other.communicate(timeout=120)
    finally:
        if other.poll() is None:
            other.kill()
            other.wait()
    assert other.returncode == 0, err[-3000:]
    got = parse_trace_collectives(str(tmp_path / "rank0"))
    assert got["trace"].endswith(os.path.join("rank0", "trace.json"))
    assert 0.0 < got["fraction"] <= 1.0
    assert 0.0 < got["collective_us"] <= got["total_us"]
    assert any(k.startswith(("gloo:", "c10d")) for k in got["by_op"])


def test_bench_scaling_profile_prints_the_collective_line(tmp_path, capsys):
    assert bench_scaling.main(["--device", "cpu", "--engine", "torch", "--devices", "1",
                               "--chains-per-device", "32", "--steps", "3",
                               "--profile", str(tmp_path)]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["metric"] for r in recs] == ["leapfrog_steps_per_sec", "collective_time_fraction"]
    line = recs[1]
    assert set(line) == {"metric", "devices", "value", "unit", "collective_us", "total_us",
                         "by_op"}
    assert line["devices"] == 1 and line["unit"] == "fraction"
    assert 0.0 <= line["value"] <= 1.0 and line["total_us"] > 0
    assert (tmp_path / "rank0" / "trace.json").exists()
