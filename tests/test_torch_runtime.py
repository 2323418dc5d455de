"""The runtime's utilities (counterparts of tests/test_utils.py,
tests/test_long_run.py and tests/test_runtime_aux.py): checkpoints plain
and sharded, checkpointed long runs, timing, profiling and the
multi-process initialisation, on the CPU."""

import json

import pytest
import torch
import torch.distributed as dist

from mjhmc_tpu_torch.models import Gaussian
from mjhmc_tpu_torch.parallel.mesh import make_chain_mesh, shard_chain_pytree
from mjhmc_tpu_torch.parallel.multihost import free_port, initialize
from mjhmc_tpu_torch.samplers import MarkovJumpHMC, NUTS, da_init
from mjhmc_tpu_torch.samplers.mjhmc import mjhmc_run
from mjhmc_tpu_torch.samplers.state import make_mj_state
from mjhmc_tpu_torch.utils import Timer, load_pytree, save_pytree, steps_per_second
from mjhmc_tpu_torch.utils.checkpoint import load_sharded_pytree, save_sharded_pytree
from mjhmc_tpu_torch.utils.long_run import run_with_checkpoints
from mjhmc_tpu_torch.utils.profiling import debug_mode, trace
from mjhmc_tpu_torch.utils.pytree import tree_leaves

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y) and x.dtype == y.dtype
        else:
            assert x == y and type(x) is type(y)


def test_checkpoint_roundtrip(tmp_path):
    dist_ = Gaussian(ndims=3, log_conditioning=1.0)
    state, _ = mjhmc_run(dist_, make_mj_state(dist_, _gen(0), 32), _gen(1), 20, 0.5, 0.2, 5,
                         "stats")
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, state)
    restored = load_pytree(path, make_mj_state(dist_, _gen(99), 32))
    _equal_trees(restored, state)


def test_deterministic_resume(tmp_path):
    """checkpoint → continue == uninterrupted run, bit for bit."""
    dist_ = Gaussian(ndims=2, log_conditioning=1.0)
    s_mid, _ = mjhmc_run(dist_, make_mj_state(dist_, _gen(2), 16), _gen(3), 10, 0.5, 0.2, 5)
    s_end, out_end = mjhmc_run(dist_, s_mid, _gen(4), 10, 0.5, 0.2, 5)
    path = str(tmp_path / "mid.npz")
    save_pytree(path, s_mid)
    s_res = load_pytree(path, make_mj_state(dist_, _gen(5), 16))
    s_end2, out_end2 = mjhmc_run(dist_, s_res, _gen(4), 10, 0.5, 0.2, 5)
    assert torch.equal(s_end.chain.x, s_end2.chain.x)
    assert torch.equal(out_end["sel"], out_end2["sel"])


def test_checkpoint_generator_and_scalars(tmp_path):
    """A generator's state is the counterpart of the PRNG-key leaf; the
    dual-averaging state's Python and NumPy scalars keep their types."""
    gen = _gen(7)
    torch.rand(5, generator=gen)
    tree = {"g": gen, "x": torch.ones(3), "da": da_init(0.5)}
    path = str(tmp_path / "k.npz")
    save_pytree(path, tree)
    restored = load_pytree(path, {"g": _gen(0), "x": torch.zeros(3), "da": da_init(1.0)})
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=restored["g"]))
    _equal_trees(restored["da"], tree["da"])
    assert torch.equal(restored["x"], tree["x"])


@pytest.fixture
def mesh1():
    initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        yield make_chain_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_sharded_checkpoint_roundtrip_world1(mesh1, tmp_path):
    """Per-process save and index-matched restore is bit-exact, and resuming
    from it reproduces the uninterrupted run (tests/test_utils.py:78)."""
    dist_ = Gaussian(ndims=3, log_conditioning=1.0)

    def run(s, seed):
        return mjhmc_run(dist_, s, _gen(seed), 10, 0.5, 0.2, 5, "stats")[0]

    seg1 = run(shard_chain_pytree(make_mj_state(dist_, _gen(0), 64), mesh1), 1)
    prefix = str(tmp_path / "carry")
    path = save_sharded_pytree(prefix, {"state": seg1, "gen": _gen(3)}, mesh1)
    assert path.endswith(".proc0of1.npz")
    example = {"state": shard_chain_pytree(make_mj_state(dist_, _gen(9), 64), mesh1),
               "gen": _gen(0)}
    restored = load_sharded_pytree(prefix, example, mesh1)
    _equal_trees(restored["state"], seg1)
    assert torch.equal(torch.rand(3, generator=restored["gen"]), torch.rand(3, generator=_gen(3)))
    _equal_trees(run(restored["state"], 2), run(seg1, 2))


def test_sharded_checkpoint_rejects_wrong_sharding(mesh1, tmp_path):
    prefix = str(tmp_path / "x")
    save_sharded_pytree(prefix, {"x": torch.arange(64, dtype=torch.float32)[None, :]}, mesh1)
    with pytest.raises(KeyError):
        load_sharded_pytree(prefix, {"x": torch.zeros(1, 32)}, mesh1)


def test_run_with_checkpoints_resumes_bit_exact(tmp_path):
    dist_ = Gaussian(ndims=2, log_conditioning=1.0)

    def fresh():
        return MarkovJumpHMC(dist_, epsilon=0.5, beta=0.2, num_leapfrog_steps=5, nbatch=32,
                             seed=7, device="cpu")

    a = fresh()
    assert run_with_checkpoints(a, 40, 10, str(tmp_path / "a.npz"))["steps_run"] == 40
    run_with_checkpoints(fresh(), 20, 10, str(tmp_path / "b.npz"))  # then "crash"
    c = fresh()  # a new process
    info = run_with_checkpoints(c, 40, 10, str(tmp_path / "b.npz"))
    assert info == {"resumed_from": 20, "steps_run": 20, "final_step": 40}
    assert torch.equal(a.state.chain.x, c.state.chain.x)
    assert torch.equal(a.state.grad_evals, c.state.grad_evals)
    assert torch.equal(a.generator.get_state(), c.generator.get_state())


def test_run_with_checkpoints_nuts(tmp_path):
    """Samplers whose ``_run`` takes no ``collect`` (NUTS) resume too."""
    dist_ = Gaussian(ndims=2, log_conditioning=1.0)

    def fresh():
        return NUTS(dist_, epsilon=0.5, max_depth=4, nbatch=16, seed=3, device="cpu")

    a = fresh()
    run_with_checkpoints(a, 6, 3, str(tmp_path / "a.npz"))
    run_with_checkpoints(fresh(), 3, 3, str(tmp_path / "b.npz"))
    c = fresh()
    assert run_with_checkpoints(c, 6, 3, str(tmp_path / "b.npz"))["resumed_from"] == 3
    assert torch.equal(a.state.x, c.state.x)


def test_timer_and_steps_per_second():
    x = torch.ones(64)
    with Timer(sync_value=x) as t:
        y = x * 2
    assert t.elapsed > 0
    calls = []
    best, out = steps_per_second(lambda v: calls.append(1) or v + 1, y, warmup=2, iters=3)
    assert best > 0 and len(calls) == 5 and torch.equal(out, y + 1)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert prof is not None
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_debug_mode_catches_nan():
    with debug_mode(nans=True):
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0)) * 0 + torch.sqrt(torch.tensor(-1.0))
        torch.log(torch.tensor(2.0))  # finite results pass
    with debug_mode(nans=False):
        assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_initialize_single_process_without_environment(monkeypatch):
    """No cluster arguments and no torchrun environment: single-process,
    the swallowed error reported (tests/test_runtime_aux.py:14)."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    info = initialize(device="cpu")
    assert not dist.is_initialized() and not info["initialized"]
    assert info["process_count"] == 1 and info["global_devices"] == 1
    assert info["process_index"] == 0 and info["backend"] == "gloo"
    assert "error" in info and info["error"].startswith("ValueError")


def test_initialize_explicit_spec_raises():
    with pytest.raises(ValueError):
        initialize(num_processes=2, device="cpu")  # no address, no rank
    assert not dist.is_initialized()


def test_initialize_explicit_world1():
    info = initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        assert info["initialized"] and info["process_count"] == 1 and dist.get_world_size() == 1
        assert initialize(device="cpu")["initialized"]  # joined already: reported as it is
    finally:
        dist.destroy_process_group()


def test_initialize_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts without one")
    with pytest.raises(RuntimeError):
        initialize(device="cuda")
    assert not dist.is_initialized()
