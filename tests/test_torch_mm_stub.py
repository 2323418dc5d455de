"""The ``stub_dots`` ablation of the matmul engine's plain version vs the
TPU kernel with ``dataclasses.replace(spec, has_pair=False,
stub_dots=True)`` in Pallas interpret mode (variant ``mjhmc``).

Under the stub every contraction is 1e-3·(row 0 of its dynamic operand)
broadcast over the output rows, for each trajectory on its own: the
``has_pair=False`` form (with the pair path on, the JAX stub feeds the
forward half's row 0 to both halves; the port has no pair operand).
Counters must be exactly equal and states agree to rtol 1e-5 after 3
iterations (atol 1e-5 of the field's largest value): with the products
stubbed the dynamics are nearly free motion, not the chaotic full energy.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.ops.pallas_mjhmc import energy_spec_for, pallas_mjhmc_mm_run
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

N = 256


def _state(jd, scale, seed=0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((jd.ndims, N))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, N)).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = np.zeros(N, np.float32)
    return x, v, g, u, z, z.copy()


@pytest.mark.parametrize("name,scale,eps,m", [("ProductOfT", 2.0, 0.12, 10),
                                              ("SparseCoding", 0.1, 0.02, 10)])
def test_stub_matches_interpret_kernel(name, scale, eps, m):
    jd, td = getattr(jmodels, name)(), getattr(tmodels, name)()
    jspec = energy_spec_for(jd)
    pair = {"has_pair": False} if "has_pair" in {f.name for f in dataclasses.fields(jspec)} else {}
    jspec = dataclasses.replace(jspec, stub_dots=True, **pair)
    tspec = dataclasses.replace(cm.energy_spec_for(td), stub_dots=True)
    st = _state(jd, scale)
    x, v, g, u, hb, bv = (jnp.asarray(a) for a in st)
    out_j = pallas_mjhmc_mm_run(jspec, x, v, g, u[None], hb[None], bv[None], jnp.int32(7),
                                jnp.float32(eps), jnp.float32(0.1), 3, m,
                                interpret=pltpu.InterpretParams())
    out_t = cm.run_reference(tspec, *(torch.as_tensor(a) for a in st), 7, eps, 0.1, 3, m,
                             fixed_uniform=True)
    np.testing.assert_array_equal(out_t.evals.numpy(), np.asarray(out_j.evals).ravel())
    np.testing.assert_array_equal(out_t.back_valid.numpy(), np.asarray(out_j.back_valid).ravel())
    for f in ("x", "v", "grad", "u", "h_back"):
        want = np.asarray(getattr(out_j, f), np.float64).reshape(getattr(out_t, f).shape)
        np.testing.assert_allclose(getattr(out_t, f).double().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=f"{name} {f}")
    # the stub changes the trajectories: the full energy lands elsewhere
    full = cm.run_reference(cm.energy_spec_for(td), *(torch.as_tensor(a) for a in st),
                            7, eps, 0.1, 3, m, fixed_uniform=True)
    assert not torch.allclose(full.x, out_t.x, rtol=1e-3)


def test_stub_contraction_form():
    """1e-3·row 0 of the dynamic operand on each of the matrix's rows, per
    stacked trajectory; the full form is the plain product."""
    m = torch.randn(5, 3)
    b = torch.randn(2, 3, 7)  # two stacked trajectories
    got = cm._contract(True, m, b)
    assert got.shape == (2, 5, 7)
    want = b[:, :1, :] * torch.tensor(1e-3, dtype=torch.float32)
    assert torch.equal(got, want.expand(2, 5, 7))
    assert torch.equal(cm._contract(False, m, b), torch.matmul(m, b))


def test_stub_wrapper_counts_apart_and_cpu_takes_plain_version():
    spec = cm.ProductOfTSpec(tmodels.ProductOfT(), stub_dots=True)
    ts = tuple(torch.as_tensor(a) for a in _state(jmodels.ProductOfT(), 2.0, seed=3))
    before = (cm.cuda_mjhmc_mm_run.launches, cm.cuda_mjhmc_mm_run.stub_launches)
    a = cm.cuda_mjhmc_mm_run(spec, *ts, 5, 0.12, 0.1, 2, 10)
    b = cm.run_reference(spec, *ts, 5, 0.12, 0.1, 2, 10)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (cm.cuda_mjhmc_mm_run.launches, cm.cuda_mjhmc_mm_run.stub_launches) == before
