"""The zoo energies (funnel, banana, Gaussian mixture, eight schools in both
parameterizations) in every body of the elementwise engine's plain version,
against the TPU kernels in Pallas interpret mode (``pallas_mjhmc_run`` and
``pallas_mjhmc_stream_run``), at 1,024 chains from the same NumPy state.

Interpret mode returns zero PRNG bits, so every uniform of the JAX kernel
is 2⁻²⁵; the port's ``fixed_uniform=True`` reproduces that. MJHMC,
control and MALT run 5 iterations at the presets' ε and M, NUTS 3 at
max_depth 5 (test_torch_zoo_nuts.py, with the branches). Every momentum is then the same large draw (5.9·√M per dim),
which carries chains into the energies' stiff regions (the funnel's neck,
the banana's arms, centered eight schools at small τ), where the dynamics
are chaotic at the presets' ε. XLA contracts and reorders float32
operations that torch rounds one by one (the specs' energies differ in the
last bit on a third of the chains) and its ``exp``, ``log`` and ``cos``
round apart by an ulp, so a few chains there part. The tests therefore hold,
on every chain that one-ulp nudges (of x or of ε, up and down) do not move
past rtol 1e-5 in the plain version alone: counters (evals, stream es)
exactly, and states, emissions and Kahan sums within rtol 1e-4 (atol 1e-4
of the field's largest finite value), non-finite on the same chains. The
nudged chains are counted and bounded (``MAX_NUDGED``); on them the
comparison says nothing either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.ops.pallas_mjhmc import (
    energy_spec_for,
    pallas_mjhmc_run,
    pallas_mjhmc_stream_run,
)
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

from test_torch_engine import _jax_state, _port_state

torch.set_num_threads(1)

IP = pltpu.InterpretParams()
N = 1024
NUTS_DEPTH = 5
#: (model, kwargs, the preset's ε and M)
ZOO = {
    "funnel": ("Funnel", {}, 0.1, 8),
    "banana": ("Banana", {}, 0.25, 8),
    "mog": ("GaussianMixture", {}, 0.4, 5),
    "eight_schools": ("EightSchools", {}, 0.5, 8),
    "eight_schools_nc": ("EightSchools", dict(parameterization="noncentered"), 0.5, 8),
}
RTOL = 1e-4
#: most chains one-ulp nudges may move in a case (module docstring)
MAX_NUDGED = 0.25
BETA = {"mjhmc": 0.1, "control": 0.2, "malt": 1.0, "nuts": 0.0}


def _pair(name, kw):
    return getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)


def _rows(a):
    """A JAX engine array as the port's (d, n) / (n,) / (E, d, n) layout."""
    a = np.asarray(a)
    return torch.as_tensor(a.reshape(a.shape[0], -1) if a.ndim == 3 else a.reshape(-1))


def _within(a, b, rtol):
    """(n,) bool: the chain's values of ``a`` lie within rtol of ``b`` (atol
    rtol of its largest finite value), non-finite where ``b`` is."""
    a, b = a.double(), b.double()
    fin = torch.isfinite(b)
    top = float(b[fin].abs().max()) if bool(fin.any()) else 1.0
    good = torch.where(fin, (a - b).abs() <= rtol * (top + b.abs()), ~torch.isfinite(a))
    while good.dim() > 1:
        good = good.all(dim=-2)
    return good


def _agree(run, xs, es, ref, xs_ref, es_ref, fields, rtol):
    """(n,) bool: counters equal and every field and emission within rtol."""
    ok = (run.evals == ref.evals) & (es == es_ref).all(dim=0)
    for f in fields:
        ok &= _within(getattr(run, f), getattr(ref, f), rtol)
    return ok & _within(xs, xs_ref, rtol)


def _compare(jd, td, variant, steps, m, eps, br, seed=1):
    jspec, tspec = energy_spec_for(jd), cm.energy_spec_for(td)
    js = _jax_state(jd, seed=seed)
    ts = _port_state(js)
    beta = BETA[variant]
    kw = dict(variant=variant, **br)
    out_j = pallas_mjhmc_run(jspec, *js, jnp.int32(7), jnp.float32(eps), jnp.float32(beta),
                             steps, m, interpret=IP, **kw)
    xs_j, ws_j, es_j, so_j = pallas_mjhmc_stream_run(jspec, *js, jnp.int32(7), jnp.float32(eps),
                                                     jnp.float32(beta), steps, 1, m,
                                                     interpret=IP, **kw)

    def plain(x=ts[0], e=eps):
        return cm.stream_reference(tspec, x, *ts[1:], 7, e, beta, steps, 1, m, True, **kw)

    xs_t, ws_t, es_t, out_t = plain()
    fields = ("x", "v", "grad", "u", "w", "wx", "wx2") + (("h_back",) if variant == "mjhmc" else ())
    nudged = torch.zeros(N, dtype=torch.bool)
    for to in (float("inf"), float("-inf")):
        xn = torch.nextafter(ts[0], torch.full_like(ts[0], to))
        en = float(np.nextafter(np.float32(eps), np.float32(to)))
        for xs_n, _, es_n, out_n in (plain(x=xn), plain(e=en)):
            nudged |= ~_agree(out_n, xs_n, es_n, out_t, xs_t, es_t, fields, 1e-5)
    what = f"{type(td).__name__}({td.ndims}) {variant} {sorted(br)}"
    assert out_t.evals.dtype == torch.int32
    assert float(nudged.double().mean()) <= MAX_NUDGED, f"{what}: {int(nudged.sum())} nudged"
    held = ~nudged
    for run, xs, es in ((_rows_out(out_j), _rows(xs_j), _rows(es_j).reshape(steps, N)),
                        (_rows_out(so_j), _rows(xs_j), _rows(es_j).reshape(steps, N))):
        ok = _agree(run, xs.reshape(xs_t.shape), es, out_t, xs_t, es_t, fields, RTOL)
        assert bool(ok[held].all()), (f"{what}: {int((~ok & held).sum())} of {int(held.sum())} "
                                      f"held chains differ ({int(nudged.sum())} nudged)")
    assert bool(_within(ws_t, _rows(ws_j).reshape(ws_t.shape), RTOL)[held].all()), what
    return out_t


def _rows_out(out):
    return cm.RunOut(*(_rows(a) for a in out))


@pytest.mark.parametrize("variant", ["mjhmc", "control", "malt"])
@pytest.mark.parametrize("energy", list(ZOO))
def test_zoo_body_matches_interpret_kernel(energy, variant):
    """Every (energy, body) pair at the preset's D, run and stream (NUTS:
    test_torch_zoo_nuts.py)."""
    name, kw, eps, m = ZOO[energy]
    out = _compare(*_pair(name, kw), variant, 5, m, eps, {})
    assert int(out.evals.min()) >= 5 * m
