"""The matmul kernel's dot precisions in the port (``cuda_mjhmc.PRECISIONS``)
against the JAX package: the plain contraction against ``_dot_bf16x3``,
``_dot_bf16x2``, a single bf16 pass and ``HIGHEST``; the specs' defaults
against JAX's; the plain engines at the bf16 precisions against the
interpret-mode Pallas kernels; the refusal of (body, precision) pairs the
kernel has no instance for; and the precision sweep on the CPU.

Interpret mode returns zero PRNG bits, so every uniform of the JAX kernel
is 2⁻²⁵; the port's ``fixed_uniform=True`` reproduces that. On the CPU
``Precision.DEFAULT`` computes full f32, so the ``"default"`` cases run the
JAX kernel with a spec of this file whose ``_dot`` rounds both operands to
bf16, as the TPU's one pass does (nothing in ``mjhmc_tpu`` changes).

A bf16 split is not continuous in its input: a one-ulp difference in x,
which two f32 summation orders leave behind, can move a bf16 rounding by
2⁻⁹ relative (one pass) or the split's residual by ~2⁻¹⁷ (three and two
passes), and the fit term of sparse coding multiplies that by σ⁻² = 100.
So counters, states and emissions are held per chain (exact; rtol 1e-4,
atol 1e-4 of the field's largest value) on the chains that one-ulp nudges
of x and of ε (up and down) do not change or move past that tolerance in
the plain version alone; the nudged chains are counted and bounded
(``MAX_NUDGED``). The one-pass cases run two iterations, where the nudges
move few chains. Measured nudged chains of the 256, at 1, 2 and 3
iterations: product of t MJHMC 1, 7, 17; control 2, 3, 5; MALT 1, 1, 3;
NUTS (max_depth 4) 3, 4, 9; logreg (64 observations) MJHMC 1, 1, 3;
control 1, 0, 1; NUTS 0, 0, 0; sparse coding at bf16x3 and bf16x2 none
through 5 iterations. A chain's dwell weight hangs on H differences of O(1)
between energies of O(10³) and moves by ~1e-3 under a nudge at any bf16
precision (~3e-3 on sparse coding, 2e-4 at highest), so the weights are
held as sums over all chains (Σw, Σw·x, Σw·x²) at rtol 1e-4, or, where that
is more, at twice the spread a nudge puts into Σw in the plain version
alone: the root sum of squares of its per-chain changes over Σw (4.1e-4
and 4.3e-4 at bf16x3 and bf16x2 on sparse coding at 5 iterations, at most
7.4e-5 in the two-iteration one-pass cases), never above ``MAX_SUMS_RTOL``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjhmc_tpu import models as jmodels
from mjhmc_tpu.models.logreg import LogisticRegression as JLogreg
from mjhmc_tpu.ops import pallas_mjhmc as pm
from mjhmc_tpu_torch import bench_mm_precision
from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

torch.set_num_threads(1)

IP = pltpu.InterpretParams()
N = 256
#: most chains one-ulp nudges may move in a case: 7 of 256 measured
#: (module docstring), held at 5%
MAX_NUDGED = 0.05
#: the sums' tolerance is never looser than this (module docstring)
MAX_SUMS_RTOL = 1e-3


def _jax_dot(precision, a, b):
    dims = ((1,), (0,))
    if precision == "bf16x3":
        return pm._dot_bf16x3(a, b, dims)
    if precision == "bf16x2":
        return pm._dot_bf16x2(a, b, dims)
    if precision == "default":  # the single bf16 pass
        return jax.lax.dot_general(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                                   (dims, ((), ())), preferred_element_type=jnp.float32)
    return jax.lax.dot_general(a, b, (dims, ((), ())), precision=jax.lax.Precision.HIGHEST,
                               preferred_element_type=jnp.float32)


@pytest.mark.parametrize("precision", cm.PRECISIONS)
def test_contract_matches_jax_dot(precision):
    """(64, 128)·(128, 256) from a seed: within 1e-5 of the largest entry of
    JAX's, and (but for highest) apart from the f32 product."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((64, 128)).astype(np.float32)
    b = rng.standard_normal((128, 256)).astype(np.float32)
    want = np.asarray(_jax_dot(precision, jnp.asarray(a), jnp.asarray(b)), np.float64)
    got = cm._contract(False, torch.as_tensor(a), torch.as_tensor(b), precision)
    assert got.dtype == torch.float32 and got.shape == (64, 256)
    top = np.abs(want).max()
    assert np.abs(got.double().numpy() - want).max() <= 1e-5 * top
    full = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    if precision != "highest":
        assert np.abs(got.double().numpy() - full).max() > 1e-6 * top
    # stacked trajectories (..., k, n) contract row for row
    two = cm._contract(False, torch.as_tensor(a), torch.stack([torch.as_tensor(b)] * 2),
                       precision)
    assert torch.equal(two[0], got) and torch.equal(two[1], got)
    with pytest.raises(ValueError, match="precision"):
        cm._contract(False, torch.as_tensor(a), torch.as_tensor(b), "bf16x4")


@pytest.mark.parametrize("jd,td", [(jmodels.ProductOfT(), tmodels.ProductOfT()),
                                   (jmodels.SparseCoding(), tmodels.SparseCoding()),
                                   (JLogreg(), tmodels.LogisticRegression())])
def test_spec_precision_is_the_jax_default(jd, td):
    want = pm.energy_spec_for(jd).precision
    assert cm.energy_spec_for(td).precision == want
    assert set(cm.MM_KERNEL_PRECISIONS[type(cm.energy_spec_for(td))]) >= {"highest", want}


class _OnePass:
    """``_dot`` as the TPU's single bf16 pass: both operands rounded to
    bf16, f32 accumulation."""

    def _dot(self, a, b, dims):
        if getattr(self, "stub_dots", False):
            return super()._dot(a, b, dims)
        return jax.lax.dot_general(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                                   (dims, ((), ())), preferred_element_type=jnp.float32)


@dataclasses.dataclass(frozen=True)
class _ProductOfTOnePass(_OnePass, pm.ProductOfTSpec):
    pass


@dataclasses.dataclass(frozen=True)
class _LogregOnePass(_OnePass, pm.LogregSpec):
    pass


def _jax_spec(jd, precision):
    spec = pm.energy_spec_for(jd)
    if precision != "default":
        return dataclasses.replace(spec, precision=precision)
    one = {pm.ProductOfTSpec: _ProductOfTOnePass, pm.LogregSpec: _LogregOnePass}[type(spec)]
    return one(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)})


def _state(jd, scale, seed):
    """(JAX, port) states: x from the init's scale, v ~ N(0, I)."""
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((jd.ndims, N))).astype(np.float32)
    v = rng.standard_normal((jd.ndims, N)).astype(np.float32)
    u, g = (np.array(a) for a in jd.potential_and_grad(jnp.asarray(x)))
    z = np.zeros(N, np.float32)
    js = (jnp.asarray(x), jnp.asarray(v), jnp.asarray(g), jnp.asarray(u)[None],
          jnp.zeros((1, N)), jnp.zeros((1, N)))
    return js, tuple(torch.as_tensor(a) for a in (x, v, g, u, z, z.copy()))


def _as(a, like):
    """A JAX engine array in the port's layout of ``like``."""
    return torch.as_tensor(np.array(a).reshape(like.shape))


def _within(a, b, rtol):
    """(n,) bool: the chain's values of ``a`` within rtol of ``b`` (atol
    rtol of b's largest value)."""
    a, b = a.double(), b.double()
    good = (a - b).abs() <= rtol * (float(b.abs().max()) + b.abs())
    while good.dim() > 1:
        good = good.all(dim=-2)
    return good


FIELDS = ("x", "v", "grad", "u")


def _agree(run, ref, rtol, es=None, es_ref=None):
    ok = run.evals == ref.evals
    if es is not None:
        ok &= (es == es_ref).all(dim=0)
    for f in FIELDS:
        ok &= _within(getattr(run, f), getattr(ref, f), rtol)
    return ok


def _compare(jd, td, precision, variant, steps, m, eps, beta, scale, seed=1):
    """The plain engine (run and stream) against the interpret-mode kernel
    at ``precision``. Per chain: counters and stream es exact, states and
    emissions within rtol 1e-4, on all but as many chains as one-ulp nudges
    (of x or of ε, up and down) change or move past that in the plain
    version alone (at least 0.1%, the card's rule). Sums over all chains as
    the module docstring says. Returns (port run, chains that differ,
    chains the nudges move)."""
    jspec = _jax_spec(jd, precision)
    tspec = dataclasses.replace(cm.energy_spec_for(td), precision=precision)
    js, ts = _state(jd, scale, seed)
    kw = dict(variant=variant)
    scal = (jnp.int32(7), jnp.float32(eps), jnp.float32(beta))
    out_j = pm.pallas_mjhmc_mm_run(jspec, *js, *scal, steps, m, interpret=IP, **kw)
    xs_j, _, es_j, _ = pm.pallas_mjhmc_mm_stream_run(jspec, *js, *scal, steps, 1, m,
                                                     interpret=IP, **kw)

    def plain(x=ts[0], e=eps):
        return cm.stream_reference(tspec, x, *ts[1:], 7, e, beta, steps, 1, m, True, **kw)

    xs_t, _, es_t, out_t = plain()
    nudged = torch.zeros(N, dtype=torch.bool)
    spread = 0.0
    for to in (float("inf"), float("-inf")):
        x_n = torch.nextafter(ts[0], torch.full_like(ts[0], to))
        e_n = float(np.nextafter(np.float32(eps), np.float32(to)))
        for xs_n, _, es_n, out_n in (plain(x=x_n), plain(e=e_n)):
            nudged |= ~(_agree(out_n, out_t, 1e-4, es_n, es_t) & _within(xs_n, xs_t, 1e-4))
            dw = (out_n.w.double() - out_t.w.double()).square().sum().sqrt()
            spread = max(spread, float(dw / out_t.w.double().sum()))
    what = f"{type(td).__name__} {variant} at {precision}"
    assert float(nudged.double().mean()) <= MAX_NUDGED, f"{what}: {int(nudged.sum())} nudged"
    run_j = cm.RunOut(*(_as(a, b) for a, b in zip(out_j, out_t)))
    ok = _agree(run_j, out_t, 1e-4, _as(es_j, es_t), es_t) & _within(_as(xs_j, xs_t), xs_t, 1e-4)
    differ = int((~ok).sum())
    assert differ <= max(0.001 * N, int(nudged.sum())), (
        f"{what}: {differ} chains differ, {int(nudged.sum())} nudged")
    assert 2 * spread <= MAX_SUMS_RTOL, f"{what}: nudges spread Σw by {spread:.3g}"
    sums_rtol = max(1e-4, 2 * spread)
    np.testing.assert_allclose(out_t.w.double().sum().item(),
                               np.asarray(out_j.w, np.float64).sum(), rtol=sums_rtol,
                               err_msg=f"{what} Σw")
    for f in ("wx", "wx2"):
        b = np.asarray(getattr(out_j, f), np.float64).sum(1)
        np.testing.assert_allclose(getattr(out_t, f).double().sum(1).numpy(), b, rtol=sums_rtol,
                                   atol=sums_rtol * np.abs(b).max(), err_msg=f"{what} Σ{f}")
    return out_t, differ, int(nudged.sum())


@pytest.mark.parametrize("precision", ["bf16x3", "bf16x2"])
def test_sparse_coding_matches_interpret_kernel_at(precision):
    """Sparse coding, 5 iterations at the preset's ε and M."""
    out, differ, nudged = _compare(jmodels.SparseCoding(), tmodels.SparseCoding(), precision,
                                   "mjhmc", 5, 10, 0.02, 0.1, 0.1)
    assert int(out.evals.min()) >= 60
    assert differ == nudged == 0


@pytest.mark.parametrize("name,jd,td,variant,m,eps,beta,scale", [
    ("product_of_t", jmodels.ProductOfT(), tmodels.ProductOfT(), "mjhmc", 5, 0.2, 0.1, 2.0),
    ("product_of_t malt", jmodels.ProductOfT(), tmodels.ProductOfT(), "malt", 5, 0.2, 1.0, 2.0),
    ("logreg", JLogreg(nobs=64), tmodels.LogisticRegression(nobs=64), "mjhmc", 6, 0.15, 0.1,
     1.0),
    ("logreg control", JLogreg(nobs=64), tmodels.LogisticRegression(nobs=64), "control", 6,
     0.15, 0.2, 1.0),
    ("product_of_t nuts", jmodels.ProductOfT(), tmodels.ProductOfT(), "nuts", 4, 0.12, 0.0,
     2.0),
    ("logreg nuts", JLogreg(nobs=64), tmodels.LogisticRegression(nobs=64), "nuts", 4, 0.15,
     0.0, 1.0),
], ids=lambda v: v if isinstance(v, str) else None)
def test_default_matches_one_pass_interpret_kernel(name, jd, td, variant, m, eps, beta, scale):
    """One bf16 pass (both operands rounded), two iterations: product of t
    at its preset's ε and M, logreg (64 observations), and NUTS (``m`` is
    max_depth)."""
    out, _, _ = _compare(jd, td, "default", variant, 2, m, eps, beta, scale)
    assert int(out.evals.min()) >= 2


@pytest.mark.parametrize("td", [tmodels.ProductOfT(), tmodels.SparseCoding(),
                                tmodels.LogisticRegression()], ids=lambda d: type(d).__name__)
def test_eps_zero_gradient_tells_the_precisions_apart(td):
    """One iteration at ε = 0, M 1 (chip_smoke.py phase 30's check of the
    contraction alone): x stays and the gradient that comes out is the
    spec's at x (at a bf16 precision it differs from the full-f32 input
    gradient on every chain: recomputed). One pass and a once-rounded
    parameter move every chain's gradient past rtol 1e-4 of full f32's;
    bf16x3 stays within it (both are f32-class)."""
    gen = torch.Generator().manual_seed(3)
    x = td.init_x(gen, N, "cpu")
    u, g = td.potential_and_grad(x)
    z = torch.zeros(N)
    st = (x, torch.randn(x.shape, generator=gen), g, u, z, z.clone())
    grads = {}
    for p in cm.PRECISIONS:
        spec = dataclasses.replace(cm.energy_spec_for(td), precision=p)
        out = cm.run_reference(spec, *st, 7, 0.0, 0.1, 1, 1, True)
        assert torch.equal(out.x, x)
        assert bool((out.grad != g).any(dim=0).all()) or p == "highest"
        grads[p] = out.grad
    full = grads["highest"]
    for p, moved in (("bf16x3", 0), ("bf16x2", N), ("default", N)):
        assert int((~_within(grads[p], full, 1e-4)).sum()) == moved, p


def test_uninstantiated_pairs_are_refused():
    """A (body, precision) pair outside ``MM_KERNEL_PRECISIONS`` (the
    library's) passes every check before the launch (an on-demand instance
    runs it on the card) and stops at the device check on meta tensors; an
    unknown precision is refused; the plain version takes every
    precision."""
    td = tmodels.SparseCoding()
    spec = dataclasses.replace(cm.energy_spec_for(td), precision="bf16x2")
    gen = torch.Generator().manual_seed(0)
    x = td.init_x(gen, 8, "cpu")
    u, g = td.potential_and_grad(x)
    z = torch.zeros(8)
    ts = (x, torch.randn(x.shape, generator=gen), g, u, z, z.clone())
    meta = tuple(t.to("meta") for t in ts)
    for kw, stream in ((dict(variant="control"), False), (dict(variant="nuts"), False),
                       ({}, True), (dict(inv_mass=(1.0,) * 128), False),
                       (dict(integrator="two_stage"), False)):
        assert not cm.mm_compiled_ahead(spec, sweep_run=False)
        with pytest.raises(ValueError, match="cuda tensors"):
            if stream:
                cm.cuda_mjhmc_mm_stream_run(spec, *meta, 5, 0.02, 0.1, 2, 1, 3, **kw)
            else:
                cm.cuda_mjhmc_mm_run(spec, *meta, 5, 0.02, 0.1, 2, 3, **kw)
    # the sweep's run is in the library: the same device check
    assert cm.mm_compiled_ahead(spec, sweep_run=True)
    with pytest.raises(ValueError, match="cuda tensors"):
        cm.cuda_mjhmc_mm_run(spec, *meta, 5, 0.02, 0.1, 2, 3)
    lr = tmodels.LogisticRegression()
    lspec = dataclasses.replace(cm.energy_spec_for(lr), precision="bf16x3")
    lx = lr.init_x(gen, 8, "cpu")
    lmeta = tuple(t.to("meta") for t in (lx, lx, lx, z, z, z))
    assert not cm.mm_compiled_ahead(lspec, sweep_run=True)
    with pytest.raises(ValueError, match="cuda tensors"):
        cm.cuda_mjhmc_mm_run(lspec, *lmeta, 5, 0.15, 0.1, 2, 3)
    with pytest.raises(ValueError, match="unknown dot precision"):
        cm.cuda_mjhmc_mm_run(dataclasses.replace(spec, precision="fp8"), *meta, 5, 0.02, 0.1,
                             2, 3)
    before = {k: getattr(cm.cuda_mjhmc_mm_run, k) for k in cm.COUNTS}
    a = cm.cuda_mjhmc_mm_run(spec, *ts, 5, 0.02, 0.1, 2, 3, variant="control")
    b = cm.run_reference(spec, *ts, 5, 0.02, 0.1, 2, 3, variant="control")
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert {k: getattr(cm.cuda_mjhmc_mm_run, k) for k in cm.COUNTS} == before
    assert {f"{p}_launches" for p in cm.PRECISIONS} <= set(cm.COUNTS)


def test_sweep_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``--device cpu`` at 32 chains and 2 steps: one JSON line with the
    eight ``"<config>/<precision>"`` entries; no file without --json-out."""
    monkeypatch.chdir(tmp_path)
    assert bench_mm_precision.main(["--device", "cpu", "--nbatch", "32", "--steps", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    keys = [f"{c}/{p}" for c in ("sparse_coding", "product_of_t") for p in cm.PRECISIONS]
    assert sorted(rec) == sorted(keys + ["device"])
    assert rec["device"] == {"name": "cpu", "nbatch": 32, "steps": 2}
    for k in keys:
        assert rec[k]["steps_per_sec"] > 0 and len(rec[k]["var_head"]) == 4
        assert all(np.isfinite(rec[k]["var_head"]))
        assert rec[k]["launches"] == 0  # the plain version ran
    assert list(tmp_path.iterdir()) == []
    # the same seed at two precisions: the sweep really switched the spec
    assert rec["sparse_coding/highest"]["var_head"] != rec["sparse_coding/default"]["var_head"]

