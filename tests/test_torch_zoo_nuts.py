"""The zoo energies in the NUTS body of the elementwise engine's plain
version and with the branches (a diagonal inverse mass, the two-stage
integrator), against the TPU kernels in Pallas interpret mode, as
test_torch_zoo_engine.py holds the other bodies (its docstring gives the
tolerances); the plain version at D the kernel has no instance for; the
wrappers' refusals; and ``sample`` on the zoo presets.
"""

import json

import numpy as np
import pytest
import torch

from mjhmc_tpu_torch import models as tmodels
from mjhmc_tpu_torch.__main__ import main as cli
from mjhmc_tpu_torch.ops import cuda_mjhmc as cm

from test_torch_zoo_engine import NUTS_DEPTH, ZOO, _compare, _pair

torch.set_num_threads(1)


@pytest.mark.parametrize("energy", list(ZOO))
def test_zoo_nuts_matches_interpret_kernel(energy):
    """The NUTS body on every zoo energy, 3 iterations at max_depth 5."""
    name, kw, eps, _ = ZOO[energy]
    out = _compare(*_pair(name, kw), "nuts", 3, NUTS_DEPTH, eps, {})
    assert int(out.evals.max()) > 3  # trees grew
    assert bool((out.w == 3).all())


@pytest.mark.parametrize("energy,variant,integrator,mass", [
    ("funnel", "mjhmc", "leapfrog", True),
    ("eight_schools_nc", "mjhmc", "two_stage", False),
    ("banana", "control", "two_stage", True),
    ("mog", "malt", "leapfrog", True),
    ("eight_schools", "nuts", "leapfrog", True),
])
def test_zoo_branches_match_interpret_kernel(energy, variant, integrator, mass):
    """A diagonal inverse mass (M⁻¹ from 0.5 to 1.5 over the dims) and the
    two-stage integrator on the zoo energies."""
    name, kw, eps, m = ZOO[energy]
    jd, td = _pair(name, kw)
    br = dict(integrator=integrator)
    if mass:
        br["inv_mass"] = np.linspace(0.5, 1.5, jd.ndims).astype(np.float32)
    nuts = variant == "nuts"
    _compare(jd, td, variant, 3 if nuts else 5, NUTS_DEPTH if nuts else m, eps, br, seed=2)


@pytest.mark.parametrize("name,kw,eps", [
    ("Funnel", dict(ndims=8), 0.1),
    ("Banana", dict(ndims=4), 0.25),
    ("GaussianMixture", dict(ndims=2, means=((-3.0, 1.0), (2.0, 0.0)), scales=(1.0, 0.5),
                             weights=(0.3, 0.7)), 0.3),
])
def test_zoo_plain_version_takes_any_dims(name, kw, eps):
    """The plain version at D the library has no instance for (the JAX
    test's shapes), MJHMC against the interpret-mode kernel; the kernel's
    wrapper takes them (an instance compiled on demand runs them on the
    card) and runs none of them before the card."""
    jd, td = _pair(name, kw)
    _compare(jd, td, "mjhmc", 5, 6, eps, {}, seed=4)
    spec = cm.energy_spec_for(td)
    cm.check_kernel_dims(spec, td.ndims)
    assert not cm.compiled_ahead(spec, td.ndims)


def test_zoo_refusals_before_any_launch():
    """A zoo spec at a D the library has no instance for, or a mixture with
    more components than it holds, passes the wrapper's checks (an instance
    is compiled for it on demand) and stops at the device check before any
    build or launch (CPU and meta tensors alike); at the presets' D the
    checks pass and the library has the instance."""
    for td in (tmodels.Funnel(), tmodels.Banana(), tmodels.GaussianMixture(), tmodels.EightSchools(),
               tmodels.EightSchools(parameterization="noncentered")):
        cm.check_kernel_dims(cm.energy_spec_for(td), td.ndims)
        assert cm.compiled_ahead(cm.energy_spec_for(td), td.ndims)
    many = tmodels.GaussianMixture(means=tuple((float(k),) for k in range(9)),
                                   scales=(1.0,) * 9, weights=(1.0,) * 9)
    cm.check_kernel_dims(cm.energy_spec_for(many), 1)
    assert cm.mog_cap(cm.energy_spec_for(many)) == 9
    for td in (tmodels.Funnel(ndims=8), many):
        spec = cm.energy_spec_for(td)
        assert not cm.compiled_ahead(spec, td.ndims)
        x = td.init_x(torch.Generator().manual_seed(0), 64)
        u, g = td.potential_and_grad(x)
        z = torch.zeros(64)
        for dev in ("cpu", "meta"):
            st = tuple(t.to(dev) for t in (x, torch.zeros_like(x), g, u, z, z))
            with pytest.raises(ValueError, match="cuda tensors"):
                cm._launch(spec, *st, 1, 0.1, 0.1, 1, 5, 1, None, False, "mjhmc", None,
                           "leapfrog")
        # the CPU wrapper takes the plain version at any D and any K
        out = cm.cuda_mjhmc_run(spec, x, torch.zeros_like(x), g, u, z, z, 1, 0.1, 0.1, 2, 3)
        assert bool(torch.isfinite(out.u).all())


@pytest.mark.parametrize("config", ["funnel", "banana", "mog", "eight_schools"])
def test_cli_sample_zoo_presets(config, capsys):
    """`sample --config <zoo preset> --device cpu`: the fused engine's plain
    version (MJHMC, and NUTS on eight schools) and the plain sampler print
    the JAX record, grad_evals the engine's exact counters."""
    keys = {"config", "sampler", "engine", "steps", "chains", "grad_evals", "mean", "var", "ess",
            "ess_per_grad_eval"}
    d = tmodels.get_distribution(config).ndims
    runs = [("cuda", "mjhmc"), ("torch", "mjhmc")]
    if config == "eight_schools":
        runs.append(("cuda", "nuts"))
    if config == "banana":
        runs += [("cuda", "control"), ("cuda", "malt")]
    for engine, sampler in runs:
        cli(["sample", "--config", config, "--engine", engine, "--sampler", sampler,
             "--device", "cpu", "--nbatch", "32", "--burn", "5", "--steps", "10"])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(rec) == keys
        assert (rec["config"], rec["engine"], rec["sampler"]) == (config, engine, sampler)
        assert rec["chains"] == 32 and rec["steps"] == 10 and len(rec["var"]) == min(d, 8)
        assert rec["grad_evals"] >= (10 if engine == "torch" else 15) * 32
        assert all(np.isfinite(rec["mean"])) and rec["ess"] > 0
