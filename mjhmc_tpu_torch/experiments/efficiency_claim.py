"""The paper's headline claim, measured in continuous state (counterpart
of ``mjhmc_tpu.experiments.efficiency_claim``).

The reference's acceptance-level behaviour: MJHMC reaches equal
autocorrelation in ~1.5-2x fewer gradient evaluations than control HMC
(arXiv:1509.03808). This module measures it the way the paper does, on
continuous-state targets, each sampler at its OWN tuned operating point.

Protocol per (target, sampler):
  1. tune (ε, β, M) with a dense deterministic log-grid sweep
     (``search.grid``; the plain samplers on ``device``);
  2. confirm a regime-diverse set of uncensored grid points (the best of
     each β decade, up to 4) with longer, fresh-seeded runs
     (``calculate_autocorrelation`` at ``seed + 7``) and keep the best
     confirmed point, the same protocol for every sampler;
  3. report decay-evals with the censoring flag (a censored decay is a
     lower bound, never an estimate).

Run:  python -m mjhmc_tpu_torch.experiments.efficiency_claim [--quick]
      [--out figures/efficiency_claim] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

from mjhmc_tpu_torch.experiments.autocorr_experiment import ACResult, calculate_autocorrelation
from mjhmc_tpu_torch.models.product_of_t import ProductOfT
from mjhmc_tpu_torch.models.rough_well import RoughWell
from mjhmc_tpu_torch.samplers.state import checked_device
from mjhmc_tpu_torch.search.grid import grid_search


@dataclasses.dataclass
class ClaimRow:
    target: str
    sampler: str
    epsilon: float
    beta: float
    num_leapfrog_steps: int
    decay_evals: float
    censored: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def tuned_decay(
    dist,
    sampler: str,
    target_name: str,
    *,
    num_steps: int = 2500,
    nbatch: int = 256,
    nlags: int = 500,
    search_steps: int = 1200,
    search_nlags: int = 300,
    eps_range: tuple[float, float] = (0.05, 20.0),
    # β from 2e-4 (a decade below where earlier batteries pinned MJHMC) to
    # 1.0 (full refresh, near control's optimum in the barrier regime)
    beta_range: tuple[float, float] = (2e-4, 1.0),
    # M 1, 2: MJHMC builds long trajectories by L-persistence; up to 50 so
    # no optimum is pinned at the ladder's top
    m_grid: Sequence[int] = (1, 2, 5, 10, 20, 35, 50),
    n_eps: int = 8,
    n_beta: int = 9,
    seed: int = 0,
    device="cuda",
) -> tuple[ClaimRow, ACResult]:
    """Tune (ε, β, M) for ``sampler`` on ``dist``, then confirm the decay
    at the tuned point with a longer fresh-seeded run, on ``device``."""
    res = grid_search(
        dist,
        sampler=sampler,
        eps_grid=tuple(np.geomspace(eps_range[0], eps_range[1], n_eps)),
        beta_grid=tuple(np.geomspace(beta_range[0], beta_range[1], n_beta)),
        m_grid=tuple(m_grid),
        num_steps=search_steps,
        nbatch=nbatch,
        nlags=search_nlags,
        seed=seed,
        device=device,
    )
    # the short search window can mis-rank whole β regimes, so the
    # confirmation set is regime-diverse: the best point of each β decade,
    # ranked by search decay, up to 4; the fresh-seeded full-scale
    # confirmation arbitrates between regimes
    pool = [r for r in res.table
            if np.isfinite(r["decay_evals"]) and not r.get("censored", False)] or res.table
    pool = sorted(pool, key=lambda r: r["decay_evals"])
    by_decade = {}
    for r in pool:
        dec = int(np.floor(np.log10(max(r["beta"], 1e-12))))
        by_decade.setdefault(dec, r)  # pool is sorted: first = decade best
    cands = sorted(by_decade.values(), key=lambda r: r["decay_evals"])[:4]

    best_ac, best_row = None, None
    for r in cands:
        # the eval window is lag × (~M evals/step): widen lags (and the
        # run) for small M so the confirmation can resolve the crossing
        m_c = int(r["num_leapfrog_steps"])
        nlags_c = int(nlags * max(1.0, 10.0 / m_c))
        steps_c = max(num_steps, 2 * nlags_c)
        ac = calculate_autocorrelation(
            dist,
            sampler=sampler,
            num_steps=steps_c,
            nbatch=nbatch,
            nlags=nlags_c,
            seed=seed + 7,  # fresh stream: confirmation is not the search
            device=device,
            epsilon=r["epsilon"],
            beta=r["beta"],
            num_leapfrog_steps=m_c,
        )
        better = best_ac is None or (
            (not ac.censored, -ac.decay_evals) > (not best_ac.censored, -best_ac.decay_evals))
        if better:
            best_ac, best_row = ac, r

    row = ClaimRow(
        target=target_name,
        sampler=sampler,
        epsilon=float(best_row["epsilon"]),
        beta=float(best_row["beta"]),
        num_leapfrog_steps=int(best_row["num_leapfrog_steps"]),
        decay_evals=float(best_ac.decay_evals),
        censored=bool(best_ac.censored),
    )
    return row, best_ac


def _make_sparse_coding():
    from mjhmc_tpu_torch.models.sparse_coding import SparseCoding

    return SparseCoding()  # 128-D posterior on the pretrained Φ


def _make_gauss50d():
    from mjhmc_tpu_torch.models.gaussian import Gaussian

    return Gaussian(ndims=50, log_conditioning=4.0)  # BASELINE config 4


# ε grid for the rough-well rows: up to 60, so MJHMC's optima (seen at
# 8.5-20) are interior
_RW_EPS = dict(eps_range=(0.05, 60.0), n_eps=9)

#: the battery: the paper's four distributions (Gaussian 50-D
#: ill-conditioned, rough well and its amplitude ladder, product of t,
#: 128-D sparse coding), windows sized so confirmed decays are uncensored
DEFAULT_TARGETS = (
    ("gauss50d", _make_gauss50d, dict(eps_range=(0.02, 2.0), nbatch=128)),
    ("rough_well[a=1]", lambda: RoughWell(2, 100.0, 4.0, amplitude=1.0), dict(**_RW_EPS)),
    ("rough_well[a=2]", lambda: RoughWell(2, 100.0, 4.0, amplitude=2.0), dict(**_RW_EPS)),
    ("rough_well[a=3]", lambda: RoughWell(2, 100.0, 4.0, amplitude=3.0),
     dict(num_steps=5000, nlags=2000, search_steps=2500, search_nlags=1000, **_RW_EPS)),
    ("rough_well[a=4]", lambda: RoughWell(2, 100.0, 4.0, amplitude=4.0),
     dict(num_steps=9000, nlags=4000, search_steps=4000, search_nlags=2000, **_RW_EPS)),
    ("product_of_t", lambda: ProductOfT(ndims=36, nbasis=36),
     dict(eps_range=(0.01, 3.0), nbatch=128)),
    ("sparse_coding", _make_sparse_coding,
     dict(eps_range=(0.002, 0.5), nbatch=128, num_steps=1500, nlags=300, search_steps=800,
          search_nlags=200, m_grid=(2, 5, 10, 20, 35, 50, 70, 100))),
)

#: ``--quick``: one target, a 3 × 2 grid at M 5
QUICK_TARGETS = (
    ("rough_well[a=2]", lambda: RoughWell(2, 100.0, 4.0, amplitude=2.0),
     dict(num_steps=400, nlags=120, search_steps=200, search_nlags=80, n_eps=3, n_beta=2,
          m_grid=(5,), nbatch=64)),
)


def run_claim(
    targets=DEFAULT_TARGETS,
    samplers: Sequence[str] = ("mjhmc", "control"),
    seed: int = 0,
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Run the battery on ``device``; returns rows + per-target eval-ratio
    summary. ``ratio`` is control-decay / mjhmc-decay: >1 means MJHMC needs
    fewer gradient evaluations to reach the same autocorrelation."""
    rows: list[ClaimRow] = []
    curves: dict[str, dict[str, ACResult]] = {}
    for name, make, kw in targets:
        curves[name] = {}
        for sampler in samplers:
            row, ac = tuned_decay(make(), sampler, name, seed=seed, device=device, **kw)
            rows.append(row)
            curves[name][sampler] = ac
            if verbose:
                print(json.dumps(row.to_dict()), flush=True)
    ratios = {}
    for name, _, _ in targets:
        by = {r.sampler: r for r in rows if r.target == name}
        if "mjhmc" in by and "control" in by:
            ratios[name] = {
                "ratio_control_over_mjhmc": by["control"].decay_evals / by["mjhmc"].decay_evals,
                "censored": by["mjhmc"].censored or by["control"].censored,
            }
    return {"rows": [r.to_dict() for r in rows], "ratios": ratios, "curves": curves}


def render_figure(result: dict, path_png: str) -> None:
    """Per-target ρ-vs-grad-evals overlay at each sampler's tuned point;
    raises, naming matplotlib, where it is not installed."""
    from mjhmc_tpu_torch.experiments.figures import pyplot

    plt = pyplot()
    curves = result["curves"]
    n = len(curves)
    fig, axes = plt.subplots(1, n, figsize=(4.2 * n, 3.4), squeeze=False)
    for ax, (name, by_sampler) in zip(axes[0], curves.items()):
        for sampler, ac in by_sampler.items():
            label = f"{sampler} (decay={ac.decay_evals:.0f}"
            label += ", censored)" if ac.censored else ")"
            ax.plot(ac.grad_evals, ac.rho, label=label)
        ax.axhline(np.e**-1, color="gray", lw=0.8, ls="--")
        ratio = result["ratios"].get(name, {}).get("ratio_control_over_mjhmc")
        ax.set_title(name if ratio is None else f"{name}  ratio={ratio:.2f}x", fontsize=10)
        ax.set_xlabel("cumulative gradient evaluations")
        ax.set_ylim(-0.1, 1.02)
        ax.legend(fontsize=7)
    axes[0][0].set_ylabel("autocorrelation")
    fig.tight_layout()
    fig.savefig(path_png, dpi=150)
    plt.close(fig)


def save_figure(result: dict, path_png: str, path_npz: str | None = None) -> None:
    """Write the ``.npz`` (when ``path_npz``: each target's and sampler's ρ
    curve against its grad-evals axis), then render the ``.png``."""
    if path_npz:
        np.savez(path_npz, **{f"{name}/{sampler}/{k}": getattr(ac, f)
                              for name, by_sampler in result["curves"].items()
                              for sampler, ac in by_sampler.items()
                              for k, f in (("evals", "grad_evals"), ("rho", "rho"))})
    render_figure(result, path_png)


def main(argv=None):
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="figures/efficiency_claim")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="small smoke battery (tests)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    device = checked_device(a.device, "efficiency")
    result = run_claim(QUICK_TARGETS if a.quick else DEFAULT_TARGETS, seed=a.seed, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(a.out + ".png")), exist_ok=True)
    with open(a.out + ".json", "w") as f:
        json.dump({k: result[k] for k in ("rows", "ratios")}, f, indent=1)
    save_figure(result, a.out + ".png", a.out + ".npz")
    print(json.dumps({"ratios": result["ratios"], "out": a.out}))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
