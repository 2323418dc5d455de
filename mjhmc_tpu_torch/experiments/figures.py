"""Paper-figure reproduction (counterpart of
``mjhmc_tpu.experiments.figures``): autocorrelation overlays,
spectral-gap curves, 2-D trajectory fans and tempering's mode recovery.

Each figure is two functions: one computes the arrays saved to its
``.npz`` (on ``device``), one renders its ``.png`` from those arrays. Only
the renderers import matplotlib (lazily, on the Agg backend). ``main``
writes every ``.npz`` first, then renders; without matplotlib it raises,
naming it, after the ``.npz`` files are written.

Run:  python -m mjhmc_tpu_torch.experiments.figures [--out figures_out] [--quick]
      [--only autocorr|fan|spectral|tempering] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from mjhmc_tpu_torch.diagnostics.spectral import spectral_gap_continuous, spectral_gap_discrete
from mjhmc_tpu_torch.experiments.autocorr_experiment import _decay_time, calculate_autocorrelation
from mjhmc_tpu_torch.models import Gaussian, GaussianMixture, ProductOfT, RoughWell, SparseCoding
from mjhmc_tpu_torch.samplers import ControlHMC, MarkovJumpHMC, ParallelTempering
from mjhmc_tpu_torch.samplers.algebraic import (
    continuous_rate_matrix,
    discrete_transition_matrix,
    random_ladder_energies,
    reduced_flip_transition_matrix,
)
from mjhmc_tpu_torch.samplers.state import checked_device

OVERLAY_SAMPLERS = ("mjhmc", "control", "malt")


def pyplot():
    """matplotlib's pyplot on the Agg backend; its absence raises, naming it."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("rendering the figures' .png files needs matplotlib, which is not "
                           "installed (the .npz files are written)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _label(evals: np.ndarray, rho: np.ndarray, tag: str) -> str:
    """'tag=decay' with ', censored' when ρ never reached 1/e in the window."""
    decay = _decay_time(evals, rho)
    censored = decay >= evals[-1] * 0.999
    return f"{tag}={decay:.0f}" + (", censored)" if censored else ")")


# ---------------------------------------------------------------------------
# autocorrelation overlay
# ---------------------------------------------------------------------------


def fig_autocorr_overlay(quick: bool = False, device="cuda") -> dict:
    """ρ vs cumulative grad evals per distribution, the paper's main figure,
    on all four reference distributions, each sampler at its own
    search-tuned operating point (``bayes_search``; ``quick`` keeps
    hand-set points). Returns the ``.npz`` arrays."""
    steps = 400 if quick else 3000
    nbatch = 64 if quick else 512
    # (dist, hand-set quick kwargs, search kwargs, per-dist overrides)
    dists = {
        "gaussian_2d": (Gaussian(ndims=2, log_conditioning=2.0),
                        dict(epsilon=1.0, num_leapfrog_steps=5), dict(eps_range=(0.05, 10.0)), {}),
        "rough_well": (RoughWell(ndims=2), dict(epsilon=4.0, num_leapfrog_steps=10),
                       dict(eps_range=(0.1, 20.0)), {}),
        "product_of_t": (ProductOfT(ndims=36, nbasis=36),
                         dict(epsilon=0.12, num_leapfrog_steps=5), dict(eps_range=(0.01, 3.0)),
                         dict(nbatch=min(nbatch, 256))),
        "sparse_coding": (SparseCoding(),  # 128-D posterior on the pretrained Φ
                          dict(epsilon=0.02, num_leapfrog_steps=5),
                          dict(eps_range=(0.002, 0.3)),
                          dict(num_steps=min(steps, 1200), nbatch=min(nbatch, 256))),
    }
    hand = {"mjhmc": dict(beta=0.1), "control": dict(beta=0.2), "malt": dict(gamma=1.0)}
    artifacts = {}
    for name, (dist, quick_kw, search_kw, over) in dists.items():
        n_steps = over.get("num_steps", steps)
        n_batch = over.get("nbatch", nbatch)
        for sampler in OVERLAY_SAMPLERS:
            if quick:
                kw = dict(quick_kw, **hand[sampler])
            else:
                from mjhmc_tpu_torch.search.bayes import bayes_search

                b = bayes_search(dist, sampler=sampler, num_init=8, num_iters=12,
                                 num_steps=600, nbatch=128, nlags=150, m_grid=(2, 5, 10, 20),
                                 device=device, **search_kw).best
                kw = dict(epsilon=b["epsilon"], num_leapfrog_steps=b["num_leapfrog_steps"])
                # bayes_search's 2nd coordinate is γ for MALT, β otherwise
                kw["gamma" if sampler == "malt" else "beta"] = b["beta"]
            res = calculate_autocorrelation(dist, sampler, num_steps=n_steps, nbatch=n_batch,
                                            nlags=min(200, n_steps // 4),
                                            use_cached_init=not quick, device=device, **kw)
            artifacts[f"{name}_{sampler}_evals"] = res.grad_evals
            artifacts[f"{name}_{sampler}_rho"] = res.rho
            artifacts[f"{name}_{sampler}_params"] = np.array(
                [kw["epsilon"], kw.get("beta", kw.get("gamma", np.nan)),
                 kw["num_leapfrog_steps"]])
    return artifacts


def render_autocorr_overlay(plt, a: dict, path: str) -> None:
    names = list(dict.fromkeys(k.rsplit("_", 2)[0] for k in a))
    fig, axes = plt.subplots(1, len(names), figsize=(4.6 * len(names), 4))
    for ax, name in zip(np.atleast_1d(axes), names):
        for sampler in OVERLAY_SAMPLERS:
            ev, rho = a[f"{name}_{sampler}_evals"], a[f"{name}_{sampler}_rho"]
            ax.plot(ev, rho, label=_label(ev, rho, f"{sampler} (τ"))
        ax.set_title(name)
        ax.set_xlabel("cumulative gradient evaluations")
        ax.set_ylabel("autocorrelation")
        ax.axhline(0, color="k", lw=0.5)
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


# ---------------------------------------------------------------------------
# spectral gap
# ---------------------------------------------------------------------------


def ladder_energies(seed: int, k: int) -> np.ndarray:
    """Draw ``seed`` of the ladder's ``k`` rung energies (JAX draws it from
    ``key(seed)``)."""
    return random_ladder_energies(torch.Generator().manual_seed(seed), k)


def _gaps(e: np.ndarray, beta: float):
    return (spectral_gap_continuous(continuous_rate_matrix(e, beta)),
            spectral_gap_discrete(reduced_flip_transition_matrix(e, beta)),
            spectral_gap_discrete(discrete_transition_matrix(e, beta)))


def fig_spectral_gap(quick: bool = False, device="cuda") -> dict:
    """Spectral gap: continuous jump process vs reduced flip vs discrete
    HMC, against the ladder size K (β 0.3, draws d) and against β (K 16,
    draws 100 + d). Host float64 eigensolutions; ``device`` is unused."""
    ks = [4, 8, 16] if quick else [4, 8, 16, 32, 64]
    betas = np.linspace(0.05, 1.0, 5 if quick else 12)
    n_draws = 3 if quick else 10
    by_k = [np.mean([_gaps(ladder_energies(d, k), 0.3) for d in range(n_draws)], axis=0)
            for k in ks]
    by_b = [np.mean([_gaps(ladder_energies(100 + d, 16), float(b)) for d in range(n_draws)],
                    axis=0) for b in betas]
    by_k, by_b = np.array(by_k), np.array(by_b)
    return dict(ks=np.array(ks), betas=betas, cont_k=by_k[:, 0], disc_k=by_k[:, 2],
                cont_b=by_b[:, 0], disc_b=by_b[:, 2], rf_k=by_k[:, 1], rf_b=by_b[:, 1])


def render_spectral_gap(plt, a: dict, path: str) -> None:
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    for label, key in (("continuous", "cont"), ("reduced flip", "rf"), ("discrete", "disc")):
        ax1.plot(a["ks"], a[f"{key}_k"], "o-", label=label)
        ax2.plot(a["betas"], a[f"{key}_b"], "o-", label=label)
    ax1.set_xlabel("ladder size K")
    ax1.set_ylabel("spectral gap")
    ax1.set_xscale("log")
    ax1.legend()
    ax2.set_xlabel("β")
    ax2.set_ylabel("spectral gap")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


# ---------------------------------------------------------------------------
# trajectory fan
# ---------------------------------------------------------------------------


def fig_trajectory_fan(quick: bool = False, device="cuda") -> dict:
    """2-D rough-well exploration: MJHMC vs control HMC, 16 chains."""
    dist = RoughWell(ndims=2)
    steps = 100 if quick else 400
    artifacts = {}
    for name, cls, kw in (
            ("mjhmc", MarkovJumpHMC, dict(epsilon=4.0, beta=0.05, num_leapfrog_steps=10)),
            ("control_hmc", ControlHMC, dict(epsilon=4.0, beta=0.1, num_leapfrog_steps=10))):
        s = cls(dist, nbatch=16, seed=0, device=device, **kw)
        artifacts[name] = s.sample(steps)["x"].cpu().numpy()  # (T, 2, n)
    return artifacts


def render_trajectory_fan(plt, a: dict, path: str) -> None:
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    for ax, name in zip(axes, ("mjhmc", "control_hmc")):
        xs = a[name]
        for c in range(xs.shape[2]):
            ax.plot(xs[:, 0, c], xs[:, 1, c], lw=0.3, alpha=0.5)
        ax.set_title(f"{name}: {xs.shape[0]} iterations, {xs.shape[2]} chains")
        ax.set_xlim(-300, 300)
        ax.set_ylim(-300, 300)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


# ---------------------------------------------------------------------------
# tempering
# ---------------------------------------------------------------------------


def fig_tempering(quick: bool = False, device="cuda") -> dict:
    """Mode recovery on the two-mode mixture: stuck HMC vs parallel
    tempering from the same one-basin init (x = −4), against the exact
    density."""
    dist = GaussianMixture()  # modes ±4, σ=0.8
    steps = 400 if quick else 3000
    nbatch = 64 if quick else 256

    hmc = ControlHMC(dist, epsilon=0.4, beta=1.0, num_leapfrog_steps=5, nbatch=nbatch, seed=0,
                     device=device)
    x_stuck = torch.full_like(hmc.state.chain.x, -4.0)
    u, g = dist.potential_and_grad(x_stuck)
    hmc.state = hmc.state._replace(chain=hmc.state.chain._replace(x=x_stuck, u=u, grad=g))
    xs_hmc = hmc.sample(steps)["x"].cpu().numpy().ravel()

    pt = ParallelTempering(dist, epsilon=0.4, num_leapfrog_steps=5, nbatch=nbatch, num_temps=6,
                           beta_min=0.02, seed=0, device=device)
    x0 = torch.full_like(pt.state.x, -4.0)
    u0, g0 = dist.potential_and_grad(x0)
    pt.state = pt.state._replace(x=x0, u=u0, grad=g0)
    pt.burn_in(200 if quick else 500)
    xs_pt = pt.sample(steps)["x"].cpu().numpy().ravel()

    grid = np.linspace(-8, 8, 400)
    exact = np.exp(-dist.potential(torch.as_tensor(grid, dtype=torch.float32)[None, :]).numpy())
    exact /= np.trapezoid(exact, grid)
    return dict(hmc=xs_hmc, pt=xs_pt, grid=grid, exact=exact, swap_rates=pt.swap_rates,
                betas=pt.betas.cpu().numpy())


def render_tempering(plt, a: dict, path: str) -> None:
    fig, ax = plt.subplots(figsize=(7, 4))
    bins = np.linspace(-8, 8, 80)
    ax.hist(a["hmc"], bins=bins, density=True, alpha=0.5, label="HMC (stuck init)")
    ax.hist(a["pt"], bins=bins, density=True, alpha=0.5, label="parallel tempering")
    ax.plot(a["grid"], a["exact"], "k-", lw=1.2, label="exact p(x)")
    ax.set_xlabel("x")
    ax.set_ylabel("density")
    ax.set_title("Two-mode mixture (≈12.5 kT barrier), both from the left basin")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


class Figure(NamedTuple):
    stem: str  # file name of its .npz and .png
    compute: Callable[..., dict]  # (quick, device) -> the .npz arrays
    render: Callable[..., None]  # (plt, arrays, png path)


FIGURES = {
    "autocorr": Figure("autocorr_overlay", fig_autocorr_overlay, render_autocorr_overlay),
    "spectral": Figure("spectral_gap", fig_spectral_gap, render_spectral_gap),
    "fan": Figure("trajectory_fan", fig_trajectory_fan, render_trajectory_fan),
    "tempering": Figure("tempering", fig_tempering, render_tempering),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="figures_out")
    p.add_argument("--quick", action="store_true", help="small/fast versions")
    p.add_argument("--only", choices=sorted(FIGURES), default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = checked_device(args.device, "figures")
    os.makedirs(args.out, exist_ok=True)
    chosen = {name: fig for name, fig in FIGURES.items() if not args.only or name == args.only}
    arrays = {}
    for name, fig in chosen.items():
        print(f"[figures] {name} ...", flush=True)
        arrays[name] = fig.compute(quick=args.quick, device=device)
        np.savez(os.path.join(args.out, fig.stem + ".npz"), **arrays[name])
    plt = pyplot()
    for name, fig in chosen.items():
        fig.render(plt, arrays[name], os.path.join(args.out, fig.stem + ".png"))
    print(f"[figures] wrote {args.out}/")


if __name__ == "__main__":
    main()
