"""Quickstart for the PyTorch port: sample the 2-D rough well with MJHMC,
estimate moments, cross the two-mode mixture with parallel tempering, and
compare MJHMC against control HMC on the grad-eval fairness axis.

Runs on the GPU:  python examples/quickstart_torch.py
On the CPU:       python examples/quickstart_torch.py --device cpu [--quick]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from mjhmc_tpu_torch.experiments import calculate_autocorrelation
from mjhmc_tpu_torch.models import GaussianMixture, RoughWell
from mjhmc_tpu_torch.samplers import MarkovJumpHMC, ParallelTempering


def main(argv=None):
    """Print the quickstart's results; return them as a dict (the rough
    well's variance and oracle, PT's variance and the exact one, and each
    sampler's (decay evals, censored))."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true", help="a tenth of the chains and steps")
    a = ap.parse_args(argv)
    s = 10 if a.quick else 1  # the sizes' divisor
    dist = RoughWell(ndims=2)

    sampler = MarkovJumpHMC(dist, epsilon=4.0, beta=0.1, num_leapfrog_steps=10,
                            nbatch=2048 // s, device=a.device)
    sampler.burn_in(300 // s)
    out = sampler.sample(1000 // s)

    xs = out["x"].cpu().numpy()  # (steps, ndims, nbatch)
    w = out["dwell"].cpu().numpy()[:, None, :]  # Rao-Blackwell weights
    var = (w * xs**2).sum(axis=(0, 2)) / w.sum()
    oracle = np.asarray(dist.analytic_var())
    print(f"dwell-weighted variance: {var}  (quadrature oracle: {oracle})")
    print(f"algorithmic gradient evaluations: {sampler.grad_evals:,}")

    # multimodal targets: parallel tempering with a self-tuned ladder
    mog = GaussianMixture()  # modes at ±4, σ=0.8 — ≈12.5 kT barrier
    pt = ParallelTempering(mog, epsilon=0.4, num_leapfrog_steps=5, nbatch=512 // s,
                           num_temps=6, beta_min=0.02, device=a.device)
    pt.adapt_ladder(num_windows=10, window_size=40 // s)
    pt.burn_in(300 // s)
    x_pt = pt.sample(1000 // s)["x"].cpu().numpy()
    exact = float(np.asarray(mog.analytic_var())[0])
    print(f"two-mode mixture: PT variance {x_pt.var():.2f} (exact {exact:.2f}), "
          f"swap rates {np.round(pt.swap_rates, 2)}")

    decays = {}
    for name, beta in (("mjhmc", 0.1), ("control", 0.2)):
        res = calculate_autocorrelation(
            dist, name, num_steps=800 // s, nbatch=512 // s, nlags=200 // s,
            epsilon=4.0, num_leapfrog_steps=10, beta=beta,
            use_cached_init=False, burn_steps=200 // s, device=a.device,
        )
        tag = " (lower bound — censored)" if res.censored else ""
        print(f"{name}: grad evals to 1/e autocorrelation ≈ {res.decay_evals:,.0f}{tag}")
        decays[name] = (float(res.decay_evals), bool(res.censored))
    return dict(var=var, oracle=oracle, pt_var=float(x_pt.var()), pt_exact=exact, decays=decays)


if __name__ == "__main__":
    main()
