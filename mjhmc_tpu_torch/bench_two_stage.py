"""The two-stage integrator's matched-budget A/B at a receipts table's own
rows (counterpart of ``tools/bench_two_stage.py``).

For every mjhmc/control row of the given configs in a ``bench_ess --table
--json-out`` file, both integrators are measured again at the row's own
point under the same repeats protocol (``bench_ess.measure_repeats``, the
median of ``--repeats`` independent seeds, the spread recorded): leapfrog
at (ε, M) and two-stage at the matched budget (2ε, max(1, M/2)), the same
gradient evaluations and trajectory span. A two-stage row is first mapped
back to its leapfrog form, so the transform is applied once. One JSON line
per measurement, JAX's fields and the card's name and power limit; the
list goes to ``--out``.

    python -m mjhmc_tpu_torch.bench_two_stage --receipts rows.json --out ab.json \\
        [--configs rough_well,rough_well_a3,gauss2d] [--repeats 5] [--device cpu]

The engines run on the card unless ``--device cpu`` is asked for; without
a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--configs", default="rough_well,rough_well_a3,gauss2d")
    ap.add_argument("--receipts", required=True,
                    help="a bench_ess --table --json-out file")
    ap.add_argument("--out", required=True, help="write the A/B rows here")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        print("bench_two_stage: --device cuda needs a CUDA device (use --device cpu)",
              file=sys.stderr)
        return 1

    from mjhmc_tpu_torch import bench_ess

    with open(a.receipts) as f:
        receipts = json.load(f)
    configs = {c for c in a.configs.split(",") if c}

    rows = []
    for rec in receipts:
        d = rec["detail"]
        if d["config"] not in configs or d["sampler"] not in ("mjhmc", "control"):
            continue
        eps, beta, m = d["epsilon"], d["beta"], d["num_leapfrog_steps"]
        committed_integ = d.get("integrator", "leapfrog")
        # the row's point in its leapfrog form, so the transform is applied once
        if committed_integ == "two_stage":
            eps, m = eps / 2.0, m * 2
        for integ, e, mm in (("leapfrog", eps, m), ("two_stage", 2 * eps, max(1, m // 2))):
            r = bench_ess.measure_repeats(d["config"], d["sampler"], 2000, 500, e, beta, mm,
                                          repeats=a.repeats, integrator=integ,
                                          device=a.device)
            row = dict(
                config=d["config"], sampler=d["sampler"], integrator=integ,
                epsilon=e, beta=beta, num_leapfrog_steps=mm,
                ess_per_s=r["value"],
                rel_spread=r["detail"]["repeats"]["rel_spread"],
                repeat_values=r["detail"]["repeats"]["values"],
                window_steps=r["detail"]["repeats"]["window_steps"],
                committed_row_value=rec["value"],
                committed_row_integrator=committed_integ,
                **{k: r[k] for k in ("device_name", "power_limit") if k in r},
            )
            rows.append(row)
            print(json.dumps(row), flush=True)

    with open(a.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
