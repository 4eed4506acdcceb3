"""Matern-field restriction study on bluest_tpu_torch.

Re-creates the shape of the reference's restrictions study
(examples/paper_examples/restrictions_matern/restrictions_matern.py):
how does the size of the covariance-estimation pilot affect the MLBLUE
allocation?  The model hierarchy is the spectral SPDE sampler of a 2D
Matern field (bluest_tpu_torch.models.matern2d) -- fidelity = grid
resolution, coupling by spectral restriction (all fidelities share the
finest-grid white noise, coarser models keep the low-frequency block).
The synthesis is a batched float64 matmul on the sampling device.

Run:  python examples/torch/matern_restrictions.py
      python examples/torch/matern_restrictions.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

from bluest_tpu_torch.models.matern2d import Matern2DProblem

GRIDS = (64, 32, 16, 8)
EPS_FRACTION = 0.01          # target RMSE = 1% of the output std-dev
PILOTS = [32, 128, 1024]     # restricted pilot sizes
N_EXACT = 4096               # "exact" covariance stand-in


def allocation_for(pilot, device, seed=0):
    p = Matern2DProblem(GRIDS, covariance_estimation_samples=pilot,
                        seed=seed, device=device, verbose=False)
    # per-output tolerance: 1% of each QoI's std-dev
    eps = EPS_FRACTION * np.sqrt([c[0, 0] for c in p.get_covariances()])
    out = p.setup_solver(K=3, eps=eps)
    return p, out, eps


def main(argv=None):
    """Run the study; returns what it printed as a dict."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="sampling device (default: the card)")
    args = parser.parse_args(argv)

    # reference allocation from a large pilot
    p_ex, out_ex, eps = allocation_for(N_EXACT, args.device)
    worst = np.max(np.asarray(out_ex["errors"]) / eps)
    print(f"exact-pilot ({N_EXACT} samples): cost {out_ex['total_cost']:.1f} "
          f"worst error/eps {worst:.3f}")
    runs = [{"pilot": N_EXACT, "cost": float(out_ex["total_cost"]),
             "errors": np.asarray(out_ex["errors"]), "eps": eps,
             "groups": len(out_ex["samples"])}]

    # the restriction sweep: small pilots give noisy covariances; the SPD
    # projection (linalg/spd.py) keeps them usable, but the allocation
    # degrades -- measured as predicted cost vs the exact-pilot cost.
    for pilot in PILOTS:
        _, out, eps_p = allocation_for(pilot, args.device)
        ratio = out["total_cost"] / out_ex["total_cost"]
        print(f"pilot {pilot:5d}: cost {out['total_cost']:10.1f} "
              f"({ratio:5.2f}x exact), groups {len(out['samples'])}")
        runs.append({"pilot": pilot, "cost": float(out["total_cost"]),
                     "errors": np.asarray(out["errors"]), "eps": eps_p,
                     "groups": len(out["samples"])})

    # run the estimator once at the exact-pilot allocation
    mus, errs, cost = p_ex.solve()
    mu0 = float(np.ravel(mus[0])[0])
    print(f"\nMLBLUE estimate: {mu0:.5f} "
          f"+- {errs[0]:.3e} at sampling cost {cost:.1f}")
    return {"allocations": runs, "mu": mu0, "err": float(errs[0]),
            "cost": float(cost)}


if __name__ == "__main__":
    main()
