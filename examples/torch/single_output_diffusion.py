"""Single-output stochastic diffusion example on bluest_tpu_torch (the
reference's single_output_example.py pattern): estimate E[int u] for the
lognormal diffusion hierarchy; compare MLMC / MFMC / MLBLUE at equal
tolerance and optionally run the statistical validation tests.

Every model evaluation runs the fused diffusion kernel
(bluest_tpu_torch/csrc/diffusion.cu, built with nvcc at first use) on the
card; with --device cpu its plain PyTorch version runs instead.

Run:  python examples/torch/single_output_diffusion.py [--tests]
      python examples/torch/single_output_diffusion.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

from bluest_tpu_torch.models.diffusion import DiffusionProblem

GRIDS = (256, 64, 16, 4)
N_KL = 32
SIGMA = 1.0
NU = 0.6
PILOT = 4096
EPS_FRACTION = 0.02          # target RMSE = 2% of the output's std-dev
K = 4


def main(argv=None):
    """Run the study; returns what it printed as a dict."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tests", action="store_true",
                        help="add complexity_test and variance_test")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="sampling device (default: the card)")
    args = parser.parse_args(argv)

    problem = DiffusionProblem(grids=GRIDS, n_kl=N_KL, sigma=SIGMA, nu=NU,
                               covariance_estimation_samples=PILOT,
                               device=args.device, verbose=False)

    C = problem.get_covariance()
    rho = problem.get_correlation()[0]
    print("correlations with model 0:", np.round(rho, 4))
    eps = EPS_FRACTION * np.sqrt(C[0, 0])

    mlmc = problem.setup_mlmc(eps=eps)
    mfmc = problem.setup_mfmc(eps=eps)
    blue = problem.setup_solver(K=K, eps=eps)
    print("\nCost at eps=%.3g:  MLMC %.0f   MFMC %.0f   MLBLUE %.0f"
          % (eps, mlmc["total_cost"], mfmc["total_cost"],
             blue["total_cost"]))
    mu, errs, cost = problem.solve(K=K, eps=eps)
    print("MLBLUE estimate: %.6f +- %.2g (cost %.0f)"
          % (mu[0], errs[0], cost))
    out = {"correlations": rho, "eps": eps,
           "costs": {"mlmc": mlmc["total_cost"], "mfmc": mfmc["total_cost"],
                     "mlblue": blue["total_cost"]},
           "mu": float(mu[0]), "err": float(errs[0]), "cost": float(cost)}

    if args.tests:
        tot_cost, rate = problem.complexity_test(
            [eps * 2 ** (1 - i) for i in range(3)], K=3)
        print("complexity rate (log2 cost per eps halving):", rate)
        err_ex, err = problem.variance_test(eps=eps * 2, K=3, N=30)
        print("variance test: predicted", err_ex, "empirical", err)
        out.update(complexity_costs=tot_cost, complexity_rate=float(rate),
                   variance_predicted=err_ex, variance_empirical=err)
    return out


if __name__ == "__main__":
    main()
