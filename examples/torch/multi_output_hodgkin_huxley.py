"""Multi-output Hodgkin-Huxley example on bluest_tpu_torch (the reference
paper's 12-model, 5-output configuration, blue_hodgkin-huxley.py): mixed
integrator fidelities (RK4/Euler timesteps) and a FitzHugh-Nagumo
reduction, estimated jointly for five QoIs through the coupled-group
engine.

Run:  python examples/torch/multi_output_hodgkin_huxley.py [--full] [--fast]
      python examples/torch/multi_output_hodgkin_huxley.py --fast --device cpu
(--full uses all 12 models; the default is a 6-model subset.  --fast
shrinks the pilot to 256 samples, at the price of a noisier covariance
and a looser allocation.  On the card each group evaluation is one
launch of the hand-written Hodgkin-Huxley kernel, which integrates all
of the group's models; on the CPU it is a Python loop of elementwise
operations per time step.  See examples/torch/README.md for times.)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

from bluest_tpu_torch.models.hodgkin_huxley import (DEFAULT_MODELS,
                                                    HodgkinHuxleyProblem)

SUBSET = ((0, 0.02), (0, 0.04), (1, 0.02), (1, 0.04), (2, 0.02), (2, 0.04))
PILOT = 1024
FAST_PILOT = 256
EPS_FRACTION = 0.05          # each output's RMSE: 5% of its std-dev
K = 3


def main(argv=None):
    """Run the study; returns what it printed as a dict."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--full", action="store_true",
                        help="all 12 models of the paper")
    parser.add_argument("--fast", action="store_true",
                        help="a pilot of %d samples" % FAST_PILOT)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="sampling device (default: the card)")
    args = parser.parse_args(argv)

    models = DEFAULT_MODELS if args.full else SUBSET
    pilot = FAST_PILOT if args.fast else PILOT
    problem = HodgkinHuxleyProblem(models=models,
                                   covariance_estimation_samples=pilot,
                                   device_batch_size=pilot,
                                   device=args.device, verbose=False)

    print("costs:", np.round(problem.get_costs(), 2))
    print("rho(output 0):", np.round(problem.get_correlation(0)[0], 3))

    eps = [EPS_FRACTION * np.sqrt(problem.get_covariance(n)[0, 0])
           for n in range(problem.n_outputs)]
    blue = problem.setup_solver(K=K, eps=eps)
    print("\nMLBLUE groups:", blue["models"])
    print("total cost:", blue["total_cost"])
    mus, errs, cost = problem.solve(K=K, eps=eps)
    estimates = [float(m) for m in mus]
    print("estimates:", estimates)
    print("errors:   ", errs)
    return {"models": models, "costs": problem.get_costs(),
            "groups": blue["models"], "total_cost": blue["total_cost"],
            "eps": eps, "estimates": estimates, "errors": np.asarray(errs),
            "cost": float(cost)}


if __name__ == "__main__":
    main()
