"""Navier-Stokes paper study on bluest_tpu_torch, end-to-end runnable.

Re-creates the reference's 12-model 6-output Navier-Stokes study
(examples/paper_examples/navier_stokes/bluest_NS.py) from its model-graph
npz:

  1. OFFLINE (exactly the reference workflow): load the npz through the
     reference-format reader, set up MLBLUE / MLMC / MFMC at the study's
     tolerance, and print the cost comparison the paper reports
     (plot_histograms.py:58-65: BLUE 2.55M < MFMC 4.34M < MLMC 6.58M in
     cost units at the paper's K=7; at K=3 here the ordering already
     holds).  --solver-test also times the sdp, scipy and spg solvers on
     the same instance (bluest_NS.py:124-140).

  2. ONLINE: the original FEniCS flow solver cannot run here, so the
     sampling phase runs on a Gaussian surrogate whose per-output model
     covariance EQUALS the loaded C_n (P_n = mu_n + chol(C_n) z with a
     shared latent z ~ N(0, I_12)), a factored torch model on the sampling
     device.  The known means make the estimator error measurable: the
     run checks that |mu_hat_n - mu_n| stays within 5x the predicted RMSE.

The npz is not part of this repository: the script reads it from NS_NPZ
(examples/paper_examples/navier_stokes/ as in the reference) and says so
and returns when it is not there.

Run:  python examples/torch/navier_stokes_study.py [--solver-test]
      python examples/torch/navier_stokes_study.py --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

from bluest_tpu_torch import BLUEProblem

# where the reference keeps the study's graph, relative to this repository
NS_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "paper_examples", "navier_stokes",
                      "NS_model_data_full.npz")
K = 3
TRUE_MEANS = np.arange(1.0, 7.0)     # known surrogate means per output


class NSOffline(BLUEProblem):
    """The study's model graph alone: known covariances and costs."""


class NSSurrogate(BLUEProblem):
    """P_n(l) = mu_n + (chol(C_n) z)_l with shared z: per-output model
    covariance equals the loaded C_n, so the offline allocation is the
    right one for this model family."""

    def __init__(self, chol, means, **params):
        self.chol = np.asarray(chol, dtype=float)      # (n_outputs, M, M)
        self.means = np.asarray(means, dtype=float)    # (n_outputs,)
        n_outputs, M, _ = self.chol.shape
        super().__init__(M, n_outputs=n_outputs, **params)

    def sample_inputs(self, generator, n):
        return torch.randn((n, self.M), generator=generator,
                           dtype=torch.float64, device=self.device)

    def evaluate_model(self, l, z):
        # row l of every output's factor: (n, M) @ (M, n_outputs)
        rows = torch.as_tensor(self.chol[:, l, :], device=z.device)
        return torch.as_tensor(self.means, device=z.device) + z @ rows.T


def main(argv=None):
    """Run the study; returns what it printed as a dict (None when the
    npz is not there)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--solver-test", action="store_true",
                        help="time the sdp, scipy and spg solvers")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="sampling device (default: the card)")
    args = parser.parse_args(argv)

    if not os.path.exists(NS_NPZ):
        print("reference NS npz not mounted at", NS_NPZ)
        return None

    # ---------------- offline: the paper's allocation study -------------- #
    p = NSOffline(12, n_outputs=6, datafile=NS_NPZ, device=args.device,
                  verbose=True)
    C = p.get_covariances()
    eps = 1e-3 * np.sqrt([c[0, 0] for c in C])   # bluest_NS.py:121

    blue = p.setup_solver(K=K, eps=eps)
    mlmc = p.setup_mlmc(eps=eps)
    mfmc = p.setup_mfmc(eps=eps)
    print("\nAllocation costs at the study tolerance (cost units):")
    print("  MLBLUE (K=%d): %12.1f" % (K, blue["total_cost"]))
    print("  MFMC:          %12.1f" % mfmc["total_cost"])
    print("  MLMC:          %12.1f" % mlmc["total_cost"])
    print("  savings vs MLMC: %.2fx, vs MFMC: %.2fx"
          % (mlmc["total_cost"] / blue["total_cost"],
             mfmc["total_cost"] / blue["total_cost"]))
    out = {"costs": {"mlblue": float(blue["total_cost"]),
                     "mfmc": float(mfmc["total_cost"]),
                     "mlmc": float(mlmc["total_cost"])}, "eps": eps}

    if args.solver_test:
        # time every continuous solver on the same instance and compare
        # the resulting max-variance at a common budget
        budget = blue["total_cost"]
        mos = p.MOSAP
        out["solver_test"] = {}
        print("\nsolver_test at budget %.0f:" % budget)
        for name in ("sdp", "scipy", "spg"):
            t0 = time.time()
            m = mos.solve(budget=budget, solver=name,
                          continuous_relaxation=True)
            dt = time.time() - t0
            if m is None:
                print("  %-6s FAILED (%.2fs)" % (name, dt))
                out["solver_test"][name] = {"s": dt, "max_variance": None}
                continue
            mx = max(mos.variances(np.maximum(np.asarray(m, float), 0)))
            print("  %-6s %7.2fs  max variance %.6e" % (name, dt, mx))
            out["solver_test"][name] = {"s": dt, "max_variance": float(mx)}
            mos._ray_cache = {}        # time each solver cold

    # ---------------- online: Gaussian surrogate sampling ---------------- #
    Ls = [np.linalg.cholesky(c + 1e-10 * np.trace(c) / 12 * np.eye(12))
          for c in C]
    q = NSSurrogate(Ls, TRUE_MEANS, C=[np.asarray(c) for c in C],
                    costs=p.get_costs(), verbose=True, skip_projection=True,
                    device_batch_size=8192, device=args.device)
    # a wider tolerance keeps the demo fast; the allocation machinery is
    # identical to the paper run above
    eps_demo = 20 * eps
    mus, errs, cost = q.solve(K=K, eps=eps_demo)
    print("\nSurrogate estimation run (eps = 20x study tolerance):")
    ok = True
    for n in range(6):
        dev = abs(float(mus[n]) - TRUE_MEANS[n])
        print("  output %d: mu_hat=%9.5f (true %.1f)  |err|=%.2e  "
              "predicted rmse=%.2e" % (n, float(mus[n]), TRUE_MEANS[n],
                                       dev, errs[n]))
        ok &= dev < 5 * max(errs[n], 1e-12)
    print("estimates within 5x predicted RMSE:", bool(ok))
    if not ok:
        raise AssertionError("a surrogate estimate is more than 5 predicted "
                             "RMSEs from its known mean")
    out.update(estimates=np.array([float(m) for m in mus]),
               errors=np.asarray(errs), cost=float(cost),
               within_5_rmse=bool(ok))
    return out


if __name__ == "__main__":
    main()
