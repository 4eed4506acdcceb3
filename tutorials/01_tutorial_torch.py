"""bluest_tpu_torch tutorial -- the reference walkthrough on PyTorch.

Estimates E[e^Z], Z ~ N(0,1), with a hierarchy of truncated exponential
series (reference tutorials/01_tutorial.py).  The models sample on the
card unless --device cpu asks for the host; nothing falls back from one
to the other.  Inside a torch.distributed job, mesh="auto" (part 6)
shards the sampling over the ranks.

Run:  python tutorials/01_tutorial_torch.py
      python tutorials/01_tutorial_torch.py --device cpu
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import torch

from bluest_tpu_torch import BLUEProblem

n_models = 5


def series(z, n_terms):
    """sum_{i <= n_terms} z^i / i! for each entry of z (n,)."""
    ii = torch.arange(n_terms + 1, dtype=torch.float64, device=z.device)
    fact = torch.exp(torch.lgamma(ii + 1.0))
    return (z[:, None] ** ii / fact).sum(dim=1)


class MyProblem(BLUEProblem):
    """Factored torch model: theta = Z shared by all coupled fidelities.
    Both hooks are batched: n inputs at a time, drawn from the explicit
    generator on the problem's device."""

    def sample_inputs(self, generator, n):
        return torch.randn(n, generator=generator, dtype=torch.float64,
                           device=self.device)

    def evaluate_model(self, l, z):
        v = torch.exp(z) if l == 0 else series(z, n_models - l)
        return v[:, None]                       # (n, n_outputs)


class MyMultiProblem(BLUEProblem):
    def sample_inputs(self, generator, n):
        return torch.randn(n, generator=generator, dtype=torch.float64,
                           device=self.device)

    def evaluate_model(self, l, z):
        v = torch.exp(z) if l == 0 else series(z, n_models - l)
        return torch.stack([v, v * v], dim=1)   # (n, 2)


class MyHostProblem(BLUEProblem):
    """Black-box model on the host: numpy in, numpy out."""

    def sampler(self, ls, N=1):
        z = np.random.randn(N)                # batched: N samples at once
        return [z for _ in range(len(ls))]

    def evaluate(self, ls, samples, N=1):
        out = []
        for i, l in enumerate(ls):
            z = np.asarray(samples[i])
            if l == 0:
                v = np.exp(z)
            else:
                n_terms = n_models - l
                ii = np.arange(n_terms + 1)[:, None]
                v = np.sum(z[None, :] ** ii
                           / np.cumprod(np.maximum(ii, 1), axis=0), axis=0)
            out.append(v)
        return [out]


costs = np.array([2.0 ** (n_models - i) for i in range(n_models)])


def main(argv=None):
    """Run the walkthrough; returns its main results as a dict."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="sampling device (default: the card)")
    device = parser.parse_args(argv).device
    res = {}

    # ---------------- Part 1: basic usage ------------------------------- #

    problem = MyProblem(n_models, costs=costs, device=device,
                        covariance_estimation_samples=4096, verbose=False)

    print("Covariance matrix:\n", problem.get_covariance())
    print("\nCorrelation matrix:\n", problem.get_correlation())
    print("\nCost vector:\n", problem.get_costs())

    # 2% of the output std-dev keeps the tutorial fast; tighten to taste
    eps = 0.02 * np.sqrt(problem.get_covariance()[0, 0])

    sol_mc = problem.solve_mc(eps=eps)
    print("\nStd MC solution:", sol_mc[0], " cost:", sol_mc[2])

    mlmc_data = problem.setup_mlmc(eps=eps)
    sol_mlmc = problem.solve_mlmc(eps=eps, mlmc_data=mlmc_data)
    print("MLMC models:", mlmc_data["models"], " cost:",
          mlmc_data["total_cost"])
    print("MLMC solution:", sol_mlmc[0])

    mfmc_data = problem.setup_mfmc(eps=eps)
    sol_mfmc = problem.solve_mfmc(eps=eps, mfmc_data=mfmc_data)
    print("MFMC models:", mfmc_data["models"], " cost:",
          mfmc_data["total_cost"])
    print("MFMC solution:", sol_mfmc[0])

    blue_data = problem.setup_solver(K=n_models, eps=eps)
    sol_blue = problem.solve(K=n_models, eps=eps)
    print("MLBLUE groups:", blue_data["models"], " cost:",
          blue_data["total_cost"])
    print("MLBLUE solution:", sol_blue[0])
    print("\nCost comparison. MLMC: %.0f, MFMC: %.0f, MLBLUE: %.0f"
          % (mlmc_data["total_cost"], mfmc_data["total_cost"],
             blue_data["total_cost"]))
    res["basic"] = {"mc": sol_mc, "mlmc": sol_mlmc, "mfmc": sol_mfmc,
                    "mlblue": sol_blue}

    # user-prescribed groups
    groups = [[0], [1], [0, 3], [3, 4], [0, 1, 2, 3, 4]]
    blue_data = problem.setup_solver(groups=groups, eps=eps)
    print("\nUser groups selected:", blue_data["models"])

    # budget mode
    budget = 100 * max(costs)
    blue_data = problem.setup_solver(K=n_models, budget=budget)
    print("Budget-mode cost:", blue_data["total_cost"], "<= budget", budget)

    # solver selection and parameters ("cvxopt"/"cvxpy" are accepted as
    # names of the interior-point cone solver, "sdp"; "scipy"/"ipopt" name
    # the NLP path and "spg" the projected spectral-gradient path -- three
    # algorithmically independent families for cross-validation)
    problem.setup_solver(K=n_models, budget=budget, solver="sdp",
                         optimization_solver_params={"tol": 1e-8})
    problem.setup_solver(K=n_models, budget=budget, solver="scipy")
    problem.setup_solver(K=n_models, budget=budget, solver="spg")

    # every cone solve records its interior-point certificate, and an
    # independent first-order KKT verifier re-checks the continuous optimum
    problem.setup_solver(K=n_models, budget=budget)
    cert = min(problem.MOSAP_output["certificates"],
               key=lambda c: max(c["relgap"], c["pres"], c["dres"]))
    kkt = problem.MOSAP.kkt_certificate()
    print("SDP certificate: %s (relgap %.1e); KKT stationarity %.1e"
          % (cert["status"], cert["relgap"], kkt["stationarity"]))

    with tempfile.TemporaryDirectory(prefix="bluest_tutorial_") as tmp:

        # ---------------- Part 2: persistence --------------------------- #

        problem.save_graph_data(os.path.join(tmp, "data.npz"))
        problem2 = MyProblem(n_models, datafile=os.path.join(tmp, "data.npz"),
                             device=device, verbose=False)
        assert np.allclose(problem2.get_covariance(),
                           problem.get_covariance(), equal_nan=True)

        # known covariance skips pilot sampling entirely
        C = np.random.randn(n_models, n_models)
        C = C.T @ C
        MyProblem(n_models, C=C.copy(), costs=costs, device=device,
                  verbose=False)

        # NaN = re-estimate, inf = never couple (reference sentinel
        # semantics)
        C2 = np.nan * np.ones((n_models, n_models))
        C2[0, 1] = C2[1, 0] = np.inf
        problem4 = MyProblem(n_models, C=C2, costs=costs, device=device,
                             covariance_estimation_samples=1024,
                             verbose=False)
        out = problem4.setup_solver(K=3, eps=eps)
        assert all(not (0 in g and 1 in g) for g in out["models"])

        # ---------------- Part 3: multiple outputs ---------------------- #

        mproblem = MyMultiProblem(n_models, n_outputs=2, costs=costs,
                                  device=device,
                                  covariance_estimation_samples=4096,
                                  verbose=False)
        eps2 = [0.02 * np.sqrt(mproblem.get_covariance(n)[0, 0])
                for n in range(2)]
        mproblem.setup_solver(K=n_models, eps=eps2)
        mus, errs, cost = mproblem.solve(K=n_models, eps=eps2)
        print("\nMulti-output MLBLUE: mus =", mus, " errors =", errs)
        print("(exact: E[e^Z] = %.6f, E[e^2Z] = %.6f)"
              % (np.exp(0.5), np.exp(2.0)))
        res["multi"] = (mus, errs, cost)

        # statistical self-validation (reference variance_test)
        err_ex, err = mproblem.variance_test(eps=eps2, K=3, N=10)
        print("\nvariance_test: predicted", err_ex, "empirical", err)

        # ---------------- Part 4: sample snapshots ---------------------- #
        # samplefile streams every model output and raw input sample to
        # npz files (reference tutorial 01_tutorial.py:244-259) -- one file
        # per coupled group, named basename + model indices + extension,
        # appended across runs.  outputs_to_save filters which outputs are
        # stored.

        mproblem.params["samplefile"] = os.path.join(tmp, "snaps.npz")
        mproblem.params["outputs_to_save"] = [0]      # store output 0 only
        mproblem.solve(K=2, eps=[4 * e for e in eps2])
        snap_files = sorted(f for f in os.listdir(tmp)
                            if f.startswith("snaps"))
        d = dict(np.load(os.path.join(tmp, snap_files[0]),
                         allow_pickle=True))
        print("\nSnapshot files:", snap_files)
        print("First file: models %s, %d samples, keys %s"
              % (list(d["models"][0]), int(d["n_samples"][0]),
                 sorted(k for k in d if k.startswith("values"))))
        mproblem.params["samplefile"] = None          # turn streaming off
        mproblem.params["outputs_to_save"] = None
        res["snapshot_files"] = snap_files

    # ---------------- Part 5: black-box (non-torch) models -------------- #
    # Any plain-Python simulator works unchanged through the host engine:
    # override sampler/evaluate instead of the torch hooks.
    # sample_batch_size passes N samples per evaluate call when the
    # overloads accept a batch argument (reference blue_fn.py:112-167);
    # spg_params tunes the SPG covariance-projection optimizer (reference
    # blue_models.py:13-20).  The model runs on the host; ``device`` names
    # where the problem allocates (its covariance projection and MOSAP).

    hproblem = MyHostProblem(n_models, costs=costs, device=device,
                             covariance_estimation_samples=1024,
                             sample_batch_size=256,      # vectorized batches
                             spg_params={"maxit": 500},  # projection budget
                             verbose=False)
    sol_host = hproblem.solve_mc(eps=4 * eps)
    print("\nBlack-box host model, std MC:", sol_host[0])
    res["host_mc"] = sol_host

    # ---------------- Part 6: multi-device sampling --------------------- #
    # mesh="auto" shards the sample axis over the ranks of an initialised
    # torch.distributed job (bluest_tpu_torch.parallel.initialize_
    # distributed, started by torchrun or any launcher) with one
    # all_reduce of the sums per fetch -- the reference's `mpiexec -n P`
    # (tutorial 01_tutorial.py:140-172) with deterministic per-chunk
    # streams.  In a single process it is a no-op.

    dproblem = MyProblem(n_models, costs=costs, mesh="auto", device=device,
                         covariance_estimation_samples=4096, verbose=False)
    sol_dev = dproblem.solve(K=3, eps=eps)
    dist = torch.distributed
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print("\nmesh='auto' over %d rank(s) (%d card(s) visible): MLBLUE "
          "solution %s" % (world, cards, sol_dev[0]))
    res["mesh"] = {"world": world, "cards": cards, "solution": sol_dev}

    print("\nTutorial completed.")
    return res


if __name__ == "__main__":
    main()
