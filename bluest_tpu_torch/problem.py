"""BLUEProblem: the user-facing orchestration class, on PyTorch.

Port of ``bluest_tpu/problem.py`` for the MLBLUE main path (reference API
blue_models.py:42-978): construction runs pilot covariance estimation
and the SPD projection, ``setup_solver`` runs the allocation
optimization, ``solve`` runs the sampling loop and assembles the
estimators.

A model is given in factored form, batched:
``sample_inputs(generator, n)`` draws n shared random inputs on
``self.device`` and ``evaluate_model(l, inputs)`` returns model l's
``(n, n_outputs)`` outputs.  Sampling runs on the device named by the
``device`` parameter -- nothing picks one automatically -- and the
allocation on ``config.allocation_device()``.

Not ported yet: MLMC / MFMC / MC, the host engine for black-box
``evaluate``/``sampler`` models, sample snapshots, meshes and the masked
(SPG) covariance projection.
"""

from __future__ import annotations

from time import time
from typing import Optional

import numpy as np
import torch

from .allocation import MOSAP, BLUESTError
from .graph import CovarianceGraph, cliques
from .linalg.spd import project_covariance_full
from .sampling.engine import SamplingEngine, generator_seed

spg_default_params = {
    "maxit": 10000,
    "max_fevals": 10000 ** 2,
    "verbose": False,
    "spd_threshold": 5.0e-14,
    "eps": 1.0e-10,
    "lmbda_min": 10.0 ** -30,
    "lmbda_max": 10.0 ** 30,
    "linesearch_history_length": 10,
}

default_params = {
    "verbose": True,
    "remove_uncorrelated": True,
    "optimization_solver": "sdp",
    "covariance_estimation_samples": 100,
    "skip_projection": False,
    "spg_params": spg_default_params,
    "seed": 0,
    "device": "cpu",                   # sampling device, never inferred
    "device_batch_size": 4096,
}


def _dv_fold(D: np.ndarray) -> np.ndarray:
    """Fold finite MLMC-variance entries onto both triangles (``dV`` is
    read at ``(min(i,j), max(i,j))``; the original entry wins when both
    are finite)."""
    D = np.array(D, dtype=float)
    return np.where(np.isfinite(D), D, D.T)


class BLUEProblem:
    def __init__(self, M: int, C=None, costs=None, mlmc_variances=None,
                 datafile: Optional[str] = None, n_outputs: int = 1,
                 **params):
        """See reference blue_models.py:43-103.  ``C`` entries: NaN =
        estimate from pilot samples, inf = models never coupled, 0 = known
        uncorrelated, finite = known covariance."""
        self.M = M
        self.n_outputs = n_outputs

        self.MOSAP = None
        self.MOSAP_output = None

        unknown = set(params) - set(default_params)
        if unknown:
            raise TypeError("unknown parameters: %s" % sorted(unknown))
        self.params = default_params.copy()
        spg_params = spg_default_params.copy()
        spg_params.update(params.get("spg_params", {}))
        params["spg_params"] = spg_params
        self.params.update(params)

        self.verbose = self.params["verbose"]
        self.device = torch.device(self.params["device"])
        self._engine = None
        self._call_counter = 0
        # per-group sampling telemetry: {group: {"samples", "wall_s"}}
        self.sampling_stats = {}

        if C is None:
            C = [np.nan * np.ones((M, M)) for _ in range(n_outputs)]
        if mlmc_variances is None:
            dV = [np.nan * np.ones((M, M)) for _ in range(n_outputs)]
        else:
            dV = mlmc_variances

        if datafile is not None:
            self.load_graph_data(datafile, costs)
            self.check_costs(warning=True)
        else:
            if not isinstance(C, (list, tuple)):
                C = [C]
            if not isinstance(dV, (list, tuple)):
                dV = [dV]
            for n in range(n_outputs):
                Cn = np.asarray(C[n], dtype=float)
                if Cn.shape != (M, M):
                    raise ValueError(
                        "C[%d] has shape %s; expected (M, M) = (%d, %d)"
                        % (n, Cn.shape, M, M))
            if costs is not None:
                w = np.asarray(costs, dtype=float)
                if w.shape != (M,):
                    raise ValueError(
                        "costs has shape %s; expected (M,) = (%d,)"
                        % (w.shape, M))
                if not np.all(np.isfinite(w)) or np.any(w <= 0):
                    raise ValueError(
                        "model costs must be finite and positive, got %s"
                        % w)
            self.G = [CovarianceGraph(np.array(C[n], dtype=float))
                      for n in range(n_outputs)]
            self.SG = [list(range(M)) for _ in range(n_outputs)]
            self.dV = [_dv_fold(dVn) for dVn in dV]
            self.costs = (None if costs is None
                          else np.asarray(costs, dtype=float))

            if self.costs is None:
                self.estimate_costs()
            self.check_costs(warning=True)

            self.estimate_missing_covariances(
                int(self.params["covariance_estimation_samples"]))
            if not self.params["skip_projection"]:
                self.project_covariances()

            self.check_graphs(
                remove_uncorrelated=self.params["remove_uncorrelated"])

        if self.verbose:
            print("\nBLUE estimator ready.\n")

    # ---------------- functions to be overloaded by the user ----------- #

    def sample_inputs(self, generator: torch.Generator, n: int):
        """Batched factored sampler: n random inputs (leading dimension n)
        on ``self.device``, shared by every model of a coupled group."""
        raise NotImplementedError

    def evaluate_model(self, l: int, inputs) -> torch.Tensor:
        """Batched single-model evaluation: the (n, n_outputs) outputs of
        model ``l`` on ``inputs``."""
        raise NotImplementedError

    def get_models_inner_products(self):
        return [lambda a, b: a * b for _ in range(self.n_outputs)]

    # --------------------------- utilities ----------------------------- #

    def _has_factored_model(self) -> bool:
        cls = type(self)
        return (cls.evaluate_model is not BLUEProblem.evaluate_model
                and cls.sample_inputs is not BLUEProblem.sample_inputs)

    def get_costs(self) -> np.ndarray:
        return np.asarray(self.costs, dtype=float)

    def get_group_costs(self, groups):
        model_costs = self.get_costs()
        return np.array([model_costs[list(g)].sum()
                         for gk in groups for g in gk])

    def check_costs(self, warning: bool = True):
        costs = self.get_costs()
        worse = []
        if costs[0] != costs.max():
            worse = list(np.where(costs > costs[0])[0])
            msg = ("Model zero is not the most expensive model. The more "
                   "expensive models are: %s" % worse)
            if warning:
                if self.verbose:
                    print("WARNING! " + msg)
            else:
                raise ValueError(msg)
        return worse

    def get_mlmc_variances(self):
        return self.dV

    def get_covariances(self):
        return [self.get_covariance(n) for n in range(self.n_outputs)]

    def get_covariance(self, n=0) -> np.ndarray:
        return self.G[n].covariance()

    def get_correlations(self):
        return [self.get_correlation(n) for n in range(self.n_outputs)]

    def get_correlation(self, n=0) -> np.ndarray:
        return self.G[n].correlation()

    def outer(self, a, b, inner):
        L = len(a)
        out = np.zeros((L, L))
        for i in range(L):
            for j in range(L):
                out[i, j] = inner(a[i], b[j])
        return out

    # ------------------------ graph persistence ------------------------ #

    def save_graph_data(self, filename: str):
        """Reference-format npz (blue_models.py:265-271)."""
        C_dict = {"C%d" % n: self.G[n].adjacency()
                  for n in range(self.n_outputs)}
        np.savez(filename, M=self.M, n_outputs=self.n_outputs,
                 costs=self.get_costs(), **C_dict,
                 SG=np.array(self.SG, dtype=object), dV=np.array(self.dV))

    def load_graph_data(self, filename: str, costs=None):
        """(blue_models.py:273-299); loads files written by the JAX
        package and by the reference too."""
        data = dict(np.load(filename, allow_pickle=True))
        if self.M != int(data["M"]) or self.n_outputs > int(data["n_outputs"]):
            raise ValueError("Loaded data model/output count mismatch")
        self.G = [CovarianceGraph.from_adjacency(data["C%d" % n])
                  for n in range(self.n_outputs)]
        self.costs = (np.asarray(costs, dtype=float) if costs is not None
                      else np.asarray(data["costs"], dtype=float))
        self.SG = [list(sg) for sg in data["SG"]][:self.n_outputs]
        dV = data.get("dV", None)
        if dV is None:
            self.dV = [np.nan * np.ones((self.M, self.M))
                       for _ in range(self.n_outputs)]
        else:
            self.dV = [_dv_fold(dV[n]) for n in range(self.n_outputs)]

    def check_graphs(self, remove_uncorrelated: bool = False):
        for n in range(self.n_outputs):
            self.check_graph(n, remove_uncorrelated=remove_uncorrelated)

    def check_graph(self, n=0, remove_uncorrelated: bool = False):
        warn = (lambda m: print("WARNING! " + m)) if self.verbose else None
        self.G[n].check(remove_uncorrelated=remove_uncorrelated, warn=warn)
        self.SG[n] = self.G[n].component

    # ---------------- covariance and cost estimation ------------------- #

    def estimate_missing_covariances(self, N: int):
        """(blue_models.py:326-346)"""
        ls = sorted(set().union(*[set(self.G[n].missing_rows())
                                  for n in range(self.n_outputs)]))
        if len(ls) == 0:
            return
        if self.verbose:
            print("Covariance estimation with %d samples..." % N)
        sumse, sumsc, cost, sumsd1, sumsd2 = self.blue_fn(
            ls, N, compute_mlmc_differences=True)
        inners = self.get_models_inner_products()
        C_hat = [np.asarray(sumsc[n]) / N
                 - self.outer(sumse[n], sumse[n], inners[n]) / N ** 2
                 for n in range(self.n_outputs)]

        for n in range(self.n_outputs):
            for a in range(len(ls)):
                for b in range(a + 1, len(ls)):
                    i, j = ls[a], ls[b]
                    if not np.isfinite(self.dV[n][i, j]):
                        d1 = np.asarray(sumsd1[n][a][b]) / N
                        self.dV[n][i, j] = (np.asarray(sumsd2[n][a][b]) / N
                                            - inners[n](d1, d1))

        for n in range(self.n_outputs):
            g = self.G[n]
            for a in range(len(ls)):
                for b in range(a, len(ls)):
                    i, j = ls[a], ls[b]
                    if g.edges[i, j] and g.unknown[i, j]:
                        denom = np.sqrt(C_hat[n][a, a] * C_hat[n][b, b])
                        rho = C_hat[n][a, b] / denom if denom > 0 else 0.0
                        g.set_estimated(i, j, C_hat[n][a, b], rho)

    def project_covariances(self):
        for n in range(self.n_outputs):
            self.project_covariance(n)

    def project_covariance(self, n=0):
        """SPD projection of a fully known covariance
        (blue_models.py:385-392).  Partially known covariances need the
        masked SPG projection, which is not ported yet."""
        C = self.get_covariance(n)
        if not np.isfinite(C).all():
            raise NotImplementedError(
                "output %d: the covariance has unknown or uncouplable "
                "entries; the masked SPG projection is not ported yet" % n)
        C_new, err = project_covariance_full(
            C, self.params["spg_params"]["spd_threshold"])
        if self.verbose:
            print("Covariance projected to be SPD, error:", err)
        self.G[n].apply_projection(C_new)
        return err

    def estimate_costs(self, N: int = 1):
        """Wall-time cost estimation (blue_models.py:435-441)."""
        if self.verbose:
            print("Cost estimation via sampling...")
        self.costs = np.zeros(self.M)
        for l in range(self.M):
            self.blue_fn([l], 1, verbose=False)       # warm-up
            t0 = time()
            _, _, cost = self.blue_fn([l], N, verbose=False)
            wall = time() - t0
            self.costs[l] = (cost if cost > 0 else wall) / N

    # ----------------------------- engine ------------------------------ #

    def _sampling_engine(self) -> SamplingEngine:
        if self._engine is None:
            if not self._has_factored_model():
                raise NotImplementedError(
                    "bluest_tpu_torch samples factored models only: "
                    "override sample_inputs and evaluate_model")
            self._engine = SamplingEngine(
                self.sample_inputs, self.evaluate_model, self.n_outputs,
                int(self.params["device_batch_size"]), self.device)
        return self._engine

    def _next_seed(self) -> int:
        seed = generator_seed(self.params["seed"], self._call_counter)
        self._call_counter += 1
        return seed

    def blue_fn(self, ls, N, verbose=True, compute_mlmc_differences=False):
        """Sums over N coupled samples of group ``ls``: (sumse, sumsc,
        cost[, sumsd1, sumsd2]) in the reference layout (blue_fn.py)."""
        key_ls = tuple(int(l) for l in ls)
        N = int(N)
        t0 = time()
        engine = self._sampling_engine()
        sums = engine.sample_sums(key_ls, self._next_seed(), N)
        # Non-finite samples are masked out of the sums, but the estimator
        # divides by the requested N: top up with fresh draws so the sums
        # cover N finite samples (the reference resamples until all N are
        # finite, blue_fn.py:118-129)
        rounds = 0
        while int(sums.n_failed) > 0 and rounds < 4:
            deficit = int(sums.n_failed)
            extra = engine.sample_sums(key_ls, self._next_seed(), deficit)
            sums = type(sums)(*[a + b for a, b in zip(sums[:-1],
                                                       extra[:-1])],
                              extra.n_failed)
            rounds += 1
        # one device -> host copy for the group
        k, No = len(key_ls), self.n_outputs
        flat = torch.cat([s.reshape(-1).to(torch.float64)
                          for s in sums]).cpu().numpy()
        parts, off = [], 0
        for s in sums:
            parts.append(flat[off:off + s.numel()].reshape(tuple(s.shape)))
            off += s.numel()
        se, sc, d1, d2, n_failed = parts
        n_failed = int(n_failed)
        wall = time() - t0
        st = self.sampling_stats.setdefault(
            key_ls, {"samples": 0, "wall_s": 0.0})
        st["samples"] += N
        st["wall_s"] += wall
        if n_failed > 0 and self.verbose:
            print("WARNING! %d samples non-finite after retries (dropped)"
                  % n_failed)
        if se.shape[-1] == 1:
            se, d1 = se[..., 0], d1[..., 0]    # scalar outputs
        sumse = [[se[n, i] for i in range(k)] for n in range(No)]
        sumsc = [sc[n] for n in range(No)]
        if compute_mlmc_differences:
            sumsd1 = [[[d1[n, i, j] for j in range(k)] for i in range(k)]
                      for n in range(No)]
            sumsd2 = [[[d2[n, i, j] for j in range(k)] for i in range(k)]
                      for n in range(No)]
            return sumse, sumsc, wall, sumsd1, sumsd2
        return sumse, sumsc, wall

    # ----------------------------- solvers ----------------------------- #

    def _ensure_mosap(self, K, multi_groups):
        """Build (or reuse from the structure cache) the MOSAP for this
        group configuration."""
        if multi_groups is None:
            Ks = []
            multi_groups = []
            K = min(K, self.M)
            for n in range(self.n_outputs):
                adj = self.G[n].clique_adjacency()
                cl = cliques.enumerate_cliques(adj, K, nodes=self.SG[n])
                by_size = [[] for _ in range(K)]
                for c in cl:
                    by_size[len(c) - 1].append(sorted(c))
                by_size = [b for b in by_size if b]
                multi_groups.append(by_size)
                Ks.append(len(by_size))
            K = max(Ks)
        else:
            mg = []
            Ks = []
            for n in range(self.n_outputs):
                glist = [sorted(list(g)) for g in multi_groups[n]]
                kmax = min(max(len(g) for g in glist), self.M)
                by_size = [[] for _ in range(kmax)]
                adj = self.G[n].clique_adjacency()
                dropped = []
                for g in glist:
                    if (cliques.is_clique(adj, g)
                            and all(v in self.SG[n] for v in g)):
                        by_size[len(g) - 1].append(g)
                    else:
                        dropped.append(g)
                if dropped and self.verbose:
                    print("WARNING! output %d: dropped user groups that "
                          "are not couplable cliques: %s" % (n, dropped))
                mg.append(by_size)
                Ks.append(max(len(g) for b in by_size for g in b) if any(
                    by_size) else 0)
            multi_groups = mg
            K = max(Ks)

        groups = [[] for _ in range(K)]
        for n in range(self.n_outputs):
            for k in range(len(multi_groups[n])):
                for g in multi_groups[n][k]:
                    if g not in groups[k]:
                        groups[k].append(g)
        for k in range(K):
            groups[k].sort()

        C = self.get_covariances()
        costs = self.get_group_costs(groups)
        multi_costs = [self.get_group_costs(item) for item in multi_groups]

        if self.verbose:
            print("Computing optimal sample allocation...")
        # rebuild the MOSAP only when the problem structure changed
        cache_key = (K, tuple(Ks),
                     tuple(np.asarray(Cn).tobytes() for Cn in C),
                     repr(groups), repr(multi_groups), costs.tobytes())
        if getattr(self, "_mosap_key", None) != cache_key \
                or self.MOSAP is None:
            self.MOSAP = MOSAP(C, K, Ks, groups, multi_groups, costs,
                               multi_costs, verbose=self.verbose)
            self._mosap_key = cache_key
        return self.MOSAP

    def setup_solver(self, K=4, budget=None, eps=None, groups=None,
                     multi_groups=None, solver=None,
                     continuous_relaxation=False, max_model_samples=None,
                     optimization_solver_params=None):
        """(blue_models.py:448-538); budget mode."""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if budget is not None and eps is not None:
            eps = None
        if budget is not None and (not np.isfinite(budget) or budget <= 0):
            raise ValueError("budget must be finite and positive, got %s"
                             % budget)
        if multi_groups is None and groups is None and K < 1:
            raise ValueError("K must be >= 1, got %s" % K)
        if solver is None:
            solver = self.params["optimization_solver"]
        if multi_groups is not None and len(multi_groups) != self.n_outputs:
            raise ValueError("multi_groups must have one grouping per output")
        if groups is not None and multi_groups is None:
            multi_groups = [groups for _ in range(self.n_outputs)]

        self._ensure_mosap(K, multi_groups)
        self.MOSAP.solve(budget=budget, eps=eps, solver=solver,
                         continuous_relaxation=continuous_relaxation,
                         max_model_samples=max_model_samples,
                         solver_params=optimization_solver_params)
        if self.MOSAP.samples is None:
            self.MOSAP_output = None
            raise BLUESTError("MOSAP solution failed!")

        Vs = self.MOSAP.variances(self.MOSAP.samples.astype(float))
        cost_BLUE = self.MOSAP.tot_cost
        C = self.MOSAP.C
        N_MC = max(C[n][0, 0] / Vs[n] for n in range(self.n_outputs))
        cost_MC = N_MC * self.get_costs()[0]
        if self.verbose:
            print("\nBLUE cost:", cost_BLUE, "MC cost:", cost_MC,
                  "Savings:", cost_MC / cost_BLUE)

        self.MOSAP_output = {"budget": budget, "eps": eps,
                             "samples": self.MOSAP.samples,
                             "flattened_groups": self.MOSAP.flattened_groups,
                             "variances": np.asarray(Vs), "cost": cost_BLUE,
                             "certificates": list(self.MOSAP.certificates)}
        if self.verbose and self.MOSAP.certificates:
            best = min(self.MOSAP.certificates,
                       key=lambda cc: max(cc["relgap"], cc["pres"],
                                          cc["dres"]))
            print("SDP certificate [%s]: status=%s relgap=%.2e "
                  "pres=%.2e dres=%.2e (%d iters)"
                  % (best["form"], best["status"], best["relgap"],
                     best["pres"], best["dres"], best["iterations"]))

        sel = np.where(self.MOSAP_output["samples"] > 0)[0]
        which_groups = [self.MOSAP_output["flattened_groups"][i] for i in sel]
        blue_data = {"models": which_groups,
                     "samples": self.MOSAP_output["samples"][sel].copy(),
                     "errors": np.sqrt(np.asarray(Vs)),
                     "total_cost": cost_BLUE}
        if self.verbose:
            print("\nModel groups selected: %s\n" % (which_groups,))
            print("BLUE estimator setup. Max error:",
                  float(np.sqrt(max(Vs))), " Cost:", cost_BLUE, "\n")
        return blue_data

    def solve(self, K=4, budget=None, eps=None, groups=None,
              multi_groups=None, solver=None, verbose=True,
              continuous_relaxation=False, max_model_samples=None,
              optimization_solver_params=None):
        """(blue_models.py:540-576): allocation (if needed), sampling of
        every active group on the device, BLUE estimators."""
        if solver is None:
            solver = self.params["optimization_solver"]
        need_setup = self.MOSAP_output is None
        if not need_setup:
            if budget is not None and budget != self.MOSAP_output["budget"]:
                need_setup = True
            if eps is not None:
                need_setup = True
        if need_setup:
            self.setup_solver(K=K, budget=budget, eps=eps, groups=groups,
                              multi_groups=multi_groups, solver=solver,
                              continuous_relaxation=continuous_relaxation,
                              max_model_samples=max_model_samples,
                              optimization_solver_params=optimization_solver_params)

        if self.verbose and verbose:
            print("\nSampling BLUE...\n")

        flattened_groups = self.MOSAP_output["flattened_groups"]
        sample_list = self.MOSAP_output["samples"]
        n_active = int(sum(1 for N in sample_list if N > 0))
        total_N = int(sum(int(N) for N in sample_list))
        done_groups = 0
        done_N = 0
        t0 = time()
        sums = [[] for _ in range(self.n_outputs)]
        for ls, N in zip(flattened_groups, sample_list):
            if N == 0:
                for n in range(self.n_outputs):
                    sums[n].append([0 for _ in range(len(ls))])
                continue
            sumse, _, _ = self.blue_fn(ls, int(N), verbose=verbose)
            for n in range(self.n_outputs):
                sums[n].append(sumse[n])
            done_groups += 1
            done_N += int(N)
            if self.verbose and verbose:
                print("  group %s: %d samples | %d/%d groups, %d/%d samples"
                      % (list(ls), int(N), done_groups, n_active, done_N,
                         total_N), flush=True)
        if self.verbose and verbose and total_N:
            wall = max(time() - t0, 1e-9)
            print("  estimation: %d samples in %.2fs (%.0f samples/s)"
                  % (total_N, wall, total_N / wall), flush=True)

        mus, Vs = self.MOSAP.compute_BLUE_estimators(sums, sample_list)
        errs = np.sqrt(Vs)
        return mus, errs, self.MOSAP_output["cost"]
