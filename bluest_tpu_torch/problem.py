"""BLUEProblem: the user-facing orchestration class, on PyTorch.

Port of ``bluest_tpu/problem.py`` (reference API blue_models.py:42-978):
construction runs pilot covariance estimation and the SPD projection,
``setup_solver`` runs the MLBLUE allocation (budget or target RMSE, with
optional per-model caps), ``solve`` runs the sampling loop and assembles
the estimators.  The MLMC (``setup_mlmc``/``solve_mlmc``), MFMC
(``setup_mfmc``/``solve_mfmc``) and MC (``solve_mc``) estimators and the
``complexity_test``/``variance_test`` studies sample through the same
engine.

A model is given in one of three forms, as in the JAX package:

  * factored, batched torch (``sampling/group_engine.py``'s
    ``factored_hooks``, with no redraw): ``sample_inputs(generator, n)``
    draws n shared random inputs on ``self.device`` and
    ``evaluate_model(l, inputs)`` returns model l's ``(n, n_outputs)``
    outputs;
  * coupled group, batched torch (``sampling/group_engine.py``):
    ``sample_group(generator, ls, n)`` draws n coupled inputs for the
    models ``ls`` and ``evaluate_group(ls, inputs)`` returns
    ``(n, n_outputs, len(ls)[, d])``;
  * black box, on the host (``sampling/host_engine.py``, numpy):
    ``sampler(ls, N=1)`` and ``evaluate(ls, samples, N=1)``, the
    reference API, optionally in a process pool (``host_workers``,
    ``model_workers`` with ``get_comm``; the problem then implements
    ``set_worker_id(wid)`` to reseed its generator per worker).

The torch forms sample on the device named by the ``device`` parameter,
the card (``"cuda"``) unless the caller says ``device="cpu"``; on a host
without a card their first sampling call raises, and nothing falls back
to the CPU.  Black-box models run on the host by nature.  Construction
with known covariances and costs samples nothing.  Covariances with
unknown or uncouplable entries (NaN / inf sentinels) are projected by
the masked SPG projection.  ``samplefile`` streams sample snapshots in
the JAX package's npz format on every path.

A problem allocates on its own device too: the SPD projection, the psi
assembly, the cone solves, the cleanup walk and the integer projection
of ``setup_solver`` (and of ``solve`` when it sets up, and of
``prewarm_solver``) run inside ``config.allocation_device_scope(
self.device)``, so ``device="cpu"`` allocates on the host and the
default on the card; ``BLUEST_TPU_ALLOC_DEVICE=cpu`` moves every
allocation to the host whatever the problem's device.  Without a card a
card-device problem raises at its first allocation (or sampling call).

``solve``, ``solve_mlmc`` and ``solve_mfmc`` dispatch the sampling of
every group before they fetch anything: the sums of all groups reach the
host in one copy per fetch round (a second round only tops up groups
whose model returned non-finite rows).  With ``mesh=`` (a
``parallel/mesh.py`` mesh over an initialised ``torch.distributed`` job;
``"auto"`` = a sample mesh over the world, ``None`` for a world of one)
each sample rank evaluates a block of the chunks of every dispatch (the
calls of a fetch round, dealt as one list) and that one copy is
preceded by one ``all_reduce`` over the sample group; the
allocation runs redundantly on every rank and rank 0's is broadcast, and
only rank 0 prints and writes snapshot files.  ``profile_dir`` writes a
``torch.profiler`` trace of the sampling and the estimate of each
``solve`` there, with the solve's spans (``profiling.py``).
"""

from __future__ import annotations

import math
import os
from contextlib import nullcontext
from time import time
from typing import Optional

import numpy as np
import torch

from .allocation import MOSAP, BLUESTError
from .config import allocation_device, on_own_device
from .estimators.closed_forms import (mfmc_allocation, mfmc_check,
                                      mlmc_allocation, mlmc_bounds_batch)
from .graph import CovarianceGraph, cliques
from .linalg.spd import (mark_uncorrelated, project_covariance_full,
                         project_covariance_masked)
from .parallel.mesh import Mesh, sample_mesh
from . import profiling
from .sampling import host_engine, snapshots
from .sampling.engine import F64, zero_sums
from .sampling.group_engine import GroupEngine, factored_hooks

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
    "comm": None,                      # accepted for API compat; unused
    "remove_uncorrelated": True,
    "optimization_solver": "sdp",
    "covariance_estimation_samples": 100,
    "sample_batch_size": 1,            # black-box models: samples per call
    "samplefile": None,
    "outputs_to_save": None,
    "skip_projection": False,
    "spg_params": spg_default_params,
    "seed": 0,
    "mesh": None,                      # None | "auto" | parallel.mesh.Mesh
    "device": "cuda",                  # sampling device; "cpu" on request
    "device_batch_size": 4096,
    "max_resample": 64,                # 0 = model guaranteed finite
    "host_workers": 1,                 # >1: process pool for black-box models
    "model_workers": 1,                # >1: processes per model evaluation
    "profile_dir": None,               # torch.profiler trace dir for solve()
}


def _holds_torch_state(v) -> bool:
    """True when ``v`` is, or a dict/list/tuple holds, a torch tensor, a
    generator or a mesh with its process groups (what must not travel to
    a host worker)."""
    if isinstance(v, (torch.Tensor, torch.Generator, Mesh)):
        return True
    if isinstance(v, dict):
        return any(_holds_torch_state(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return any(_holds_torch_state(x) for x in v)
    return False


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

        # a subclass's own keys land in params beside the defaults, as in
        # the JAX package (bluest_tpu/problem.py:100-108)
        self.default_params = default_params
        self.params = default_params.copy()
        spg_params = spg_default_params.copy()
        spg_params.update(params.get("spg_params", {}))
        params["spg_params"] = spg_params
        self.params.update(params)
        self.warning = True

        mesh = self.params["mesh"]
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError("mesh must be None, \"auto\" or a mesh of "
                                 "bluest_tpu_torch.parallel, got %r" % mesh)
            many = (torch.distributed.is_available()
                    and torch.distributed.is_initialized()
                    and torch.distributed.get_world_size() > 1)
            mesh = sample_mesh() if many else None
        self.mesh = mesh
        # only the root rank of a mesh prints
        self.verbose = bool(self.params["verbose"]
                            and (mesh is None or mesh.is_root))
        self.device = torch.device(self.params["device"])
        self._engine = None
        self._call_counter = 0
        self._output_dim = None      # the model's output dimension d
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

    def evaluate(self, ls, samples, N=1):
        """Black-box evaluation: returns Ps[n][i] for output n, model ls[i]
        (reference blue_models.py:108-110).  Runs on the host."""
        raise NotImplementedError

    def sampler(self, ls, N=1):
        """Black-box input sampler (reference blue_models.py:113-115)."""
        raise NotImplementedError

    def sample_group(self, generator: torch.Generator, ls, n: int):
        """Batched coupled-group sampler: n coupled inputs for the models
        ``ls`` -- a tensor, or a tuple of tensors, with leading dimension
        n -- on ``self.device``.  Override together with evaluate_group."""
        raise NotImplementedError

    def evaluate_group(self, ls, inputs) -> torch.Tensor:
        """Batched coupled-group evaluation: (n, n_outputs, len(ls)), or
        (n, n_outputs, len(ls), d) for vector outputs."""
        raise NotImplementedError

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

    def get_comm(self):
        """Intra-group communicator for internally-parallel black-box
        models (reference blue_models.py:121-130): with
        ``params['model_workers'] > 1`` each model evaluation owns a
        group of processes and this returns its
        :class:`~bluest_tpu_torch.parallel.hostcomm.HostComm`; ``None``
        for torch models and single-process sampling."""
        return getattr(self, "_host_comm", None)

    # --------------------------- utilities ----------------------------- #

    def _has_factored_model(self) -> bool:
        cls = type(self)
        return (cls.evaluate_model is not BLUEProblem.evaluate_model
                and cls.sample_inputs is not BLUEProblem.sample_inputs)

    def _has_group_model(self) -> bool:
        cls = type(self)
        return (cls.evaluate_group is not BLUEProblem.evaluate_group
                and cls.sample_group is not BLUEProblem.sample_group)

    def _has_torch_model(self) -> bool:
        return self._has_factored_model() or self._has_group_model()

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

    def get_mlmc_variance(self, n=0):
        return self.dV[n]

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

    def get_model_graph(self, C, costs=None):
        """Model graph from a (possibly partial) covariance (reference
        blue_models.py:232-263): a CovarianceGraph with the reference's
        sentinel semantics (NaN = estimate, inf = never couple,
        0 = uncorrelated).  The optional ``costs`` are attached to the
        returned graph, not to the problem."""
        C = np.array(C, dtype=float)
        G = CovarianceGraph(C)
        if costs is not None:
            costs = np.asarray(costs, dtype=float)
            if costs.shape != (C.shape[0],):
                raise ValueError("costs must have one entry per model")
            G.costs = costs
        return G

    # ------------------------ graph manipulation ----------------------- #

    def reorder_all_graph_nodes(self, ordering=None):
        for n in range(self.n_outputs):
            self.reorder_graph_nodes(n, ordering=ordering,
                                     _part_of_all=True)

    def reorder_graph_nodes(self, n=0, ordering=None, _part_of_all=False):
        M = self.M
        if ordering is None or (isinstance(ordering, str) and "asc" in ordering):
            p = np.arange(M)
        elif isinstance(ordering, str) and "desc" in ordering:
            p = np.arange(M)[::-1]
        elif isinstance(ordering, (list, np.ndarray)) and len(ordering) == M:
            p = np.asarray(ordering, dtype=int)
        else:
            raise ValueError("ordering must be None, 'asc', 'desc' or a "
                             "permutation of the model indices")
        # costs are shared across outputs and permuted once (at n == 0):
        # only reorder_all_graph_nodes may permute a graph of a
        # multi-output problem, or one output's graph would desync from
        # the shared costs
        if (not _part_of_all and not np.array_equal(p, np.arange(M))
                and (n != 0 or self.n_outputs > 1)):
            raise ValueError(
                "reordering a single output graph (n=%d) would desync the "
                "shared model costs; use reorder_all_graph_nodes" % n)
        self.G[n].permute(p)
        # the clique-enumeration universe follows the relabeling
        self.SG[n] = list(self.G[n].component)
        self.dV[n] = _dv_fold(self.dV[n][np.ix_(p, p)])
        if n == 0:
            self.costs = self.costs[p]

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

    def _intersection_adjacency(self) -> np.ndarray:
        adj = self.G[0].clique_adjacency().copy()
        for n in range(1, self.n_outputs):
            adj &= self.G[n].clique_adjacency()
        return adj

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

    def project_covariances(self, bypass_error_check: bool = False):
        for n in range(self.n_outputs):
            self.project_covariance(n, bypass_error_check=bypass_error_check)

    @on_own_device
    def project_covariance(self, n=0, bypass_error_check: bool = False):
        """(blue_models.py:348-433): the eigenvalue clip when the
        covariance is fully known, else the masked SPG projection, which
        leaves the covariance as it is (and returns its error) when the
        error is large, unless ``bypass_error_check``, and raises when SPG
        does not converge.  As in the JAX package the large-error early
        return is gated only on ``bypass_error_check``."""
        spg_params = self.params["spg_params"]
        spd_eps = spg_params["spd_threshold"]
        C = self.get_covariance(n)

        if np.isfinite(C).all():
            C_new, err = project_covariance_full(C, spd_eps)
            if self.verbose:
                print("Covariance projected to be SPD, error:", err)
        else:
            if self.verbose:
                print("Running spectral projected gradient for covariance "
                      "projection...")
            mask = (~np.isnan(C)).astype(float)
            C_new, err, res = project_covariance_masked(
                C, mask, spd_eps=spd_eps, spg_eps=spg_params["eps"],
                maxit=spg_params["maxit"],
                max_fevals=spg_params["max_fevals"],
                lmbda_min=spg_params["lmbda_min"],
                lmbda_max=spg_params["lmbda_max"],
                history=spg_params["linesearch_history_length"])
            if res.solver_info != 0:
                raise RuntimeError("Covariance projection did not converge: "
                                   "%s" % (res,))
            if self.verbose:
                print("Covariance projected, projection error:", err)
            if err > spg_params["eps"] and not bypass_error_check:
                if self.verbose:
                    print("\nWARNING! Large covariance projection error."
                          " Model covariance may be singular; consider "
                          "removing a model. Leaving covariances as "
                          "they are (bypass with "
                          "project_covariances(bypass_error_check="
                          "True)).\n")
                return err
            C_new = mark_uncorrelated(C_new, keep_nan_mask=np.isnan(C))

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

    def __getstate__(self):
        """State for a spawned host worker (host_engine.blue_fn_parallel)
        or a saved problem: no engine, generator, mesh, allocation object
        or torch tensor travels, so a worker never initialises the card
        (or joins a process group) to unpickle a problem that has sampled
        there (the JAX package drops its device state the same way).
        Dict caches that hold tensors arrive empty, any other attribute
        that holds one arrives as None."""
        state = self.__dict__.copy()
        for k in ("_engine", "mesh", "MOSAP", "MOSAP_output"):
            state[k] = None
        state["params"] = dict(self.params, mesh=None)
        for k, v in state.items():
            if _holds_torch_state(v):
                state[k] = {} if isinstance(v, dict) else None
        return state

    def __setstate__(self, state):
        """A loaded problem keeps its graphs, costs, parameters and call
        counter and samples on one device: the engine is rebuilt at first
        use and the allocation at the next ``setup_solver``."""
        self.__dict__.update(state)
        self._engine = None
        self.mesh = None
        self.MOSAP = None
        self.MOSAP_output = None

    def _sampling_engine(self):
        """The device engine of a torch model: the group engine over a
        coupled-group model's hooks, or over a factored model's with no
        redraw."""
        if self._engine is None:
            if self._has_factored_model():
                hooks = factored_hooks(self.sample_inputs,
                                       self.evaluate_model)
                max_resample = 0
            else:
                hooks = (self.sample_group, self.evaluate_group)
                max_resample = int(self.params["max_resample"])
            self._engine = GroupEngine(
                *hooks, self.n_outputs, int(self.params["device_batch_size"]),
                self.device, max_resample=max_resample, mesh=self.mesh)
        return self._engine

    def blue_fn(self, ls, N, verbose=True, compute_mlmc_differences=False):
        """Sums over N coupled samples of group ``ls``: (sumse, sumsc,
        cost[, sumsd1, sumsd2]) in the reference layout (blue_fn.py).
        Torch models sample on the device, black-box models on the host."""
        if not self._has_torch_model():
            return self._host_blue_fn(ls, N, verbose,
                                      compute_mlmc_differences)
        key_ls = tuple(int(l) for l in ls)
        N = int(N)
        t0 = time()
        host = self._sample_groups([key_ls], [N])[0]
        wall = time() - t0
        cost = N * self.cost if hasattr(self, "cost") else wall
        if host is None:                       # N <= 0: nothing sampled
            host = [t.numpy() for t in zero_sums(self.n_outputs,
                                                  len(key_ls), "cpu")]
        return self._reference_layout(key_ls, host, cost,
                                      compute_mlmc_differences)

    def _reference_layout(self, key_ls, host, cost,
                          compute_mlmc_differences=False):
        """Host sums (se, sc, d1, d2, n_failed) of one group as blue_fn
        returns them: nested lists per output and model."""
        k, No = len(key_ls), self.n_outputs
        se, sc, d1, d2, _ = host
        if se.shape[-1] == 1:
            se, d1 = se[..., 0], d1[..., 0]    # scalar outputs
        sumse = [[se[n, i] for i in range(k)] for n in range(No)]
        sumsc = [sc[n] for n in range(No)]
        if compute_mlmc_differences:
            sumsd1 = [[[d1[n, i, j] for j in range(k)] for i in range(k)]
                      for n in range(No)]
            sumsd2 = [[[d2[n, i, j] for j in range(k)] for i in range(k)]
                      for n in range(No)]
            return sumse, sumsc, cost, sumsd1, sumsd2
        return sumse, sumsc, cost

    def _host_blue_fn(self, ls, N, verbose, compute_mlmc_differences):
        """Black-box models: the host engine, serial or in a process pool
        of ``host_workers`` (x ``model_workers``) spawned workers."""
        # under a mesh the host models run redundantly on every rank (same
        # seed, same samples) and the root alone writes the snapshot file
        samplefile = (self.params["samplefile"]
                      if self.mesh is None or self.mesh.is_root else None)
        n_workers = int(self.params["host_workers"])
        model_workers = int(self.params["model_workers"])
        if n_workers > 1 or model_workers > 1:
            return host_engine.blue_fn_parallel(
                ls, N, self, n_workers, No=self.n_outputs,
                compute_mlmc_differences=compute_mlmc_differences,
                model_workers=model_workers, filename=samplefile,
                outputs_to_save=self.params["outputs_to_save"])
        return host_engine.blue_fn(
            ls, N, self, sampler=self.sampler,
            inners=self.get_models_inner_products(),
            N1=self.params["sample_batch_size"], No=self.n_outputs,
            verbose=self.verbose and verbose,
            compute_mlmc_differences=compute_mlmc_differences,
            filename=samplefile,
            outputs_to_save=self.params["outputs_to_save"])

    def _device_sums(self, calls):
        """Device sums of sampling calls, dispatched in order and not
        fetched: each call ``(key_ls, N > 0, counter, first_chunk,
        sink)`` samples N rows of group ``key_ls`` from the chunks
        ``first_chunk, first_chunk + 1, ...`` of call ``counter`` (the
        group engine runs the calls' chunks as one sequence).  With a
        ``samplefile`` the rows also go to the snapshot file (through
        ``sink`` when the caller owns one), call by call.  One sums a
        call: under a mesh this rank's partial sums, None where it holds
        no chunk."""
        samplefile = self.params["samplefile"]
        if samplefile is None:
            return self._sampling_engine().sample_calls(
                self.params["seed"],
                [(ls, counter, N, first) for ls, N, counter, first, _sink
                 in calls])
        return [self._collect_run(ls, counter, N, samplefile, sink, first)
                for ls, N, counter, first, sink in calls]

    # snapshot collection holds a piece's outputs and inputs on the device
    # until its one host copy; bound that allocation by collecting a
    # call's rows in pieces of this many samples (whole chunks)
    _COLLECT_CHUNK = 1 << 18
    # runs projected above this many bytes of collected rows switch from
    # accumulate-on-host to an asynchronous disk spool (SnapshotSpool).
    # Env override BLUEST_TPU_SNAPSHOT_SPILL_MB (0 disables spilling).
    _COLLECT_SPILL_BYTES = 256 << 20

    def _collect_spill_bytes(self):
        mb = os.environ.get("BLUEST_TPU_SNAPSHOT_SPILL_MB")
        if mb is not None:
            try:
                v = float(mb)
            except ValueError:     # malformed: keep the default, don't
                v = None           # abort a long sampling run mid-flight
            if v is not None:
                return v * 2 ** 20 if v > 0 else float("inf")
        return float(self._COLLECT_SPILL_BYTES)

    def _collect_sink(self, key_ls, N, samplefile):
        """Accumulate-or-spill sink for snapshot collection; the spool
        lives next to the samplefile (the system temp dir is often
        RAM-backed, which would defeat the memory bound).  Under a mesh
        every rank takes part in the gather of the rows (a collective)
        and the root alone accumulates and writes them: concurrent
        appends to one npz on a shared file system race (the reference's
        rank-0 merge, blue_fn.py:189-222)."""
        if self.mesh is not None and not self.mesh.is_root:
            return snapshots.NullSink()
        sdir = os.path.dirname(os.path.abspath(samplefile)) or None
        return snapshots.CollectSink(
            self.n_outputs, len(key_ls), N, self._collect_spill_bytes,
            outputs_to_save=self.params["outputs_to_save"], tmpdir=sdir)

    def _collect_run(self, key_ls, counter, N, samplefile, sink=None,
                     first_chunk=0):
        """Sampling with snapshot collection, for either engine, in pieces
        of about ``_COLLECT_CHUNK`` samples (whole chunks; one device ->
        host copy of the rows each, so neither the card nor the host holds
        more than a piece outside the sink).  The pieces go on through the
        chunk streams of the call and fold into one running sum, so the
        sums equal those of the same call without a samplefile.  The
        finite rows -- for the group engine the accepted draws' inputs --
        go to the sink, under a mesh gathered from all ranks in chunk
        order.  With an external ``sink`` the caller owns the write and
        close."""
        engine = self._sampling_engine()
        piece = max(self._COLLECT_CHUNK // engine.batch, 1) * engine.batch
        total = None
        own = sink is None
        if own:
            sink = self._collect_sink(key_ls, N, samplefile)
        try:
            for base in range(0, N, piece):
                n_c = min(piece, N - base)
                total, vals, inputs, valid = engine.collect(
                    key_ls, self.params["seed"], counter, n_c,
                    first_chunk=first_chunk + base // engine.batch,
                    acc=total)
                if vals is not None:
                    with profiling.host_sync("collect"):
                        vals = vals[valid]
                    with profiling.host_sync("collect"):
                        inputs = inputs[valid]
                if self.mesh is not None:
                    with profiling.host_sync("collect"):
                        vals, inputs = (self.mesh.fetch_rows(t)
                                        for t in (vals, inputs))
                with profiling.host_sync("collect"):
                    vals = vals.cpu().numpy()
                if vals.ndim == 4 and vals.shape[-1] == 1:
                    vals = vals[..., 0]
                with profiling.host_sync("collect"):
                    inputs = inputs.cpu().numpy()
                sink.add(vals, inputs, n_c)
            if own:
                sink.write(samplefile, key_ls)
        finally:
            if own:
                sink.close()
        return total

    # the sampling of several groups: dispatch all, then fetch once

    def _dispatch_all(self, group_list, n_list):
        """Dispatch the sampling of every (group, N > 0) in list order --
        the call counter, hence the streams, are those of one blue_fn call
        per group -- without fetching anything.  Returns one record per
        group (None for N <= 0): its models, N, call counter, the chunks
        its call has used so far and its sums on the device."""
        out = []
        batch = int(self.params["device_batch_size"])
        for g, n in zip(group_list, n_list):
            n = int(n)
            if n <= 0:
                out.append(None)
                continue
            out.append({"ls": tuple(int(l) for l in g), "N": n,
                        "counter": self._call_counter,
                        "chunks": math.ceil(n / batch), "sink": None})
            self._call_counter += 1
        live = [d for d in out if d is not None]
        for d, sums in zip(live, self._device_sums(
                [(d["ls"], d["N"], d["counter"], 0, None) for d in live])):
            d["sums"] = sums
        return out

    def _sums_to_host(self, flat: torch.Tensor) -> np.ndarray:
        """The one device -> host copy of a fetch round."""
        return flat.cpu().numpy()

    def _batch_fetch_sums(self, dispatched):
        """One fetch for the sums of every dispatched group: one flat f64
        tensor (counts below 2^53 are exact in f64), under a mesh one
        ``all_reduce`` of it over the sample ranks, one copy to the host.
        Returns host sums [se, sc, d1, d2, n_failed] aligned with
        ``dispatched`` (None entries preserved).  Takes this rank's rows
        that stayed non-finite off the counter ``rows.kept``, to which
        the engine added the rows of this rank's chunks: under a mesh the
        copy also carries this rank's own count of them.  Under a mesh
        the span ``mesh.fetch`` holds the ``all_reduce`` and the copy
        that waits for it, hence for the slowest rank."""
        live = [d for d in dispatched if d is not None]
        if not live:
            return [None] * len(dispatched)
        with profiling.span("sample.fetch", groups=len(live)) as sp:
            if self.mesh is not None and self._output_dim is None:
                # a rank that held no chunk yet has not seen the model's
                # output dimension, which sizes its zeros: agree on it once
                d = max([x["sums"].sumse.shape[-1] for x in live
                         if x["sums"] is not None], default=0)
                with profiling.host_sync("fetch"):
                    self._output_dim = int(self.mesh.all_reduce_samples(
                        torch.tensor([d], device=self.device), op="max")[0])
            with profiling.span("sample.pack"):
                sums = [x["sums"] if x["sums"] is not None
                        else zero_sums(self.n_outputs, len(x["ls"]),
                                       self.device, self._output_dim)
                        for x in live]
                flat = torch.cat([t.reshape(-1).to(F64)
                                  for s in sums for t in s])
            own_failed = None   # this rank's non-finite rows, under a mesh
            if self.mesh is None:
                with profiling.host_sync("fetch"):
                    flat = self._sums_to_host(flat)
            else:
                with profiling.span("mesh.fetch"):
                    own = torch.stack([s.n_failed for s in sums]).sum()
                    flat = self.mesh.all_reduce_samples(flat)
                    flat = torch.cat([flat, own.to(flat).reshape(1)])
                    with profiling.host_sync("fetch"):
                        flat = self._sums_to_host(flat)
                own_failed, flat = int(flat[-1]), flat[:-1]
            if sp is not None:
                sp.attrs["bytes"] = flat.nbytes
            with profiling.span("sample.unpack"):
                fetched, off = [], 0
                for s in sums:
                    parts = []
                    for t in s:
                        parts.append(flat[off:off + t.numel()].reshape(
                            tuple(t.shape)))
                        off += t.numel()
                    parts[-1] = int(parts[-1])
                    fetched.append(parts)
            profiling.count("rows.kept", -(sum(f[-1] for f in fetched)
                                           if own_failed is None
                                           else own_failed))
        fetched = iter(fetched)
        return [None if d is None else next(fetched) for d in dispatched]

    def _attribute_batch_wall(self, dispatched, wall):
        """Distribute the shared dispatch-and-fetch wall across the
        dispatched groups pro rata by sample count (the sums arrive in one
        fetch, so no per-group wall exists to measure)."""
        total = sum(d["N"] for d in dispatched if d is not None)
        for d in dispatched:
            if d is None:
                continue
            st = self.sampling_stats.setdefault(
                d["ls"], {"samples": 0, "wall_s": 0.0})
            st["samples"] += d["N"]
            st["wall_s"] += wall * d["N"] / total

    def _sample_groups(self, group_list, n_list):
        """Host sums [se, sc, d1, d2, n_failed] of every (group, N), None
        for N <= 0: all groups dispatched, then fetched at once.

        Non-finite samples are masked out of the sums, but the estimators
        divide by the requested N: after the fetch, the groups that lost
        samples draw the deficit from the next chunks of their own call
        (no new call counter, so a group's sums do not depend on which
        groups were sampled with it) and the top-ups are fetched together
        again, for at most 4 rounds (the reference resamples until all N
        are finite, blue_fn.py:118-129).  The top-up rows reach the
        snapshot file too, through one sink per group for all rounds.
        Under a mesh every rank holds the same sums after a fetch and so
        takes the same decisions."""
        with profiling.span("sample",
                            groups=sum(int(n) > 0 for n in n_list)) as sp:
            t0 = time()
            samplefile = self.params["samplefile"]
            batch = int(self.params["device_batch_size"])
            disp = self._dispatch_all(group_list, n_list)
            host = self._batch_fetch_sums(disp)
            rounds = 1
            try:
                for _ in range(4):
                    again = [i for i, h in enumerate(host)
                             if h is not None and h[-1] > 0]
                    if not again:
                        break
                    calls = []
                    for i in again:
                        d, deficit = disp[i], host[i][-1]
                        if samplefile is not None and d["sink"] is None:
                            d["sink"] = self._collect_sink(d["ls"], deficit,
                                                           samplefile)
                        calls.append((d["ls"], deficit, d["counter"],
                                      d["chunks"], d["sink"]))
                        d["chunks"] += math.ceil(deficit / batch)
                    for i, sums in zip(again, self._device_sums(calls)):
                        disp[i]["sums"] = sums
                    extra = self._batch_fetch_sums(
                        [d if i in again else None
                         for i, d in enumerate(disp)])
                    rounds += 1
                    for i in again:
                        host[i] = [a + b for a, b in zip(host[i][:-1],
                                                         extra[i][:-1])] \
                            + [extra[i][-1]]
                for d in disp:
                    if d is not None and d["sink"] is not None:
                        d["sink"].write(samplefile, d["ls"])
            finally:
                for d in disp:
                    if d is not None and d["sink"] is not None:
                        d["sink"].close()
            if sp is not None:
                sp.attrs["fetch_rounds"] = rounds
        self._attribute_batch_wall(disp, time() - t0)
        for h in host:
            if h is not None and h[-1] > 0 and self.verbose:
                print("WARNING! %d samples non-finite after retries "
                      "(dropped)" % h[-1])
        return host

    def _pipelined_sumse(self, group_list, n_list):
        """Per-(group, N) sumse, None for N == 0: torch models dispatch
        every group before the one fetch (``_sample_groups``); black-box
        models keep the host engine's progress per level."""
        if not self._has_torch_model():
            return [self.blue_fn(g, int(n))[0] if n > 0 else None
                    for g, n in zip(group_list, n_list)]
        host = self._sample_groups(group_list, n_list)
        with profiling.span("estimate.sums"):
            return [None if h is None
                    else self._reference_layout(g, h, None)[0]
                    for g, h in zip(group_list, host)]

    # ----------------------------- solvers ----------------------------- #

    @on_own_device
    def prewarm_solver(self, K=4, background=False, budget=None,
                       max_model_samples=None):
        """Build the allocation structure (groups, psi assembly) that a
        later ``setup_solver(K=...)`` will use, so that call reuses it,
        and return its group count L.  The JAX package also traces and
        compiles its cone programs here; eager PyTorch has nothing to
        compile, so ``background``, ``budget`` and ``max_model_samples``
        are accepted and unused."""
        del background, budget, max_model_samples
        return self._ensure_mosap(K, None).L

    @profiling.traced("alloc.structure",
                      after=lambda mosap, *a, **k: {"L": mosap.L})
    def _ensure_mosap(self, K, multi_groups):
        """Build (or reuse from the structure cache) the MOSAP for this
        group configuration, on the allocation device (its callers run
        in the problem's allocation scope)."""
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
        cache_key = (str(allocation_device()), K, tuple(Ks),
                     tuple(np.asarray(Cn).tobytes() for Cn in C),
                     repr(groups), repr(multi_groups), costs.tobytes())
        if getattr(self, "_mosap_key", None) != cache_key \
                or self.MOSAP is None:
            self.MOSAP = MOSAP(C, K, Ks, groups, multi_groups, costs,
                               multi_costs, verbose=self.verbose)
            self._mosap_key = cache_key
        return self.MOSAP

    @on_own_device
    def setup_solver(self, K=4, budget=None, eps=None, groups=None,
                     multi_groups=None, solver=None,
                     continuous_relaxation=False, max_model_samples=None,
                     optimization_solver_params=None):
        """(blue_models.py:448-538)"""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if budget is not None and eps is not None:
            eps = None
        if budget is not None and (not np.isfinite(budget) or budget <= 0):
            raise ValueError("budget must be finite and positive, got %s"
                             % budget)
        if eps is not None and np.isscalar(eps):
            eps = [float(eps)] * self.n_outputs
        if eps is not None and any(not np.isfinite(e) or e <= 0
                                   for e in eps):
            raise ValueError("eps tolerances must be finite and positive, "
                             "got %s" % (eps,))
        if multi_groups is None and groups is None and K < 1:
            raise ValueError("K must be >= 1, got %s" % K)
        if solver is None:
            solver = self.params["optimization_solver"]
        if multi_groups is not None and len(multi_groups) != self.n_outputs:
            raise ValueError("multi_groups must have one grouping per output")
        if groups is not None and multi_groups is None:
            multi_groups = [groups for _ in range(self.n_outputs)]

        with profiling.span("setup_solver", K=K, budget=budget, eps=eps,
                            solver=solver):
            self._ensure_mosap(K, multi_groups)
            self.MOSAP.solve(budget=budget, eps=eps, solver=solver,
                             continuous_relaxation=continuous_relaxation,
                             max_model_samples=max_model_samples,
                             solver_params=optimization_solver_params)
            if self.mesh is not None:
                # every rank solved the same allocation, but the integer
                # cleanup turns on 1e-15 changes of its input: take the root's,
                # so that no rank can sample another allocation
                m = self.MOSAP
                m.samples, m.continuous_solution, m.tot_cost = \
                    self.mesh.broadcast_from_root(
                        (m.samples, m.continuous_solution, m.tot_cost))
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

            self.MOSAP_output = {
                "budget": budget, "eps": eps, "samples": self.MOSAP.samples,
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
            which_groups = [self.MOSAP_output["flattened_groups"][i]
                            for i in sel]
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
        every active group on the device, BLUE estimators.  A call is one
        request of the span recorder, under its root span ``solve``
        (``profiling.py``); ``profile_dir`` turns the recorder on for the
        call where it is off."""
        trace_dir = self.params["profile_dir"]
        own = bool(trace_dir) and not profiling.recording
        if own:
            profiling.enable_spans()
        try:
            with profiling.span("solve", K=K, budget=budget, eps=eps) as sp:
                return self._solve(
                    sp, trace_dir, K, budget, eps, groups, multi_groups,
                    solver, verbose, continuous_relaxation,
                    max_model_samples, optimization_solver_params)
        finally:
            if own:
                profiling.disable_spans()

    def _solve(self, sp, trace_dir, K, budget, eps, groups, multi_groups,
               solver, verbose, continuous_relaxation, max_model_samples,
               optimization_solver_params):
        if solver is None:
            solver = self.params["optimization_solver"]
        need_setup = self.MOSAP_output is None
        if not need_setup:
            if budget is not None and budget != self.MOSAP_output["budget"]:
                need_setup = True
            if eps is not None and not np.all(
                    np.atleast_1d(eps) == np.atleast_1d(
                        self.MOSAP_output["eps"] if self.MOSAP_output["eps"]
                        is not None else np.nan)):
                need_setup = True
        if need_setup:
            self.setup_solver(K=K, budget=budget, eps=eps, groups=groups,
                              multi_groups=multi_groups, solver=solver,
                              continuous_relaxation=continuous_relaxation,
                              max_model_samples=max_model_samples,
                              optimization_solver_params=optimization_solver_params)
        elif budget is None and eps is None and self.MOSAP_output["cost"] is None:
            raise ValueError("Need to prescribe either a budget or a "
                             "tolerance to run the BLUE estimator")

        if self.verbose and verbose:
            print("\nSampling BLUE...\n")

        flattened_groups = self.MOSAP_output["flattened_groups"]
        sample_list = self.MOSAP_output["samples"]
        n_active = int(sum(1 for N in sample_list if N > 0))
        total_N = int(sum(int(N) for N in sample_list))
        if sp is not None:
            sp.attrs.update(groups=n_active, samples=total_N)
        done_groups = 0
        done_N = 0
        t0 = time()
        sums = [[] for _ in range(self.n_outputs)]
        pipelined = self._has_torch_model()
        with profiling.device_trace(trace_dir) if trace_dir else nullcontext():
            # torch models: every group is dispatched before the one fetch
            # of all their sums; black-box models sample group by group
            sumse_list = (self._pipelined_sumse(flattened_groups, sample_list)
                          if pipelined else None)
            # the pipelined path laid out every group's sums: gather them
            # for the estimator (black-box models sample in this loop)
            with (profiling.span("estimate.sums") if pipelined
                  else profiling.OFF):
                for gi, (ls, N) in enumerate(zip(flattened_groups,
                                                 sample_list)):
                    if N == 0:
                        for n in range(self.n_outputs):
                            sums[n].append([0 for _ in range(len(ls))])
                        continue
                    if pipelined:
                        sumse = sumse_list[gi]
                    else:
                        sumse, _, _ = self.blue_fn(ls, int(N),
                                                   verbose=verbose)
                    for n in range(self.n_outputs):
                        sums[n].append(sumse[n])
                    done_groups += 1
                    done_N += int(N)
                    if self.verbose and verbose:
                        print("  group %s: %d samples | %d/%d groups, %d/%d "
                              "samples" % (list(ls), int(N), done_groups,
                                           n_active, done_N, total_N),
                              flush=True)
            if self.verbose and verbose and total_N:
                wall = max(time() - t0, 1e-9)
                print("  estimation: %d samples in %.2fs (%.0f samples/s)"
                      % (total_N, wall, total_N / wall), flush=True)

            mus, Vs = self.MOSAP.compute_BLUE_estimators(sums, sample_list)
        errs = np.sqrt(Vs)
        return mus, errs, self.MOSAP_output["cost"]

    # ------------------------------ MLMC -------------------------------- #

    def _mlmc_level_data(self, group, n):
        """Telescoped variances/costs for one chain (blue_models.py:688-704)."""
        C = self.get_covariance(n)
        w = self.get_costs()
        subC = C[np.ix_(group, group)]
        subw = w[list(group)].copy()
        if len(group) > 1:
            v = np.diag(subC).copy()
            corrs = np.diag(subC, 1)
            v[:-1] += v[1:] - 2 * corrs
            for i in range(len(group) - 1):
                ii, jj = min(group[i], group[i + 1]), max(group[i], group[i + 1])
                check = self.dV[n][ii, jj]
                if np.isfinite(check):
                    v[i] = check
            subw[:-1] += subw[1:]
        else:
            v = np.array([subC[0, 0]])
        return v, subw

    def _mlmc_chains(self, max_chains: int = 1 << 17):
        """All cost-descending chains through the intersection graph that
        start at model 0 (blue_models.py:662-670).

        The reference enumerates every subset containing model 0 (2^(M-1)
        of them) and filters by path feasibility.  A chain is a
        cost-descending sequence whose consecutive pairs are edges, so the
        same set falls out of a DFS over descending-cost positions that
        abandons a prefix as soon as an edge is missing -- exponentially
        cheaper on sparse coupling graphs, identical output on dense ones.

        Dense graphs past M ~ 17 models would still enumerate 2^(M-1)
        chains; the count is capped at ``max_chains`` (longest/cheapest
        prefixes are explored first by the DFS order) with a warning, so
        setup_mlmc degrades to a wide heuristic search instead of hanging.
        """
        lme = len(self.check_costs(warning=True))
        w = self.get_costs()
        # stable descending sort: reversing an ascending argsort reverses
        # tie order too, so a model tying model 0's cost could land first
        # and trip the assert nondeterministically
        idx = np.argsort(-w, kind="stable")[lme:]
        assert idx[0] == 0
        adj = self._intersection_adjacency()
        n = len(idx)
        groups = []
        stack = [[0]]
        while stack:
            path = stack.pop()
            groups.append([int(idx[p]) for p in path])
            if len(groups) >= max_chains:
                if self.verbose:
                    print("WARNING! MLMC chain enumeration capped at %d "
                          "chains (M = %d is large for a dense coupling "
                          "graph); the chain search is now a heuristic."
                          % (max_chains, self.M))
                break
            last = path[-1]
            for j in range(last + 1, n):
                if adj[idx[last], idx[j]]:
                    stack.append(path + [j])
        return groups

    def _mlmc_level_data_batch(self, G, mask, lengths, n):
        """Vectorized _mlmc_level_data over a padded chain batch.

        G: (B, Lmax) model indices (padded entries 0); mask: validity;
        lengths: (B,) chain lengths.  Returns V, W: (B, Lmax) with the
        same per-level semantics as _mlmc_level_data (pairwise difference
        variances with dV overrides, pairwise costs, singleton tail)."""
        C = self.get_covariance(n)
        w = self.get_costs()
        dV = self.dV[n]
        B, Lmax = G.shape
        Cd = np.diag(C)
        gi = G
        gj = np.concatenate([G[:, 1:], G[:, :1]], axis=1)  # next level
        pair = np.concatenate([mask[:, 1:], np.zeros((B, 1), bool)], axis=1) \
            & mask                                          # l < len-1
        lo = np.minimum(gi, gj)
        hi = np.maximum(gi, gj)
        v_pair = Cd[gi] + Cd[gj] - 2 * C[gi, gj]
        dv = dV[lo, hi]
        v = np.where(np.isfinite(dv), dv, v_pair)
        V = np.where(pair, v, 0.0)
        W = np.where(pair, w[gi] + w[gj], 0.0)
        last = (np.arange(Lmax)[None, :] == (lengths - 1)[:, None])
        V = np.where(last, Cd[gi], V)
        W = np.where(last, w[gi], W)
        return V, W

    def setup_mlmc(self, budget=None, eps=None, continuous_relaxation=False):
        """(blue_models.py:642-741)"""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if budget is not None and eps is not None:
            eps = None
        if eps is not None and np.isscalar(eps):
            eps = [float(eps)] * self.n_outputs
        if eps is None:
            eps = [None] * self.n_outputs

        if self.verbose:
            print("Setting up optimal MLMC estimator...\n")
        if not any(np.isfinite(dVn).any() for dVn in self.dV):
            if self.verbose:
                print("Warning! MLMC variances were not provided nor "
                      "estimated; the MLMC estimator may be suboptimal.\n")

        w = self.get_costs()

        # Pass 1 -- continuous lower bounds, batched over all chains at
        # once (padded (n_chains, Lmax) arrays; see mlmc_bounds_batch for
        # why the eps-mode bound uses the unclamped cost deflated by the
        # integer slack).  Rank chains by max-over-outputs of the bound and
        # stop the expensive corner searches of pass 2 once the bound can
        # no longer beat the incumbent -- exact, not a heuristic.
        chains = self._mlmc_chains()
        B = len(chains)
        Lmax = max(len(g) for g in chains)
        G = np.zeros((B, Lmax), dtype=np.int64)
        mask = np.zeros((B, Lmax), dtype=bool)
        lengths = np.array([len(g) for g in chains])
        for b, g in enumerate(chains):
            G[b, :len(g)] = g
            mask[b, :len(g)] = True
        Vb, Wb = [], []
        bound_all = np.zeros(B)
        feas_all = np.ones(B, dtype=bool)
        # eps-mode bound must be in the SAME cost units as the pass-2
        # incumbent objective: the allocation optimizes pair costs (Wb),
        # but the selection objective and reported total_cost use raw
        # per-model costs (reference convention, blue_models.py:717/726
        # -- kept for paper-golden comparability).  Any variance-feasible
        # schedule's raw cost is bounded below by the raw-cost continuous
        # optimum, so bounding with W_raw keeps the pruning exact.
        Wraw = np.where(mask, w[G], 0.0)
        for n in range(self.n_outputs):
            Vn, Wn = self._mlmc_level_data_batch(G, mask, lengths, n)
            Vb.append(Vn)
            Wb.append(Wn)
            feas_n, bound_n = mlmc_bounds_batch(
                Vn, Wn if budget is not None else Wraw, mask,
                budget=budget, eps=eps[n])
            feas_all &= feas_n & np.isfinite(bound_n)
            bound_all = np.maximum(bound_all, bound_n)
        order = np.argsort(np.where(feas_all, bound_all, np.inf))

        # Pass 2 -- full (integer unless relaxed) allocation in bound order.
        best_group, best_data = None, None
        best_obj = np.inf
        for b in order:
            if not feas_all[b]:
                break
            if bound_all[b] >= best_obj:
                break
            group = chains[b]
            data_list = []
            feasible = True
            for n in range(self.n_outputs):
                v = Vb[n][b, :lengths[b]]
                subw = Wb[n][b, :lengths[b]]
                feasible, data = mlmc_allocation(
                    v, subw, budget=budget, eps=eps[n],
                    continuous_relaxation=continuous_relaxation)
                if not feasible:
                    break
                data_list.append(data)
            if not feasible:
                continue
            if budget is not None:
                obj = max(d["error"] for d in data_list)
            else:
                obj = np.max(np.vstack([d["samples"] for d in data_list]),
                             axis=0) @ w[list(group)]
            if obj < best_obj:
                best_obj, best_group, best_data = obj, group, data_list

        if best_group is None:
            raise BLUESTError("No feasible MLMC chain found")

        samples = np.max(np.vstack([d["samples"] for d in best_data]), axis=0)
        cost = samples @ w[list(best_group)]
        if budget is not None:
            # The per-output schedules each fit the budget, but their
            # element-wise max may not; shrink back onto
            # {m >= 1, m @ w <= budget} by rescaling the free levels (MLMC
            # variance is homogeneous of degree -1 in m, so a uniform
            # rescale degrades every output's error by the same
            # sqrt(cost/budget) factor).  The reference's single additive
            # -w step (blue_models.py:735-738) can dump the whole
            # reduction on a level that is then clamped at 1, leaving the
            # cost far above budget.
            wg = w[list(best_group)]
            m = samples.astype(float)
            for _ in range(len(m) + 1):
                if m @ wg <= budget * (1 + 1e-12):
                    break
                free = m > 1.0
                if not free.any():
                    break
                fixed = m[~free] @ wg[~free]
                scale = (budget - fixed) / (m[free] @ wg[free])
                m[free] = np.maximum(m[free] * max(scale, 0.0), 1.0)
            samples = np.maximum(np.floor(m).astype(np.int64), 1)
            cost = samples @ wg
        errs = [np.sqrt(d["variance"](samples)) for d in best_data]
        mlmc_data = {"models": best_group, "samples": samples,
                     "errors": errs, "total_cost": cost}
        if self.verbose:
            print("Best MLMC estimator found. Coupled models:", best_group,
                  " Max error:", max(errs), " Cost:", cost, "\n")
        return mlmc_data

    def compute_mlmc_data(self, group, samples):
        """User-prescribed MLMC schedule (blue_models.py:578-639)."""
        samples = np.asarray(samples)
        w = self.get_costs()
        adj = self._intersection_adjacency()
        if not cliques.has_path_edges(adj, group):
            raise ValueError("Group given is not compatible with MLMC.")
        if group[0] != 0:
            raise ValueError("The high-fidelity model must lead the group")
        errs = np.zeros(self.n_outputs)
        mlmc_costs = np.zeros(self.n_outputs)
        for n in range(self.n_outputs):
            v, subw = self._mlmc_level_data(group, n)
            pos = samples > 0
            # RMSE, matching setup_mlmc's "errors" units.  The reference
            # returns the VARIANCE here (blue_models.py:633) but the RMSE
            # from setup_mlmc (blue_models.py:732) -- the same key in two
            # different units depending on the path (documented
            # divergence).
            errs[n] = np.sqrt(np.sum(v[pos] / samples[pos]))
            # raw per-model costs, matching setup_mlmc's "total_cost"
            # (the paper-golden convention, blue_models.py:726); the
            # reference prices THIS path with pair costs subw
            # (blue_models.py:635) -- same key, different units again.
            del subw
            mlmc_costs[n] = samples @ w[list(group)]
        return {"models": group, "samples": samples, "errors": errs,
                "total_cost": max(mlmc_costs)}

    def solve_mlmc(self, budget=None, eps=None, mlmc_data=None):
        """(blue_models.py:743-769)"""
        if mlmc_data is None:
            mlmc_data = self.setup_mlmc(budget=budget, eps=eps)
        best_group = mlmc_data["models"]
        samples = np.round(mlmc_data["samples"]).astype(np.int64)
        errs = mlmc_data["errors"]
        tot_cost = mlmc_data["total_cost"]

        if self.verbose:
            print("\nSampling optimal MLMC estimator...\n")
        Lg = len(best_group)
        groups = [list(pair) for pair in zip(best_group[:-1],
                                             best_group[1:])]
        groups += [[best_group[-1]]]
        mu = [0 for _ in range(self.n_outputs)]
        n_list = [int(samples[i]) for i in range(Lg)]
        sumse_list = self._pipelined_sumse(groups, n_list)
        for i in range(Lg):
            N, sumse = n_list[i], sumse_list[i]
            if N == 0:
                continue
            for n in range(self.n_outputs):
                if i < Lg - 1:
                    mu[n] = mu[n] + (sumse[n][0] - sumse[n][1]) / N
                else:
                    mu[n] = mu[n] + sumse[n][0] / N
        return mu, errs, tot_cost

    # ------------------------------ MFMC -------------------------------- #

    def setup_mfmc(self, budget=None, eps=None, continuous_relaxation=False,
                   small_budget=False):
        """(blue_models.py:795-865)"""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if budget is not None and eps is not None:
            eps = None
        if eps is not None and np.isscalar(eps):
            eps = [float(eps)] * self.n_outputs
        if eps is None:
            eps = [None] * self.n_outputs

        sigmas = [np.sqrt(np.diag(self.get_covariance(n)))
                  for n in range(self.n_outputs)]
        rhos = [self.get_correlation(n)[0, :] for n in range(self.n_outputs)]
        w = self.get_costs()
        if self.verbose:
            print("Setting up optimal MFMC estimator...\n")

        adj = self._intersection_adjacency()
        clique_list = [c for c in cliques.enumerate_cliques(adj, self.M)
                       if 0 in c]
        best_group, best_data = None, None
        min_err, min_cost = np.inf, np.inf
        for clique in clique_list:
            clique = sorted(clique)
            data_list = []
            feasible = True
            for n in range(self.n_outputs):
                feasible, data = mfmc_allocation(
                    sigmas[n][clique], rhos[n][clique], w[clique],
                    budget=budget, eps=eps[n],
                    continuous_relaxation=continuous_relaxation,
                    small_budget=small_budget)
                if not feasible:
                    break
                data_list.append(data)
            if not feasible:
                continue
            # schedules and alphas live in |rho|-DESCENDING order (the
            # order MFMC's nesting theory is stated in).  The shared
            # schedule (element-wise max) is only meaningful when every
            # output sorts the clique the same way; the reference merges
            # and prices them in clique order regardless -- silently
            # assigning counts to the wrong models whenever the orders
            # differ (reference blue_models.py:849-856).  Here the group
            # is emitted in a common order: when outputs disagree
            # (near-ties in |rho|, typically), each output's preferred
            # order is tried as the FORCED common order -- the MFMC
            # variance formula is exact for any order, so a forced order
            # whose schedule passes the exact variance/budget validation
            # is still a true MFMC estimator.  Only a clique with no
            # feasible common ordering is skipped.
            order = data_list[0]["order"]
            if any(not np.array_equal(d["order"], order)
                   for d in data_list[1:]):
                best_alt = None
                seen = set()
                for d in data_list:
                    cand = tuple(int(j) for j in d["order"])
                    if cand in seen:
                        continue
                    seen.add(cand)
                    alt = []
                    for n in range(self.n_outputs):
                        okc, dd = mfmc_allocation(
                            sigmas[n][clique], rhos[n][clique], w[clique],
                            budget=budget, eps=eps[n],
                            continuous_relaxation=continuous_relaxation,
                            small_budget=small_budget,
                            order=np.asarray(cand))
                        if not okc:
                            alt = None
                            break
                        alt.append(dd)
                    if alt is None:
                        continue
                    # validate at the MERGED schedule: under a forced
                    # order the variance is increasing in any inverted
                    # coordinate, so the element-wise max can RAISE an
                    # output's variance above its own schedule's -- a
                    # candidate is only acceptable if every output's
                    # tolerance still holds at the merge
                    m_mg = np.max(np.vstack([dd["samples"]
                                             for dd in alt]), axis=0)
                    vs = [dd["variance"](m_mg) for dd in alt]
                    if budget is not None:
                        objv = max(np.sqrt(max(v, 0.0)) for v in vs)
                    else:
                        if any(v > 1.0001 * eps[n] ** 2
                               for n, v in enumerate(vs)):
                            continue
                        objv = m_mg @ w[[clique[j] for j in cand]]
                    if best_alt is None or objv < best_alt[0]:
                        best_alt = (objv, alt, np.asarray(cand))
                if best_alt is None:
                    if self.verbose:
                        print("MFMC: skipping clique %s (no feasible "
                              "common ordering)" % (clique,))
                    continue
                _, data_list, order = best_alt
            sorted_clique = [clique[j] for j in order]
            # rank cliques AT THE MERGED SCHEDULE (what solve_mfmc will
            # actually run).  Per-output own-schedule errors are only an
            # upper bound for consistent-order cliques (the merge adds
            # samples, lowering every variance) but UNDERESTIMATE a
            # rescued clique, where the forced order makes the variance
            # increasing in inverted coordinates -- ranking by them let
            # an optimistic rescued clique beat a genuinely better
            # consistent one.
            m_mg = np.max(np.vstack([d["samples"] for d in data_list]),
                          axis=0)
            if budget is not None:
                err = max(np.sqrt(max(d["variance"](m_mg), 0.0))
                          for d in data_list)
                if err < min_err:
                    min_err = err
                    best_group, best_data = sorted_clique, data_list
            else:
                cost = m_mg @ w[sorted_clique]
                if cost < min_cost:
                    min_cost = cost
                    best_group, best_data = sorted_clique, data_list

        if best_group is None:
            raise BLUESTError("No feasible MFMC clique found")

        samples = np.max(np.vstack([d["samples"] for d in best_data]), axis=0)
        cost = samples @ w[best_group]
        if budget is not None:
            wg = w[best_group]
            samples = np.floor(samples - (max(cost - budget, 0)
                                          / (wg @ wg)) * wg).astype(np.int64)
            # the additive correction can floor later entries to zero or
            # break the m_1 <= m_2 <= ... nesting solve_mfmc divides by;
            # clamp to one sample and restore monotonicity (the reference
            # only clamps samples[0], leaving divide-by-zero NaN means)
            samples = np.maximum.accumulate(np.maximum(samples, 1))
            cost = samples @ wg
        errs = [np.sqrt(d["variance"](samples)) for d in best_data]
        alphas = [d["alphas"] for d in best_data]
        mfmc_data = {"models": best_group, "samples": samples,
                     "errors": errs, "total_cost": cost, "alphas": alphas}
        if self.verbose:
            print("Best MFMC estimator found. Coupled models:", best_group,
                  " Max error:", max(errs), " Cost:", cost, "\n")
        return mfmc_data

    def compute_mfmc_data(self, clique, samples):
        """(blue_models.py:771-793)"""
        sigmas = [np.sqrt(np.diag(self.get_covariance(n)))
                  for n in range(self.n_outputs)]
        rhos = [self.get_correlation(n)[0, :] for n in range(self.n_outputs)]
        w = self.get_costs()
        for n in range(self.n_outputs):
            if not cliques.is_clique(self.G[n].clique_adjacency(), clique):
                raise ValueError("Group given is not a clique of the graph")
        if clique[0] != 0:
            raise ValueError("The high-fidelity model must lead the group")
        data_list = []
        for n in range(self.n_outputs):
            ok, d = mfmc_check(sigmas[n][clique], rhos[n][clique], w[clique],
                               samples)
            if not ok:
                raise ValueError("Prescribed samples infeasible for MFMC")
            data_list.append(d)
        order = data_list[0]["order"]
        if any(not np.array_equal(d["order"], order)
               for d in data_list[1:]):
            raise ValueError("Outputs disagree on the MFMC correlation "
                             "ordering; a shared schedule is ill-defined")
        # models/samples/alphas all in the common |rho|-descending order
        # (what solve_mfmc's nesting consumes; see setup_mfmc)
        return {"models": [clique[j] for j in order],
                "samples": np.asarray(samples)[order],
                "errors": [d["error"] for d in data_list],
                "total_cost": max(d["total_cost"] for d in data_list),
                "alphas": [d["alphas"] for d in data_list]}

    def solve_mfmc(self, budget=None, eps=None, mfmc_data=None,
                   continuous_relaxation=False):
        """(blue_models.py:867-903)"""
        if mfmc_data is None:
            mfmc_data = self.setup_mfmc(budget=budget, eps=eps,
                                        continuous_relaxation=continuous_relaxation)
        best_group = list(mfmc_data["models"])
        samples = np.round(mfmc_data["samples"]).astype(np.int64)
        errs = mfmc_data["errors"]
        tot_cost = mfmc_data["total_cost"]
        alphas = mfmc_data["alphas"]

        if self.verbose:
            print("\nSampling optimal MFMC estimator...\n")
        Lg = len(best_group)
        y = [[0 for _ in range(Lg)] for _ in range(self.n_outputs)]
        y1 = [[0 for _ in range(Lg - 1)] for _ in range(self.n_outputs)]
        n_list = [int(samples[i]) - (int(samples[i - 1]) if i else 0)
                  for i in range(Lg)]
        sumse_list = self._pipelined_sumse(
            [best_group[i:] for i in range(Lg)], n_list)
        for i in range(Lg):
            N, sumse = n_list[i], sumse_list[i]
            if N == 0:
                continue
            for n in range(self.n_outputs):
                for j in range(i, Lg):
                    y[n][j] = y[n][j] + sumse[n][j - i]
                    if j < Lg - 1:
                        y1[n][j] = y1[n][j] + sumse[n][j - i + 1]
        for n in range(self.n_outputs):
            for i in range(Lg):
                y[n][i] = y[n][i] / samples[i]
                if i < Lg - 1:
                    y1[n][i] = y1[n][i] / samples[i]
        mu = [y[n][0] + sum(alphas[n][i] * (y[n][i + 1] - y1[n][i])
                            for i in range(Lg - 1))
              for n in range(self.n_outputs)]
        return mu, errs, tot_cost

    # ------------------------------- MC --------------------------------- #

    def solve_mc(self, budget=None, eps=None):
        """(blue_models.py:905-930)"""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if budget is not None and eps is not None:
            eps = None
        if eps is not None and np.isscalar(eps):
            eps = [float(eps)] * self.n_outputs

        Vs = np.array([self.get_covariance(n)[0, 0]
                       for n in range(self.n_outputs)])
        cost = self.get_costs()[0]
        if budget is not None:
            N_MC = int(np.floor(budget / cost))
        else:
            N_MC = max(int(np.ceil(Vs[n] / eps[n] ** 2))
                       for n in range(self.n_outputs))
        # at least one sample: a budget below one high-fidelity solve
        # would otherwise divide the estimator (and errs) by zero
        N_MC = max(N_MC, 1)
        tot_cost = N_MC * cost
        errs = np.sqrt(np.maximum(Vs, 0.0) / N_MC)
        if self.verbose:
            print("Standard MC estimator ready. Max error:", max(errs),
                  "Cost:", tot_cost)
            print("\nSampling standard MC estimator...\n")
        sumse, _, _ = self.blue_fn([0], N_MC)
        mu = [sumse[n][0] / N_MC for n in range(self.n_outputs)]
        return mu, errs, tot_cost

    # ------------------------- validation tests ------------------------- #

    def complexity_test(self, eps, K=3):
        """(blue_models.py:932-942)"""
        if self.verbose:
            print("Running cost complexity test...")
        tot_cost = []
        for e in eps:
            self.setup_solver(K=K, eps=e)
            tot_cost.append(self.MOSAP_output["cost"])
        tot_cost = np.array(tot_cost)
        rate = np.polyfit(np.arange(len(tot_cost)), np.log2(tot_cost), 1)[0]
        if self.verbose:
            print("Total costs   :", tot_cost)
            print("Estimated rate:", rate)
        return tot_cost, rate

    def variance_test(self, budget=None, eps=None, K=3, N=50, **kwargs):
        """Empirical vs predicted estimator error (blue_models.py:944-978)."""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if budget is not None and eps is not None:
            eps = None
        if eps is not None and np.isscalar(eps):
            eps = [float(eps)] * self.n_outputs

        if self.verbose:
            print("Running variance test...", flush=True)
        # pop BEFORE forwarding: setup_solver takes no verbose kwarg, so
        # passing it through would crash the very call the pop sanitizes
        kwargs.pop("verbose", None)
        self.setup_solver(K=K, budget=budget, eps=eps, **kwargs)
        err_ex = np.sqrt(np.asarray(self.MOSAP_output["variances"]))
        err = np.zeros_like(err_ex)
        inners = self.get_models_inner_products()

        s1 = [0 for _ in range(self.n_outputs)]
        s2 = np.zeros_like(err_ex)
        for it in range(1, N + 1):
            if self.verbose:
                print("Sampling estimator %d/%d" % (it, N), flush=True)
            mus, _, _ = self.solve(K=K, budget=budget, eps=eps,
                                   verbose=False, **kwargs)
            for n in range(self.n_outputs):
                s1[n] += mus[n]
                s2[n] += inners[n](mus[n], mus[n])
        for n in range(self.n_outputs):
            s1[n] = inners[n](s1[n], s1[n]) / N ** 2
            s2[n] /= N
            err[n] = np.sqrt(max(s2[n] - s1[n], 0.0))
        if self.verbose:
            print("Theoretical error: ", err_ex, flush=True)
            print("Estimated error:   ", err, flush=True)
        return err_ex, err
