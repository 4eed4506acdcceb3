"""Single-output sample allocation problem (SAP): what MOSAP needs.

Port of the per-output part of ``bluest_tpu/allocation/sap.py``: the
group structure with its per-group inverse covariance blocks, the psi
matrix, the variance / gradient / Hessian and cleanup-matrix closures
(``core/psi.py`` in torch f64 on the allocation device), the BLUE
estimator assembly, and the helpers MOSAP shares with it (the cone
backend, the budget level bisection, the cap and NLP-point validators).
The single-output solve paths (``SAP.solve`` and its families) are not
ported yet (ROADMAP queue 1 item 11); MOSAP drives the allocation.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import allocation_device
from ..core.groups import GroupStructure
from ..core import psi as psimod
from ..solvers.sdp import solve_cone_lp

_OK_STATUSES = ("optimal", "inaccurate")


def cone_backend(backend: str):
    """Resolve a cone-solver backend name to (solver_fn, default_params,
    accepted solver_params keys).  Only the interior-point backend
    ``"ipm"`` is ported."""
    if backend != "ipm":
        raise ValueError("cone backends available in bluest_tpu_torch: "
                         "'ipm'")
    return (solve_cone_lp, {}, ("tol", "feastol", "max_iter"))


def budget_level_bisection(cost_at, v0, budget, max_steps=42,
                           min_spend_frac=0.99):
    """Smallest common variance level v with cost(v) <= budget.

    ``cost_at(v) -> (m, cost, infeasible)`` must be monotone
    nonincreasing in v (min-cost at tolerance sqrt(v); infeasible or
    stalled solves return cost=inf, with ``infeasible`` True only when
    the solver CERTIFIED the level infeasible -- the HSD tau-collapse
    certificate).  min max-variance at budget B == smallest v whose
    min-cost at level v fits B, so a log-space bisection on v solves
    budget mode through the well-conditioned direct-eps form -- the
    rescue for instances where the t-epigraph LMI stalls the IPM.

    The value function cost(v) of the convex program is continuous, so
    the true budget optimum spends essentially the whole budget (it
    blows up toward the cap-floor level, it does not jump across B) --
    UNLESS per-model caps bound the achievable spend below the budget,
    in which case the optimum sits at the certified cap floor and
    legitimately underspends.  A converged bracket whose feasible side
    underspends WITHOUT a certified-infeasible floor below it means the
    backend stopped tracking the frontier (first-order stall), not that
    the optimum underspends -- reject it (``min_spend_frac``) so the
    caller's fallback chain engages instead of returning a feasible but
    massively suboptimal allocation."""
    best, best_cost = None, -np.inf
    lo = hi = None  # lo: cost > budget (or infeasible); hi: cost <= budget
    floor_certified = False
    v = v0
    for _ in range(max_steps):
        m, cost, infeasible = cost_at(v)
        if cost <= budget * (1.0 + 1e-9):
            best, best_cost, hi = m, cost, v
            if cost >= budget * (1.0 - 1e-4):
                break  # spent essentially the whole budget
        else:
            lo = v
            floor_certified = floor_certified or bool(infeasible)
        if lo is None:
            v = hi / 4.0            # expand down: overshoot the budget
        elif hi is None:
            v = lo * 4.0            # expand up: get budget-feasible
        else:
            if hi / lo < 1.0 + 1e-9:
                break
            v = np.sqrt(lo * hi)    # log-space bisection
    if (best is not None and best_cost < min_spend_frac * budget
            and not floor_certified):
        return None
    return best


def caps_satisfied(m, es, rhs, slack: float = 1.001,
                   atol: float = 1e-9) -> bool:
    """Per-model cap rows ``ES_i @ m <= rhs_i`` hold within the integer
    search's slack.  THE cap-feasibility predicate -- every validator
    (epigraph point, direct-eps point, NLP fallback, bisection rescue)
    must use the same tolerance or they silently disagree about which
    candidate survives."""
    return all(float(ee @ m) <= slack * rr + atol
               for ee, rr in zip(es, rhs))


def validated_nlp_point(r, feasible):
    """Validate a trust-constr result before handing it downstream.

    The reference returns ``r.x`` unchecked (sap.py:418, mosap.py:613);
    here the NLP is also the *fallback for IPM failures*, where a quietly
    non-converged point matters more.  A point is rejected (-> ``None`` ->
    ``BLUESTError`` upstream) only when the solver did NOT converge AND
    the point is infeasible beyond the integer search's slack -- a
    non-converged but feasible point is still a usable allocation."""
    x = np.asarray(r.x, dtype=float)
    if not np.all(np.isfinite(x)):
        return None
    if not getattr(r, "success", True) and not feasible(x):
        return None
    return x


def _f64(m) -> torch.Tensor:
    return torch.as_tensor(np.asarray(m, dtype=float), dtype=torch.float64,
                           device=allocation_device())


class SAP:
    """Sample allocation data for one output.

    ``C`` is the model covariance, ``groups`` a list of per-size-class
    group lists, ``costs`` the per-group sampling costs (reference
    sap.py:53)."""

    def __init__(self, C: np.ndarray, K: int,
                 groups: Sequence[Sequence[Sequence[int]]],
                 costs: np.ndarray, verbose: bool = False):
        self.verbose = verbose
        self.C = np.asarray(C, dtype=float)
        self.N = self.C.shape[0]
        self.K = K
        self.costs = np.asarray(costs, dtype=float)

        self.gs = GroupStructure(self.N, groups, C=self.C)
        self.data = psimod.GroupData.build(self.gs)
        self.psi = self.data.psi.cpu().numpy()

        self.sizes = self.gs.sizes
        self.cumsizes = self.gs.cumsizes
        self.L = self.gs.L
        self.flattened_groups = list(self.gs.flat_groups)
        self.ES = [self.gs.ES[i] for i in range(self.N)]
        self.e = self.gs.e
        self.samples = None

    def variance(self, m, delta: float = 0.0) -> float:
        m = np.asarray(m, dtype=float)
        if np.abs(m).max() < 0.05:
            return np.inf
        try:
            return psimod.host_variance(self.gs, self.psi, m, delta=delta)
        except np.linalg.LinAlgError:
            return float(psimod.variance(self.data, _f64(m), delta))

    def variance_GH(self, m, delta: float = 0.0, nohess: bool = False):
        m = np.asarray(m, dtype=float)
        if np.abs(m).max() < 0.05:
            return np.inf, np.inf * np.ones(self.L), None
        v, g, H = psimod.variance_grad_hess(self.data, _f64(m), delta=delta,
                                            nohess=nohess)
        return (float(v), g.cpu().numpy(),
                None if H is None else H.cpu().numpy())

    def get_cleanup_matrix(self, m, delta: float = 0.0) -> np.ndarray:
        return psimod.cleanup_matrix(self.data, _f64(m), delta).cpu().numpy()

    def compute_BLUE_estimator(self, sums, samples=None):
        """(mu, var) from per-group sample sums (reference sap.py:99-119).
        ``sums[g]`` is the length-|group g| list of model sums."""
        if samples is None:
            samples = self.samples
        samples = np.asarray(samples, dtype=float)

        y = [0.0 for _ in range(self.N)]
        gidx = 0
        for k in range(1, self.K + 1):
            groups_k = self.gs.groups[k - 1]
            ics = self.gs.invcovs[k - 1]
            for i in range(groups_k.shape[0]):
                s = sums[gidx]
                for j in range(k):
                    acc = 0.0
                    for l in range(k):
                        acc = acc + ics[i, j, l] * s[l]
                    y[groups_k[i, j]] = y[groups_k[i, j]] + acc
                gidx += 1

        return psimod.host_estimator(self.gs, self.psi, samples, y)
