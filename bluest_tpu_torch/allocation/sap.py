"""Single-output sample allocation problem (SAP).

Port of ``bluest_tpu/allocation/sap.py``: the group structure with its
per-group inverse covariance blocks, the psi matrix, the variance /
gradient / Hessian and cleanup-matrix closures (``core/psi.py`` in torch
f64 on the allocation device), the continuous solve families
(``solver="sdp"``: the interior-point cone solver; ``"admm"``: the
operator-splitting cone solver; ``"scipy"``: the trust-constr NLP;
``"spg"``: projected spectral gradient), the corner-search integer
projection with its fallback ladder, the BLUE estimator assembly, and the
helpers MOSAP shares with it (the cone backend table, the budget level
bisection, the cap and NLP-point validators).  A SAP keeps its tensors
on ``self.device``: its ``device`` argument, else the allocation device
of its construction (``config.allocation_device``: the card unless a
scope or the caller says otherwise), and its solves and integer
projection run in a scope of that device, as the JAX package's decorator
pins them to its allocation device.
"""

from __future__ import annotations

from itertools import chain
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import (allocation_device, on_allocation_device,
                      on_own_device)
from ..core.groups import GroupStructure
from ..core import psi as psimod
from ..solvers.sdp import solve_cone_lp
from ..solvers.integer import best_integer_blue
from . import cones
from . import certificate as certmod

_OK_STATUSES = ("optimal", "inaccurate")


def cone_backend(backend: str):
    """Resolve a cone-solver backend name to (solver_fn, default_params,
    accepted solver_params keys).  ``"ipm"`` is the interior-point solver
    (solvers/sdp.py); ``"admm"`` the operator-splitting solver
    (solvers/admm.py) -- an algorithmically independent second SDP
    family used for cross-validation."""
    if backend == "admm":
        from ..solvers.admm import solve_cone_lp_admm
        # empty overrides: solve_cone_lp_admm's own defaults are the
        # single source of truth for the validation-role tuning
        return (solve_cone_lp_admm, {}, ("tol", "max_iter", "alpha"))
    if backend != "ipm":
        raise ValueError("cone backends available: 'ipm', 'admm'")
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


def _f64(m, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(m, dtype=float), dtype=torch.float64,
                           device=device)


def _stack_sums(flat) -> np.ndarray:
    """Model sums as one f64 array, ``(n,)`` or ``(n, *shape)``; a scalar
    among arrays (an unsampled group's 0) is broadcast to their shape."""
    try:
        return np.asarray(flat, dtype=float)
    except ValueError:
        shape = np.broadcast_shapes(*(np.shape(v) for v in flat))
        return np.stack([np.broadcast_to(np.asarray(v, dtype=float), shape)
                         for v in flat])


class SAP:
    """Sample allocation data for one output.

    ``C`` is the model covariance, ``groups`` a list of per-size-class
    group lists, ``costs`` the per-group sampling costs (reference
    sap.py:53)."""

    @on_allocation_device
    def __init__(self, C: np.ndarray, K: int,
                 groups: Sequence[Sequence[Sequence[int]]],
                 costs: np.ndarray, verbose: bool = False, *, device=None):
        self.verbose = verbose
        self.C = np.asarray(C, dtype=float)
        self.N = self.C.shape[0]
        self.K = K
        self.costs = np.asarray(costs, dtype=float)

        self.gs = GroupStructure(self.N, groups, C=self.C)
        self.device = allocation_device()
        self.data = psimod.GroupData.build(self.gs, device=self.device)
        self.psi = self.data.psi.cpu().numpy()

        self.sizes = self.gs.sizes
        self.cumsizes = self.gs.cumsizes
        self.L = self.gs.L
        self.flattened_groups = list(self.gs.flat_groups)
        self.ES = [self.gs.ES[i] for i in range(self.N)]
        self.e = self.gs.e

        self.samples = None
        self.budget = None
        self.eps = None
        self.tot_cost = None
        self.n_nlp_fallbacks = 0   # times the SDP failed over to scipy
        self.certificates = []     # per-cone-solve solver certificates
        self.continuous_solution = None
        self._continuous_eps = None

    def variance(self, m, delta: float = 0.0) -> float:
        m = np.asarray(m, dtype=float)
        if np.abs(m).max() < 0.05:
            return np.inf
        try:
            return psimod.host_variance(self.gs, self.psi, m, delta=delta)
        except np.linalg.LinAlgError:
            return float(psimod.variance(self.data, _f64(m, self.device),
                                         delta))

    def variance_GH(self, m, delta: float = 0.0, nohess: bool = False):
        m = np.asarray(m, dtype=float)
        if np.abs(m).max() < 0.05:
            return np.inf, np.inf * np.ones(self.L), None
        v, g, H = psimod.variance_grad_hess(self.data, _f64(m, self.device),
                                            delta=delta, nohess=nohess)
        return (float(v), g.cpu().numpy(),
                None if H is None else H.cpu().numpy())

    def get_cleanup_matrix(self, m, delta: float = 0.0) -> np.ndarray:
        return psimod.cleanup_matrix(self.data, _f64(m, self.device),
                                     delta).cpu().numpy()

    def get_phi(self, m, delta: float = 0.0) -> np.ndarray:
        return psimod.phi_of_m(self.data.psi, _f64(m, self.device),
                               delta).cpu().numpy()

    def kkt_certificate(self, m=None, eps=None):
        """Independent first-order KKT report for a continuous allocation
        (defaults to the last ``solve``'s pre-rounding point).  Verifies
        the IPM's "optimal" claim through the variance/gradient closures
        only -- a separate code path from the cone solver (the role the
        reference's cross-vendor ``solver_test`` blocks play,
        bluest_NS.py:124-140)."""
        if m is None:
            m = self.continuous_solution
        if m is None:
            raise ValueError("no continuous solution available; solve first")
        if eps is None:
            eps = self._continuous_eps
        grad = lambda x: self.variance_GH(x, nohess=True)[1]
        v = self.variance(np.asarray(m, dtype=float))
        return certmod.kkt_certificate(
            m, self.costs, [grad], [v],
            eps=None if eps is None else [eps])

    # --------------------------- constraints -------------------------- #

    def get_max_sample_constraints(self, max_model_samples):
        """(reference sap.py:222-240)"""
        if max_model_samples is None:
            return [], []
        max_model_samples = np.asarray(max_model_samples)
        if max_model_samples.shape != (self.N,):
            raise ValueError("max_model_samples must have one entry per model")
        if max_model_samples[0] < 1:
            raise ValueError("The high-fidelity model must be sampled at least once.")
        es, rhs = [], []
        for i in range(self.N):
            if np.isfinite(max_model_samples[i]):
                es.append(self.ES[i])
                rhs.append(int(round(max_model_samples[i])))
        return es, rhs

    # ----------------------------- solvers ---------------------------- #

    @on_own_device
    def solve(self, budget: Optional[float] = None, eps: Optional[float] = None,
              solver: str = "sdp", x0=None, continuous_relaxation: bool = False,
              max_model_samples=None, solver_params: Optional[dict] = None):
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        self.certificates = []
        # reference solver names map onto ours: its cvxopt/cvxpy SDP paths
        # are served by the interior-point solver
        if solver in ("cvxopt", "cvxpy", "sdp"):
            samples = self.sdp_solve(budget=budget, eps=eps,
                                     max_model_samples=max_model_samples,
                                     solver_params=solver_params)
        elif solver in ("admm", "scs"):
            samples = self.sdp_solve(budget=budget, eps=eps,
                                     max_model_samples=max_model_samples,
                                     solver_params=solver_params,
                                     backend="admm")
        elif solver in ("scipy", "ipopt"):
            samples = self.scipy_solve(budget=budget, eps=eps, x0=x0,
                                       max_model_samples=max_model_samples)
        elif solver == "spg":
            samples = self.spg_solve(budget=budget, eps=eps,
                                     max_model_samples=max_model_samples)
        else:
            raise ValueError("solvers available: 'sdp' (default), "
                             "'admm', 'scipy', 'spg'")

        if samples is None and solver in ("cvxopt", "cvxpy", "sdp",
                                          "admm", "scs"):
            # robustness fallback: the host NLP solves instances the IPM
            # stalls on (and vice versa)
            self.n_nlp_fallbacks += 1
            if self.verbose:
                print("SDP solver failed; falling back to scipy NLP...")
            samples = self.scipy_solve(budget=budget, eps=eps, x0=x0,
                                       max_model_samples=max_model_samples)

        if samples is None:
            self.samples = None
            return None

        self.continuous_solution = np.asarray(samples, dtype=float).copy()
        self._continuous_eps = eps   # kkt_certificate's default tolerance
        # (self.eps is only set on full success, so it can go stale when
        # the integer projection fails after a good continuous solve)

        if not continuous_relaxation:
            try:
                samples = self.integer_projection(
                    samples, budget=budget, eps=eps,
                    max_model_samples=max_model_samples)
            except AssertionError as exc:
                if self.verbose:
                    print(str(exc))
                self.samples = None
                return None

        self.samples = samples
        self.budget = budget
        self.eps = eps
        self.tot_cost = samples @ self.costs
        return samples

    @on_own_device
    def sdp_solve(self, budget=None, eps=None, max_model_samples=None,
                  solver_params=None, backend="ipm"):
        es, rhs = self.get_max_sample_constraints(max_model_samples)
        cone_solve, params, allowed = cone_backend(backend)
        if solver_params:
            params.update({k: v for k, v in solver_params.items()
                           if k in allowed})
        mapping = [np.arange(self.L)]
        if budget is not None:
            m_ray = None
            if len(es) == 0:
                # budget mode through the direct eps form + ray rescale
                # (same Pareto frontier by homogeneity; see MOSAP.sdp_solve).
                # NO feasibility rescale here: the guard below must see the
                # raw solve-scale point (a rescale factor > 1 would inflate
                # e.m past the threshold and mask a binding >=1-sample row)
                e0 = np.sqrt(self.C[0, 0]) / 100.0
                m = self._direct_eps_solve(e0, [], [], params, cone_solve)
                # homogeneity needs e.m >= 1 slack at the SOLVE scale: if
                # it binds there, the scaled ray inherits its distortion
                if m is not None:
                    lhs = float(self.e @ m)
                    if lhs < 10.0:
                        m2 = self._direct_eps_solve(
                            e0 * np.sqrt(max(lhs, 1.0) / 20.0), [], [],
                            params, cone_solve)
                        if m2 is not None:
                            m = m2
                if m is not None and float(m @ self.costs) > 0:
                    m_ray = m * (budget / float(m @ self.costs))
                    # inhomogeneous regime (e.m = 1 active at the budget
                    # scale): fall through to the epigraph + bisection
                    if float(self.e @ m_ray) >= 1.0 - 1e-9:
                        return m_ray
            c, Gl, hl, As, Hs, scales = cones.build_budget_sdp(
                [self.psi], mapping, self.L, self.costs, [self.e],
                budget, es, rhs)
            res = cone_solve(c, Gl, hl, As, Hs,
                             verbose=self.verbose, **params)
            certmod.record(self.certificates, "budget-epigraph", res)
            m_epi = None
            if res.status in _OK_STATUSES:
                m_epi = np.maximum(res.x[1:], 0) * budget
                # an "inaccurate" point can overspend/overcap by orders of
                # magnitude (which also fakes a low variance in the min()
                # race below) -- treat infeasible ones as failed
                if (float(m_epi @ self.costs) > 1.0001 * budget
                        or not caps_satisfied(m_epi, es, rhs)):
                    m_epi = None
            if m_epi is not None and certmod.is_tight(self.certificates[-1]):
                return m_epi
            # conditioning rescue (see budget_level_bisection)
            def cost_at(v):
                mv = self._direct_eps_solve(np.sqrt(v), es, rhs, params,
                                            cone_solve, validate=True)
                if mv is None:
                    # certified infeasibility (tau collapse) marks the cap
                    # floor: underspending there is the true optimum
                    return None, np.inf, (self.certificates[-1]["status"]
                                          == "infeasible")
                return mv, float(mv @ self.costs), False
            v0 = self._variance_of(m_epi) if m_epi is not None else None
            if (v0 is None or not np.isfinite(v0) or v0 <= 0) \
                    and m_ray is not None:
                v0 = self._variance_of(m_ray)
            if v0 is None or not np.isfinite(v0) or v0 <= 0:
                v0 = self.C[0, 0] / 1e4
            m_bis = budget_level_bisection(cost_at, v0, budget)
            if m_bis is not None and m_epi is not None:
                return min((m_bis, m_epi), key=self._variance_of)
            return m_bis if m_bis is not None else m_epi
        def feasibility_rescale(m0):
            """alpha*m0 with alpha = V(m0)/eps^2 (homogeneity; see MOSAP)."""
            m0 = np.maximum(m0, 0)
            if m0.max() <= 0:
                return None
            Ksc = 1.0 / m0.max()
            try:
                alpha = Ksc * self.variance(Ksc * m0) / eps ** 2
            except (AssertionError, np.linalg.LinAlgError):
                return None
            if not np.isfinite(alpha) or alpha <= 0:
                return None
            return alpha * m0

        candidates = []
        # (a) direct eps SDP with a meps rescale for conditioning
        m = self._direct_eps_solve(eps, es, rhs, params, cone_solve)
        if m is not None:
            if len(es) == 0:
                m = feasibility_rescale(m)
            if m is not None:
                candidates.append(m)
        # the screen below must treat a rescale failure like a solve
        # failure: either way the direct family contributed nothing
        have_a = bool(candidates)
        # (b) scaled budget epigraph (homogeneity) -- no caps only; run as
        # a cross-check/cost-race when (a) failed or its certificate is
        # loose (see MOSAP.sdp_solve)
        a_tight = bool(self.certificates) and certmod.is_tight(
            self.certificates[-1])
        if len(es) == 0 and (not candidates
                             or (self.L <= 600 and not a_tight)):
            c, Gl, hl, As, Hs, scales = cones.build_budget_sdp(
                [self.psi], mapping, self.L, self.costs, [], 1.0,
                eps_weights=np.array([eps]))
            res = cone_solve(c, Gl, hl, As, Hs,
                             verbose=self.verbose, **params)
            certmod.record(self.certificates, "scaled-budget-epigraph", res)
            if res.status in _OK_STATUSES:
                m = feasibility_rescale(res.x[1:])
                if m is not None:
                    candidates.append(m)
        if not candidates:
            return None

        def _gross(mm):
            """Independent first-order screen (see MOSAP.sdp_solve: a
            stalled epigraph iterate's self-consistent rescale once hid
            a 38%-low garbage cost)."""
            try:
                cert = self.kkt_certificate(np.asarray(mm, float),
                                            eps=float(eps))
            except (AssertionError, ValueError, RuntimeError,
                    np.linalg.LinAlgError):
                return True
            s = cert.get("stationarity", np.inf)
            return not (np.isfinite(s) and s <= 0.3)

        win = min(candidates, key=lambda m: float(m @ self.costs))
        if len(candidates) == 2 and win is candidates[1]:
            if (float(win @ self.costs)
                    < 0.9 * float(candidates[0] @ self.costs)
                    and _gross(win)):
                return candidates[0]
            return win
        if not have_a and _gross(win):
            return None    # epigraph-only garbage -> NLP fallback chain
        if have_a and len(candidates) == 1:
            # Lone direct-path winner: its validation is the same
            # self-consistent variance evaluation that once masked a
            # 38%-low garbage point, and sdp.py accepts "inaccurate"
            # with dres up to 1e5*feastol.  Screen exactly that widest
            # decade: a stalled iterate there must also pass the
            # independent first-order check or fall through to NLP.
            feastol = params.get("feastol", 1e-8)
            cert = next((c for c in reversed(self.certificates)
                         if c.get("form") == "direct-eps"), None)
            if (cert is not None and cert.get("status") == "inaccurate"
                    and cert.get("dres", 0.0) > 1e4 * feastol
                    and _gross(win)):
                return None
        return win

    def _direct_eps_solve(self, eps, es, rhs, params,
                          cone_solve=solve_cone_lp, validate=None):
        """Direct eps-form SDP with the meps conditioning rescale (no
        feasibility rescale -- callers that may hold caps handle it).
        ``validate`` as in MOSAP._direct_eps_solve: tolerance-check the
        point instead of trusting solver status (default: iff caps)."""
        mapping = [np.arange(self.L)]
        meps = 100.0 / np.sqrt(max(self.C[0, 0], 1e-300) / eps ** 2)
        c, Gl, hl, As, Hs, _ = cones.build_eps_sdp(
            [self.psi], mapping, self.L, self.costs, [self.e],
            np.array([eps / meps]), meps, es, rhs)
        res = cone_solve(c, Gl, hl, As, Hs,
                         verbose=self.verbose, **params)
        certmod.record(self.certificates, "direct-eps", res)
        if res.status not in _OK_STATUSES:
            return None
        m = np.maximum(res.x, 0) / meps ** 2
        if len(es) > 0 if validate is None else validate:
            v = self._variance_of(m)
            if not np.isfinite(v) or v > 1.05 * eps ** 2:
                return None
            # an "inaccurate" point can also overcap -- oversampling a
            # capped model FAKES a low variance, so the tolerance check
            # alone would bless exactly the bad points
            if not caps_satisfied(m, es, rhs):
                return None
        return m

    def _variance_of(self, m):
        """V(m) with the scale trick that dodges the 0.05-entry cutoff
        in variance() (see feasibility_rescale)."""
        m = np.maximum(np.asarray(m, dtype=float), 0)
        if m.max() <= 0:
            return np.inf
        Ksc = 1.0 / m.max()
        try:
            v = Ksc * self.variance(Ksc * m)
        except (AssertionError, np.linalg.LinAlgError):
            return np.inf
        return v if np.isfinite(v) else np.inf

    @on_own_device
    def spg_solve(self, budget=None, eps=None, max_model_samples=None):
        """Third continuous solver family (projected spectral gradient,
        solvers/spg_alloc.py) for cross-validation against the IPM and
        the scipy NLP -- the reference's interchangeable-solver story
        (sap.py:242-456).  Budget mode native (caps via the Dykstra
        projection); eps mode by homogeneity, or budget bisection when
        caps break the homogeneity reduction."""
        from ..solvers.spg_alloc import (_cap_arrays, solve_budget_spg,
                                         eps_caps_budget_search)
        es, rhs = self.get_max_sample_constraints(max_model_samples)
        cr, crhs = _cap_arrays(self.L, es, rhs)

        def ratio_of(m):
            m = np.maximum(m, 0)
            Ksc = 1.0 / max(m.max(), 1e-300)
            try:
                r = Ksc * self.variance(Ksc * m) / eps ** 2
            except (AssertionError, np.linalg.LinAlgError):
                return np.inf
            return r if np.isfinite(r) and r > 0 else np.inf

        if budget is None:
            m0 = self.spg_solve(budget=10.0 * float(self.costs.sum()))
            if m0 is None:
                return None
            alpha = ratio_of(m0)
            if not np.isfinite(alpha) or alpha <= 0:
                return None
            m0 = alpha * np.maximum(m0, 0)
            if np.all(cr @ m0 <= crhs + 1e-9):   # vacuous when no caps
                return m0
            # caps bind: bisection on the capped budget problem seeded
            # at the uncapped optimum's cost
            return eps_caps_budget_search(
                lambda B, x0: solve_budget_spg(self.data, self.costs, B,
                                               cr, crhs, x0=x0),
                ratio_of, float(self.costs @ m0))
        return solve_budget_spg(self.data, self.costs, float(budget),
                                cr, crhs)

    # --- reference method-name aliases (sap.py:242, 332, 420): the
    # cvxopt/cvxpy vendor paths are served by the interior-point solver, ipopt by the
    # scipy NLP; ``delta`` regularization is handled inside the solvers.
    # Each starts a fresh certificate list (solve() is not on this path)
    # and records its result as the current continuous solution so a
    # subsequent kkt_certificate() verifies THIS point, not a stale one.
    def _record_continuous(self, samples, eps):
        if samples is not None:
            self.continuous_solution = np.asarray(samples, float).copy()
            self._continuous_eps = eps
        return samples

    def cvxopt_solve(self, budget=None, eps=None, delta=0.0,
                     max_model_samples=None, cvxopt_params=None):
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        self.certificates = []
        return self._record_continuous(
            self.sdp_solve(budget=budget, eps=eps,
                           max_model_samples=max_model_samples,
                           solver_params=cvxopt_params), eps)

    def cvxpy_solve(self, budget=None, eps=None, delta=0.0,
                    max_model_samples=None, cvxpy_params=None):
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        self.certificates = []
        return self._record_continuous(
            self.sdp_solve(budget=budget, eps=eps,
                           max_model_samples=max_model_samples,
                           solver_params=cvxpy_params), eps)

    def ipopt_solve(self, budget=None, eps=None, x0=None,
                    max_model_samples=None):
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        return self._record_continuous(
            self.scipy_solve(budget=budget, eps=eps, x0=x0,
                             max_model_samples=max_model_samples), eps)

    def get_variance_functions(self):
        """Reference helper (sap.py:121-143): the variance closures over
        the group structure, for external optimizers/inspection."""
        return self.get_phi, self.variance, self.variance_GH

    def scipy_solve(self, budget=None, eps=None, x0=None,
                    max_model_samples=None):
        """Host NLP path mirroring the reference (sap.py:387-418), with the
        torch variance/grad/Hessian closures."""
        from scipy.optimize import minimize, LinearConstraint, \
            NonlinearConstraint, Bounds

        L = self.L
        w = self.costs
        es, rhs = self.get_max_sample_constraints(max_model_samples)
        rng = np.random.default_rng(0)

        if budget is None and eps is not None and len(es) == 0:
            # scaled solve via homogeneity (see sdp_solve): the direct
            # eps-mode NLP is badly scaled for trust-constr
            m0 = self.scipy_solve(budget=10.0 * float(w.sum()), x0=x0)
            if m0 is None:
                return None
            m0 = np.maximum(m0, 0)
            K = 1.0 / max(m0.max(), 1e-300)
            try:
                alpha = K * self.variance(K * m0) / eps ** 2
            except (AssertionError, np.linalg.LinAlgError):
                return None
            return alpha * m0

        bounds = Bounds(np.zeros(L), np.inf * np.ones(L), keep_feasible=True)
        lc_e = LinearConstraint(self.e, 1, np.inf, keep_feasible=True)
        lc_max = [LinearConstraint(ee, -np.inf, rr) for ee, rr in zip(es, rhs)]
        if budget is not None:
            lc_b = LinearConstraint(w, -np.inf, budget)
            if x0 is None:
                x0 = np.full(L, budget / w.sum())
            r = minimize(lambda x: self.variance_GH(x, nohess=True)[:2],
                         x0, jac=True,
                         hess=lambda x: self.variance_GH(x)[2],
                         bounds=bounds,
                         constraints=[lc_b, lc_e] + lc_max,
                         method="trust-constr",
                         options={"maxiter": 1000,
                                  "verbose": 3 * int(self.verbose)},
                         tol=1e-8)

            def feasible(x):
                m = np.maximum(x, 0)
                if w @ m > 1.0001 * budget:
                    return False
                return caps_satisfied(m, es, rhs)
        else:
            epsq = eps ** 2
            nl = NonlinearConstraint(
                lambda x: self.variance(x), epsq, epsq,
                jac=lambda x: self.variance_GH(x, nohess=True)[1],
                hess=lambda x, p: self.variance_GH(x)[2] * p)
            if x0 is None:
                x0 = np.ceil(eps ** -2 * rng.random(L))
            wn = w / np.linalg.norm(w)
            r = minimize(lambda x: (wn @ x, wn), x0, jac=True,
                         hessp=lambda x, p: np.zeros(L),
                         bounds=bounds, constraints=[nl, lc_e] + lc_max,
                         method="trust-constr",
                         options={"maxiter": 1000,
                                  "verbose": 3 * int(self.verbose)},
                         tol=1e-10)

            def feasible(x):
                m = np.maximum(x, 0)
                # caps are constraints too (see MOSAP.scipy_solve)
                if not caps_satisfied(m, es, rhs):
                    return False
                try:
                    return self.variance(m) <= 1.001 * eps ** 2
                except (AssertionError, np.linalg.LinAlgError):
                    return False
        return validated_nlp_point(r, feasible)

    # ------------------------ integer projection ---------------------- #

    @on_own_device
    def integer_projection(self, samples, budget=None, eps=None,
                           max_model_samples=None):
        """(reference sap.py:145-187; ladder bug fixed, see module doc)"""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if self.verbose:
            print("Integer projection...")

        ss = np.asarray(samples, dtype=float).copy()
        es, rhs = self.get_max_sample_constraints(max_model_samples)

        out, fval = best_integer_blue(ss, self.psi, self.costs, self.e,
                                      budget=budget, eps=eps,
                                      max_samples_info=(es, rhs))

        if np.isinf(fval):
            for i in reversed(range(4)):
                fac = 10.0 ** -i
                nb = None if budget is None else budget * (1 + fac)
                ne = None if eps is None else float(np.sqrt(eps ** 2 * (1 + fac)))
                if self.verbose:
                    print("WARNING! No feasible integer solution; increasing "
                          "tolerance/budget by factor %g." % (1 + fac))
                out, fval = best_integer_blue(ss, self.psi, self.costs,
                                              self.e, budget=nb, eps=ne,
                                              max_samples_info=(es, rhs))
                if not np.isinf(fval):
                    break

        if np.isinf(fval):
            if max_model_samples is not None and not all(
                    np.ceil(ss) @ ee <= rr for ee, rr in zip(es, rhs)):
                out = np.floor(ss)
                if out @ self.e < 1.0:
                    out = np.ceil(ss)
                if self.verbose:
                    print("WARNING! Rounding to satisfy constraints.")
            else:
                if self.verbose:
                    print("WARNING! No feasible integer solution found; "
                          "rounding up.")
                out = np.ceil(ss)

        return np.asarray(out, dtype=np.int64)

    # ------------------------- estimator assembly --------------------- #

    def compute_BLUE_estimator(self, sums, samples=None):
        """(mu, var) from per-group sample sums (reference sap.py:99-119).
        ``sums[g]`` is the length-|group g| list of model sums: scalars,
        or arrays of one shape (vector-valued outputs) beside the scalar
        0s of unsampled groups.  ``y = sum_g R_g^T C_g^-1 S_g`` is built
        by array operations that make the reference loop's products and
        sums in its order, so it is bit-equal to the loop's."""
        if samples is None:
            samples = self.samples
        samples = np.asarray(samples, dtype=float)

        s = _stack_sums(list(chain.from_iterable(sums[:self.L])))
        if s.shape[0] != self.gs.members.size:
            raise ValueError("sums hold %d model sums, the groups %d"
                             % (s.shape[0], self.gs.members.size))
        tail = s.shape[1:]
        accs = []
        off = 0
        for ics in self.gs.invcovs:
            Lk, k = ics.shape[:2]
            S = s[off:off + Lk * k].reshape((Lk, k) + tail)
            off += Lk * k
            ics = ics.reshape(ics.shape + (1,) * len(tail))
            # acc[i, j] = sum_l ics[i, j, l] * S[i, l], left to right
            acc = 0.0
            for l in range(k):
                acc = acc + ics[:, :, l] * S[:, None, l]
            accs.append(acc.reshape((Lk * k,) + tail))
        # unbuffered, in index order: each model's additions in the
        # loop's (group, slot) order
        y = np.zeros((self.N,) + tail)
        np.add.at(y, self.gs.members, np.concatenate(accs))

        return psimod.host_estimator(self.gs, self.psi, samples, y)
