"""Multi-output sample allocation problem (MOSAP): the budget path.

Port of ``bluest_tpu/allocation/mosap.py`` for budget mode without
per-model caps: one SAP per output over that output's group sublist, a
shared allocation vector over the union group list, the direct-eps cone
program with the homogeneity-ray rescale (and its ray cache), the budget
epigraph fall-through, the null-space cleanup sparsifier, the integer
projection with its fallback ladder, and the estimator assembly.

Not ported yet (each raises): eps mode, per-model caps, the ADMM / SPG /
scipy solver families, and the scipy NLP fallback that the JAX package
runs when every cone solve fails -- here that case raises BLUESTError.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core import psi as psimod
from ..solvers.integer import best_integer_blue_multi
from . import cones
from . import certificate as certmod
from .sap import (SAP, _OK_STATUSES, _f64, budget_level_bisection,
                  cone_backend)


class BLUESTError(RuntimeError):
    """Raised when the allocation optimization fails (reference mosap.py:15)."""


class MOSAP:
    def __init__(self, C: Sequence[np.ndarray], K: int, Ks: Sequence[int],
                 groups, multi_groups, costs: np.ndarray,
                 multi_costs: Sequence[np.ndarray], verbose: bool = False):
        self.verbose = verbose
        self.n_outputs = len(C)
        self.C = [np.asarray(Cn, dtype=float) for Cn in C]
        self.N = self.C[0].shape[0]
        self.K = K
        self.Ks = list(Ks)
        self.costs = np.asarray(costs, dtype=float)
        self.multi_groups = multi_groups
        self.multi_costs = multi_costs

        self.flattened_groups = [list(g) for gk in groups for g in gk]
        self.groups = [np.array(gk, dtype=np.int64).reshape(len(gk), k + 1)
                       for k, gk in enumerate(groups)]
        self.sizes = [0] + [len(gk) for gk in groups]
        self.cumsizes = np.cumsum(self.sizes)
        self.L = int(self.cumsizes[-1])

        self.SAPS = [SAP(self.C[n], self.Ks[n], multi_groups[n],
                         multi_costs[n], verbose=verbose)
                     for n in range(self.n_outputs)]

        ES = np.zeros((self.N, self.L))
        for gidx, g in enumerate(self.flattened_groups):
            ES[np.asarray(g, dtype=int), gidx] = 1.0
        self.ES = [ES[i] for i in range(self.N)]
        self.e = self.ES[0]

        # mappings[n]: global group index of output n's local group j
        # (reference mosap.py:54-67)
        lookup = {}
        for k, gk in enumerate(groups):
            for j, g in enumerate(gk):
                lookup[tuple(g)] = int(self.cumsizes[k] + j)
        self.mappings = [
            np.array([lookup[tuple(g)] for gk in multi_groups[n] for g in gk],
                     dtype=np.int64)
            for n in range(self.n_outputs)]

        self.samples = None
        self.budget = None
        self.tot_cost = None
        self.certificates = []     # per-cone-solve IPM certificates
        self.continuous_solution = None
        self._ray_cache = {}
        self._ray_certs = {}

    # ------------------------------------------------------------------ #

    def variances(self, m, delta: float = 0.0):
        return [self.SAPS[n].variance(m[self.mappings[n]], delta=delta)
                for n in range(self.n_outputs)]

    def get_cleanup_matrices(self, m, delta: float = 0.0) -> np.ndarray:
        Xs = []
        for n in range(self.n_outputs):
            Xn = psimod.cleanup_matrix(self.SAPS[n].data,
                                       _f64(m[self.mappings[n]]), delta)
            X = np.zeros((self.N, self.L))
            X[:, self.mappings[n]] = Xn.cpu().numpy()
            Xs.append(X)
        return np.vstack(Xs)

    def _e_rows(self):
        rows = []
        for n in range(self.n_outputs):
            ee = np.zeros(self.L)
            ee[self.mappings[n]] = self.e[self.mappings[n]]
            rows.append(ee)
        return rows

    # ------------------------------ solve ----------------------------- #

    def solve(self, budget=None, eps=None, solver: str = "sdp",
              continuous_relaxation: bool = False, max_model_samples=None,
              solver_params: Optional[dict] = None):
        """Budget-mode allocation: continuous cone solve (or the cached
        ray), cleanup walk, integer projection.  Returns the integer
        samples (or the continuous point with ``continuous_relaxation``)."""
        if budget is None:
            raise NotImplementedError(
                "bluest_tpu_torch ports budget mode only; eps mode is not "
                "ported yet")
        if max_model_samples is not None:
            raise NotImplementedError(
                "per-model sample caps are not ported yet")
        if solver not in ("cvxopt", "cvxpy", "sdp"):
            raise ValueError("solvers available in bluest_tpu_torch: 'sdp'")
        self.certificates = []

        # Budget-mode solutions form a ray (V homogeneous of degree -1 in
        # m): solve once and rescale on later budgets while the >=1-sample
        # rows stay satisfied (they are the one inhomogeneous part)
        ray_key = ("budget_ray", solver)
        cached_ray = self._ray_cache.get(ray_key)
        if cached_ray is not None and any(
                float(ee @ cached_ray) * budget < 1.0 - 1e-9
                for ee in self._e_rows()):
            cached_ray = None
        if cached_ray is not None:
            samples = cached_ray * budget
            self.certificates = list(self._ray_certs.get(ray_key, []))
        else:
            samples = self.sdp_solve(budget=budget,
                                     solver_params=solver_params)
        if samples is None:
            # the JAX package falls back to its scipy NLP here
            raise BLUESTError("cone solve failed (the NLP fallback is not "
                              "ported yet)")

        self.continuous_solution = np.asarray(samples, dtype=float).copy()

        # complete group sets make the continuous optimum degenerate: walk
        # the diffuse interior point to a sparse vertex first
        if (not continuous_relaxation
                and np.sum(samples > 1e-9 * samples.max()) > 4 * self.N):
            samples = self.cleanup_solution(
                np.asarray(samples, float).copy(),
                tol=1e-7 * float(np.max(samples)))

        if all(float(ee @ np.asarray(samples, float)) > 1.01
               for ee in self._e_rows()):
            if continuous_relaxation:
                # never displace a cleaned (sparse) ray with a diffuse one
                self._ray_cache.setdefault(
                    ray_key, np.asarray(samples, float) / budget)
                self._ray_certs.setdefault(ray_key, list(self.certificates))
            else:
                self._ray_cache[ray_key] = np.asarray(samples, float) / budget
                self._ray_certs[ray_key] = list(self.certificates)

        if not continuous_relaxation:
            try:
                samples = self.integer_projection(samples, budget=budget)
            except AssertionError as exc:
                if self.verbose:
                    print(str(exc))
                self.samples = None
                return None

        self.samples = samples
        self.budget = budget
        self.tot_cost = samples @ self.costs
        for n in range(self.n_outputs):
            self.SAPS[n].samples = samples[self.mappings[n]]
        return samples

    def sdp_solve(self, budget, solver_params=None):
        """Budget mode without caps through the direct eps form + ray
        rescale, falling through to the budget epigraph (+ level
        bisection) when the >=1-sample rows bind at the budget scale."""
        es, rhs = [], []
        cone_solve, params, allowed = cone_backend("ipm")
        if solver_params:
            params.update({k: v for k, v in solver_params.items()
                           if k in allowed})
        psis = [s.psi for s in self.SAPS]
        e_rows = self._e_rows()

        m_ray = None
        e_common = max(np.sqrt(CC[0, 0]) for CC in self.C) / 100.0
        m = self._direct_eps_solve(
            np.full(self.n_outputs, e_common), e_rows, psis, params,
            cone_solve)
        # homogeneity needs the >=1-sample rows slack at the SOLVE scale:
        # if one binds (e.m near 1), re-solve at the tolerance that puts
        # the optimizer well inside that halfspace (e.m ~ 20)
        if m is not None:
            lhs = min(float(ee @ m) for ee in e_rows)
            if lhs < 10.0:
                m2 = self._direct_eps_solve(
                    np.full(self.n_outputs,
                            e_common * np.sqrt(max(lhs, 1.0) / 20.0)),
                    e_rows, psis, params, cone_solve)
                if m2 is not None:
                    m = m2
        if m is not None and float(m @ self.costs) > 0:
            m_ray = m * (budget / float(m @ self.costs))
            if min(float(ee @ m_ray) for ee in e_rows) >= 1.0 - 1e-9:
                return m_ray
        # the >=1 rows are active at the budget scale (inhomogeneous
        # regime): budget epigraph, then the level bisection rescue
        c, Gl, hl, As, Hs, _ = cones.build_budget_sdp(
            psis, self.mappings, self.L, self.costs, e_rows, budget, es, rhs)
        res = cone_solve(c, Gl, hl, As, Hs, verbose=self.verbose, **params)
        certmod.record(self.certificates, "budget-epigraph", res)
        m_epi = None
        if res.status in _OK_STATUSES:
            m_epi = np.maximum(res.x[1:], 0) * budget
            # an "inaccurate" epigraph point can overspend by orders of
            # magnitude -- treat infeasible ones as failed
            if float(m_epi @ self.costs) > 1.0001 * budget:
                m_epi = None
        if m_epi is not None and certmod.is_tight(self.certificates[-1]):
            return m_epi

        def cost_at(v):
            mv = self._direct_eps_solve(np.full(self.n_outputs, np.sqrt(v)),
                                        e_rows, psis, params, cone_solve,
                                        validate=True)
            if mv is None:
                return None, np.inf, (self.certificates[-1]["status"]
                                      == "infeasible")
            return mv, float(mv @ self.costs), False

        v = self._max_variance(m_epi) if m_epi is not None else np.inf
        if (not np.isfinite(v) or v <= 0) and m_ray is not None:
            v = self._max_variance(m_ray)
        if not np.isfinite(v) or v <= 0:
            v = max(CC[0, 0] for CC in self.C) / 1e4
        m_bis = budget_level_bisection(cost_at, v, budget)
        if m_bis is not None and m_epi is not None:
            return min((m_bis, m_epi), key=lambda mm: self._max_variance(mm))
        return m_bis if m_bis is not None else m_epi

    def _max_variance(self, m):
        """max_n V_n(m) (the cutoff-dodging evaluation; inf on failure)."""
        return max(self._eps_ratio_n(m, np.ones(self.n_outputs), n)
                   for n in range(self.n_outputs))

    def _direct_eps_solve(self, eps, e_rows, psis, params, cone_solve,
                          validate: bool = False):
        """Direct eps-form SDP with the meps conditioning rescale;
        ``validate`` tolerance-checks the point (V_n <= 1.05 eps_n^2)."""
        n_mc = max(CC[0, 0] / ep ** 2 for CC, ep in zip(self.C, eps))
        meps = 100.0 / np.sqrt(n_mc)
        c, Gl, hl, As, Hs, _ = cones.build_eps_sdp(
            psis, self.mappings, self.L, self.costs, e_rows,
            np.asarray(eps) / meps, meps)
        res = cone_solve(c, Gl, hl, As, Hs, verbose=self.verbose, **params)
        certmod.record(self.certificates, "direct-eps", res)
        if res.status not in _OK_STATUSES:
            return None
        m = np.maximum(res.x, 0) / meps ** 2
        if validate:
            ratio = max(self._eps_ratio_n(m, eps, n)
                        for n in range(self.n_outputs))
            if not np.isfinite(ratio) or ratio > 1.05:
                return None
        return m

    def _eps_ratio_n(self, m, eps, n):
        """V_n(m)/eps_n^2 via the cutoff-dodging scale trick."""
        m = np.maximum(np.asarray(m, dtype=float), 0)
        if m.max() <= 0:
            return np.inf
        Ksc = 1.0 / m.max()
        try:
            r = (Ksc * self.SAPS[n].variance(Ksc * m[self.mappings[n]])
                 / eps[n] ** 2)
        except (AssertionError, np.linalg.LinAlgError):
            return np.inf
        return r if np.isfinite(r) else np.inf

    # ------------------------ cleanup sparsifier ----------------------- #

    def cleanup_solution(self, m, delta: float = 0.0, tol: float = 0.0):
        """Null-space walk reducing the number of active groups without
        worsening the max variance (reference mosap.py:125-210)."""
        from scipy.linalg import null_space

        m = np.asarray(m, dtype=float).copy()
        N, w = self.N, self.costs
        E = np.vstack(self._e_rows())

        idx = np.where(m > tol)[0]
        V0 = max(self.variances(m, delta=delta))
        V = V0
        if self.verbose:
            print("Solution cleanup started: nnz=%d, variance=%e"
                  % (len(idx), V))
        while len(idx) > N:
            idx = np.where(m > tol)[0]
            m[m < tol] = 0
            wr = w[idx]
            Er = E[:, idx]

            X = self.get_cleanup_matrices(m, delta=delta)[:, idx]
            NN = null_space(X)
            vals = wr @ NN
            signs = np.sign(vals)
            NN[:, signs > 0] *= -1
            vals[signs > 0] *= -1
            NN = NN[:, np.abs(signs) > 0]
            vals = vals[np.abs(signs) > 0]
            order = np.argsort(np.abs(vals))[::-1]
            nullsize = len(vals)
            if nullsize == 0:
                break
            em = Er @ m[idx]

            smax = 0.0
            for j in range(nullsize):
                t = NN[:, order[j]]
                evals = Er @ t
                neg = np.where(evals < 0)[0]
                smax1 = np.inf if len(neg) == 0 else \
                    np.min(np.abs(em[neg] - 1) / np.abs(evals[neg]))
                neg = np.where(t < 0)[0]
                smax2 = np.inf if len(neg) == 0 else \
                    np.min(m[idx][neg] / np.abs(t[neg]))
                smax = max(min(smax1, smax2), 0.0)
                if smax > 5 * tol:
                    tt = np.zeros_like(m)
                    tt[idx] = t
                    mnew = m + smax * tt
                    Vn = max(self.variances(mnew, delta=delta))
                    if Vn < V0 or abs(Vn - V0) / abs(V0) < 1.0e-4:
                        m = mnew
                        V = Vn
                        break
                    smax = 0.0
            if smax <= 5 * tol:
                break

        m[m < tol] = 0
        if self.verbose:
            print("Solution cleanup done: nnz=%d, variance=%e"
                  % (int(np.sum(m > tol)), max(self.variances(m, delta=delta))))
        return m

    # ------------------------ integer projection ----------------------- #

    def integer_projection(self, samples, budget):
        """(reference mosap.py:212-289), budget mode without caps."""
        if self.verbose:
            print("Integer projection...")
        ss = np.asarray(samples, dtype=float).copy()
        psis = [s.psi for s in self.SAPS]
        no_caps = ([], [])

        out, fval = best_integer_blue_multi(
            ss, psis, self.costs, self.e, self.mappings, budget=budget,
            max_samples_info=no_caps)

        css = None
        if np.isinf(fval):
            if self.verbose:
                print("Integer projection failed; trying cleanup...")
            css = self.cleanup_solution(ss.copy())
            out, fval = best_integer_blue_multi(
                css, psis, self.costs, self.e, self.mappings, budget=budget,
                max_samples_info=no_caps)

        if np.isinf(fval):
            for i in reversed(range(4)):
                fac = 10.0 ** -i
                nb = budget * (1 + fac)
                if self.verbose:
                    print("WARNING! Increasing budget by %g." % (1 + fac))
                out, fval = best_integer_blue_multi(
                    ss, psis, self.costs, self.e, self.mappings, budget=nb,
                    max_samples_info=no_caps)
                if np.isinf(fval):
                    out, fval = best_integer_blue_multi(
                        css, psis, self.costs, self.e, self.mappings,
                        budget=nb, max_samples_info=no_caps)
                if not np.isinf(fval):
                    break

        if np.isinf(fval):
            out = self._round_fallback(ss, css)
        return np.asarray(out, dtype=np.int64)

    def _round_fallback(self, ss, css):
        """Last-resort rounding (reference mosap.py:249-287), budget mode
        without caps: the cheaper of the two rounded-up points."""
        if css is None:
            css = ss
        ssc, cssc = np.ceil(ss), np.ceil(css)
        return ssc if ssc @ self.costs < cssc @ self.costs else cssc

    # ------------------------ estimator assembly ----------------------- #

    def compute_BLUE_estimators(self, sums, samples):
        """(mus, Vars) per output (reference mosap.py:113-123)."""
        samples = np.asarray(samples, dtype=float)
        mus, Vs = [], []
        for n in range(self.n_outputs):
            sums_n = [sums[n][g] for g in self.mappings[n]]
            mu, v = self.SAPS[n].compute_BLUE_estimator(
                sums_n, samples=samples[self.mappings[n]])
            mus.append(mu)
            Vs.append(v)
        return mus, np.array(Vs)
