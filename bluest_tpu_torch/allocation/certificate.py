"""Optimality certificates for the continuous allocation solves.

The reference cross-validates its allocations by running several vendor
solvers on the same instance (cvxopt/cvxpy/scipy/ipopt; e.g. the
``solver_test`` blocks in examples/paper_examples/navier_stokes/
bluest_NS.py:124-140).  Those vendors are not available here, so instead
every cone solve records its *internal* certificate (duality gap +
primal/dual residuals from the homogeneous self-dual IPM,
solvers/sdp.py), and an *independent* first-order KKT verifier re-checks
the returned point using only the variance/gradient closures -- a
completely separate code path from the IPM's algebra.

KKT conditions verified (min-cost form, ``min w.m`` s.t.
``V_n(m) <= eps_n^2``, ``m >= 0``):

* stationarity:      ``w = sum_n lambda_n (-grad V_n) + mu``
* dual feasibility:  ``lambda >= 0``, ``mu >= 0``
* complementarity:   ``mu_i m_i = 0``, ``lambda_n (eps_n^2 - V_n) = 0``

Budget-mode points are verified against their own achieved variances:
by homogeneity the min-max-variance point at cost ``B`` is exactly the
min-cost point at tolerance ``eps_n = sqrt(V_n(m*))`` (the two problems
share a Pareto frontier), so one verifier covers both modes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def cone_certificate(form: str, res) -> Dict:
    """Flatten a solvers.sdp.ConeLPResult into a report dict."""
    relgap = float(res.gap) / max(1.0, abs(float(res.pobj)))
    cert = {
        "form": form,
        "status": res.status,
        "iterations": int(res.iterations),
        "relgap": relgap,
        "pres": float(res.pres),
        "dres": float(res.dres),
        "pobj": float(res.pobj),
    }
    # problem shape (nx/p/nb/n/rank/woodbury) for flops accounting --
    # absent on results from non-cone solvers (NLP fallback points)
    if getattr(res, "dims", None):
        cert["dims"] = dict(res.dims)
    return cert


def record(certificates: List[Dict], form: str, res) -> Dict:
    cert = cone_certificate(form, res)
    certificates.append(cert)
    return cert


def kkt_certificate(m, costs, grad_fns, variances, eps=None,
                    active_rtol: float = 1e-6) -> Dict:
    """First-order KKT report for a continuous allocation point.

    Parameters
    ----------
    m : (L,) continuous allocation.
    costs : (L,) per-group costs ``w``.
    grad_fns : list of callables, ``grad_fns[n](m) -> (L,) dV_n/dm``
        (each embeds its output's group mapping; zero off-support).
    variances : (n_outputs,) achieved variances ``V_n(m)``.
    eps : optional per-output tolerances; if None (budget mode) the
        point is verified at its own achieved variances.

    Returns a dict with ``stationarity`` (relative residual of the
    active-coordinate stationarity system), ``dual_infeasibility``
    (most negative reduced cost on the inactive set, relative),
    ``primal_feasibility`` (max_n V_n/eps_n^2 - 1) and
    ``complementarity``.  All should be small (<= ~1e-4) at an optimum.
    """
    m = np.asarray(m, dtype=float)
    w = np.asarray(costs, dtype=float)
    variances = np.asarray(variances, dtype=float)
    if eps is None:
        epsq = variances.copy()           # self-consistent tolerances
    else:
        epsq = np.asarray(eps, dtype=float) ** 2

    G = np.stack([np.asarray(g(m), dtype=float) for g in grad_fns])  # (No, L)

    active = m > active_rtol * m.max()
    wa = w[active]
    Ga = -G[:, active].T                                  # (nA, No), >= 0ish
    # lambda >= 0 least squares on the active coordinates
    try:
        from scipy.optimize import nnls
        lam, _ = nnls(Ga, wa)
    except Exception:                                     # pragma: no cover
        lam, *_ = np.linalg.lstsq(Ga, wa, rcond=None)
        lam = np.maximum(lam, 0.0)

    r_stat = np.linalg.norm(Ga @ lam - wa) / max(np.linalg.norm(wa), 1e-300)
    mu = w + G.T @ lam                                    # reduced costs
    dual_inf = max(0.0, float(-(mu[~active].min() / max(np.abs(w).max(),
                                                        1e-300)))
                   ) if (~active).any() else 0.0
    primal = float(np.max(variances / epsq) - 1.0)
    lam_scale = max(float(lam.max()), 1e-300)
    comp = float(np.max((lam / lam_scale) * np.abs(1.0 - variances / epsq)))
    return {
        "stationarity": float(r_stat),
        "dual_infeasibility": float(dual_inf),
        "primal_feasibility": primal,
        "complementarity": comp,
        "multipliers": lam,
        "n_active": int(active.sum()),
    }


def is_tight(cert, relgap: float = 1e-5, pres: float = 1e-7,
             dres: float = 1e-6) -> bool:
    """Certificate quality gate for skipping redundant cross-check
    solves.  All three residuals must be certified: without dual
    feasibility (dres) the duality gap does not bound suboptimality."""
    return (cert["status"] in ("optimal", "inaccurate")
            and cert["relgap"] <= relgap
            and cert["pres"] <= pres
            and cert["dres"] <= dres)
