"""Closed-form MLMC and MFMC allocation (reference misc.py:15-130, 416-449).

Port of ``bluest_tpu/estimators/closed_forms.py``, numpy on the host as
there: tiny computations (M <= tens of levels) whose corner candidates are
enumerated with ``solvers/integer.py``'s bounds and corner matrix.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..solvers.integer import (best_integer_generic, corner_matrix,
                               feasible_integer_bounds)


def _corner_values(sol, N):
    """All floor/ceil corner candidates as rows (B, L) plus the rounded
    base vector (vectorized variant of the reference's per-corner Python
    loop, misc.py:384-413)."""
    sol = np.asarray(sol, dtype=float)
    lb, ub, idx = feasible_integer_bounds(sol, N)
    if len(idx) > 24:
        raise ValueError("Too many dimensions to brute-force it")
    ms = corner_matrix(lb, ub)                   # (LL, B)
    vals = np.tile(np.round(sol).astype(np.int64), (ms.shape[1], 1))
    vals[:, idx] = ms.T
    return vals


def _select_best(vals, feas, obj):
    if not np.any(feas):
        return None, np.inf
    objs = np.where(feas, obj, np.inf)
    i = int(np.argmin(objs))
    return vals[i], float(objs[i])


def mlmc_allocation(v, w, budget: Optional[float] = None,
                    eps: Optional[float] = None,
                    continuous_relaxation: bool = False):
    """Optimal MLMC level allocation m_l ~ sqrt(v_l / w_l)
    (reference attempt_mlmc_setup, misc.py:15-46).

    v: per-level variances of the telescoped differences; w: per-level costs.
    Returns (feasible, data dict) with samples/error/total_cost/variance.
    """
    if budget is None and eps is None:
        raise ValueError("Need to specify either budget or RMSE tolerance")
    if budget is not None:
        eps = None

    v = np.asarray(v, dtype=float)
    w = np.asarray(w, dtype=float)
    if not np.all(np.isfinite(v)):
        return False, None

    q = np.sum(np.sqrt(v * w))
    mu = budget / q if budget is not None else q / eps ** 2
    m = np.maximum(mu * np.sqrt(v / w), 1.0)

    def variance(mm):
        mm = np.asarray(mm, dtype=float)
        pos = mm > 0
        return float(np.sum(v[pos] / mm[pos]))

    if budget is not None:
        constraint = lambda mm: mm @ w <= budget and np.all(mm >= 1)
        obj = variance
    else:
        constraint = lambda mm: variance(mm) <= eps ** 2 and np.all(mm >= 1)
        obj = lambda mm: mm @ w

    if not continuous_relaxation:
        vals = _corner_values(m, len(v))
        safe = np.maximum(vals, 1)
        var_all = np.sum(np.where(vals > 0, v[None, :] / safe, 0.0), axis=1)
        cost_all = vals @ w
        ge1 = np.all(vals >= 1, axis=1)
        if budget is not None:
            feas = (cost_all <= budget) & ge1
            m, fval = _select_best(vals, feas, var_all)
        else:
            feas = (var_all <= eps ** 2) & ge1
            m, fval = _select_best(vals, feas, cost_all)
        if m is None or np.isinf(fval):
            return False, None

    return True, {"samples": m, "error": float(np.sqrt(variance(m))),
                  "total_cost": float(m @ w), "variance": variance}


def mlmc_bounds_batch(V, W, mask, budget: Optional[float] = None,
                      eps: Optional[float] = None):
    """Continuous lower bounds for a padded batch of MLMC chains.

    V, W: (B, Lmax) per-level variances/costs, padded entries arbitrary;
    mask: (B, Lmax) validity.  Returns (feasible (B,), bound (B,)) where
    ``bound`` is a LOWER bound on the chain's pass-2 objective:

      * budget mode: the error of the m >= 1-clamped continuous optimum
        (valid: every integer-feasible schedule is dominated by it);
      * eps mode: q^2 / eps^2 / 1.0001 with q = sum sqrt(v w) -- the
        UNCLAMPED continuous cost deflated by the integer search's
        feasibility slack.  The clamped continuous cost is NOT a lower
        bound here (clamping without redistribution is suboptimal and the
        corner search accepts variance <= 1.0001 eps^2), so using it could
        prune the true optimum.
    """
    V = np.asarray(V, dtype=float)
    W = np.asarray(W, dtype=float)
    feasible = np.all(np.where(mask, np.isfinite(V), True), axis=1)
    Vs = np.where(mask & np.isfinite(V), V, 0.0)
    Ws = np.where(mask, W, 0.0)
    q = np.sqrt(np.clip(Vs * Ws, 0.0, None)).sum(axis=1)
    ok = feasible & (q > 0)
    qs = np.where(ok, q, 1.0)
    if budget is not None:
        mu = budget / qs
        ratio = np.divide(Vs, Ws, out=np.zeros_like(Vs), where=Ws > 0)
        m = np.maximum(mu[:, None] * np.sqrt(ratio), 1.0)
        var = np.where(mask, Vs / m, 0.0).sum(axis=1)
        bound = np.sqrt(var)
    else:
        bound = qs ** 2 / eps ** 2 / 1.0001
    return feasible, np.where(ok, bound, np.inf)


def _mfmc_prepare(sigmas, rhos, costs, order=None):
    """Sort models by |rho| descending and compute the feasibility ratios
    (reference misc.py:52-67, 88-104).

    ``order``: force this estimator order instead of sorting.  Used by
    the multi-output clique search when outputs disagree on the sorted
    order only through near-ties: the MFMC variance formula is exact for
    ANY order (it is just the telescoped control-variate variance), so a
    forced common order with the exact corner-search validation stays a
    valid estimator; the strict ratio feasibility gate is deferred to
    the search in that mode (it encodes optimality of the analytic seed,
    not validity)."""
    sigmas = np.asarray(sigmas, dtype=float)
    rhos = np.asarray(rhos, dtype=float)
    costs = np.asarray(costs, dtype=float)
    if order is None:
        # stable descending sort: reversing an ascending argsort reverses
        # tie order, so a low-fidelity model PERFECTLY correlated with
        # model 0 (|rho| = 1) could land first and trip the assert
        idx = np.argsort(-np.abs(rhos), kind="stable")
    else:
        idx = np.asarray(order, dtype=int)
    assert idx[0] == 0
    s = sigmas[idx]
    rho = np.concatenate([rhos[idx], [0.0]])
    w = costs[idx]
    if order is None:
        cost_ratio = w[:-1] / w[1:]
        rho_ratio = (rho[:-2] ** 2 - rho[1:-1] ** 2) \
            / (rho[1:-1] ** 2 - rho[2:] ** 2)
        feasible = bool(np.all(cost_ratio > rho_ratio))
    else:
        feasible = True
    alphas = rho[1:-1] * s[0] / s[1:]
    return idx, s, rho, w, feasible, alphas


def _mfmc_variance(s, rho, alphas):
    def variance(m):
        m = np.asarray(m, dtype=float)
        return float(s[0] ** 2 / m[0] + np.sum(
            (1.0 / m[:-1] - 1.0 / m[1:])
            * (alphas ** 2 * s[1:] ** 2 - 2 * alphas * rho[1:-1] * s[0] * s[1:])))
    return variance


def mfmc_check(sigmas, rhos, costs, samples):
    """Evaluate a user-prescribed MFMC sample schedule
    (reference compute_mfmc_data, misc.py:48-76)."""
    if not np.all(np.isfinite(sigmas)):
        return False, None
    idx, s, rho, w, feasible, alphas = _mfmc_prepare(sigmas, rhos, costs)
    if not feasible:
        return False, None
    m = np.asarray(samples, dtype=float)[idx]
    variance = _mfmc_variance(s, rho, alphas)
    var = variance(m)
    return True, {"samples": m, "error": float(np.sqrt(var)),
                  "total_cost": float(m @ w), "alphas": alphas,
                  "variance": var, "order": idx}


def mfmc_allocation(sigmas, rhos, costs, budget: Optional[float] = None,
                    eps: Optional[float] = None,
                    continuous_relaxation: bool = False,
                    small_budget: bool = False, order=None):
    """Optimal MFMC allocation (reference attempt_mfmc_setup,
    misc.py:78-130), including the Gruber et al. 2022 low-budget scheme.
    ``order`` forces the estimator order (see _mfmc_prepare)."""
    if budget is None and eps is None:
        raise ValueError("Need to specify either budget or RMSE tolerance")
    if budget is not None:
        eps = None

    sigmas = np.asarray(sigmas, dtype=float)
    if not np.all(np.isfinite(sigmas)):
        return False, None

    idx, s, rho, w, feasible, alphas = _mfmc_prepare(sigmas, rhos, costs,
                                                     order=order)
    if not feasible:
        return feasible, None

    # forced orders may invert a near-tie; clamping the level gain at 0
    # is the exact continuous limit of a tie (that level simply adds no
    # samples) and keeps the seed real -- the search below validates
    # against the EXACT variance either way
    gains = rho[:-1] ** 2 - rho[1:] ** 2
    if order is not None:
        gains = np.maximum(gains, 0.0)
    r = np.sqrt(w[0] / w * gains / (1 - rho[1] ** 2))
    if budget is not None:
        m1 = budget / (w @ r)
    else:
        m1 = eps ** -2 * (w @ r) * (s[0] ** 2 / w[0]) * (1 - rho[1] ** 2)
    m = np.maximum(np.concatenate([[m1], m1 * r[1:]]), 1.0)
    if order is not None:
        # a clamped (tied/inverted) level got r = 0 -> m = 1, which
        # breaks the m_1 <= m_2 <= ... nesting; the correct tie limit is
        # m_i = m_{i-1} (the tied model adds no NEW samples), i.e. a
        # running max.  With clamped gains the closed-form eps identity
        # is also only approximate -- one homogeneity rescale restores
        # variance ~= eps^2 before the corner search brackets it.
        m = np.maximum.accumulate(m)
        if eps is not None:
            v0 = _mfmc_variance(s, rho, alphas)(m)
            if np.isfinite(v0) and v0 > 0:
                m = np.maximum(np.maximum.accumulate(m * (v0 / eps ** 2)),
                               1.0)

    variance = _mfmc_variance(s, rho, alphas)
    if budget is not None:
        constraint = lambda mm: (mm @ w <= budget and mm[0] >= 1
                                 and np.all(mm[:-1] <= mm[1:]))
        obj = variance
    else:
        constraint = lambda mm: (variance(mm) <= eps ** 2 and mm[0] >= 1
                                 and np.all(mm[:-1] <= mm[1:]))
        obj = lambda mm: mm @ w

    if not continuous_relaxation:
        if small_budget and budget is not None:
            m = mfmc_low_budget(np.asarray(rhos, dtype=float)[idx], w, budget,
                                clamp=order is not None)
        else:
            vals = _corner_values(m, len(sigmas))
            safe = np.maximum(vals, 1)
            coef = alphas ** 2 * s[1:] ** 2 - 2 * alphas * rho[1:-1] * s[0] * s[1:]
            var_all = (s[0] ** 2 / safe[:, 0]
                       + np.sum((1.0 / safe[:, :-1] - 1.0 / safe[:, 1:])
                                * coef[None, :], axis=1))
            cost_all = vals @ w
            mono = np.all(vals[:, :-1] <= vals[:, 1:], axis=1) & (vals[:, 0] >= 1)
            if budget is not None:
                feas = (cost_all <= budget) & mono
                m, fval = _select_best(vals, feas, var_all)
            else:
                feas = (var_all <= eps ** 2) & mono
                m, fval = _select_best(vals, feas, cost_all)
            if m is None or np.isinf(fval):
                return False, None

    return feasible, {"samples": m, "error": float(np.sqrt(variance(m))),
                      "total_cost": float(m @ w), "alphas": alphas,
                      "variance": variance, "order": idx}


def mfmc_low_budget(rhos, costs, budget, clamp: bool = False):
    """Low-budget MFMC integer schedule, Gruber et al. 2022
    (reference mfmc_low_budget_integer_solution, misc.py:416-449).

    ``clamp=True`` is the forced-common-order path (setup_mfmc's
    order-disagreement rescue): an inverted near-tie makes a level gain
    rho_i^2 - rho_{i+1}^2 negative, which the unclamped formula feeds
    into a sqrt (NaN schedule).  As in mfmc_allocation, clamping the
    gain at 0 is the exact continuous limit of a tie -- that level adds
    no NEW samples -- which the running max then encodes as
    m_i = m_{i-1}.  On a naturally |rho|-sorted input every gain is
    already >= 0 and clamp is a no-op."""
    rhos = np.asarray(rhos, dtype=float)
    costs = np.asarray(costs, dtype=float)
    if rhos.shape[0] == 1:
        return np.array([np.floor(budget / costs[0])], dtype=np.int64)

    rho = np.concatenate([rhos, [0.0]])
    gains = rho[:-1] ** 2 - rho[1:] ** 2
    if clamp:
        gains = np.maximum(gains, 0.0)
    denom = gains[0]
    r = np.sqrt(costs[0] / costs * gains / max(denom, 1e-300))
    r[0] = 1.0                       # exact; robust to denom ~ 0 ties
    m1 = budget / (costs @ r)
    m = np.concatenate([[m1], m1 * r[1:]])
    if clamp:
        m = np.maximum.accumulate(m)   # tied level: no new samples
    if m[0] >= 1:
        return np.floor(m).astype(np.int64)
    m[0] = 1
    m_sub = mfmc_low_budget(rhos[1:], costs[1:], budget - costs[0],
                            clamp=clamp)
    m[1:] = m_sub
    return m.astype(np.int64)
