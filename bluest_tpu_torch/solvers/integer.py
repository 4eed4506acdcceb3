"""Integer rounding of continuous sample allocations.

Port of ``bluest_tpu/solvers/integer.py``: the single-output corner
search (``best_integer_blue``), the multi-output one
(``best_integer_blue_multi``) and the generic one the MLMC/MFMC closed
forms run (``best_integer_generic``; misc.py:134-413 of the reference): pick
the ~1.2*N largest allocation entries, enumerate all floor/ceil corners
(2^LL of them), and select the best feasible corner.  The batched
evaluation -- thousands of (M x M) Hermitian pseudo-inverses -- is one
batched ``torch.linalg.eigh`` per chunk on the allocation device;
everything else is host bookkeeping, identical to the JAX package
(including its documented divergences from the reference: intersection
coverage filter, deterministic greedy rounding past the brute-force
limit).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import allocation_device

_PINV_RCOND = 1.0e-10
_CHUNK = 8192


def feasible_integer_bounds(sol: np.ndarray, N: int, e: np.ndarray | None = None):
    """Floor/ceil bounds over the entries worth optimizing
    (reference get_feasible_integer_bounds, misc.py:141-167)."""
    sol = np.asarray(sol, dtype=float)
    L = len(sol)
    idx = np.argsort(sol)[-int(1.2 * N):]
    idx = np.array([i for i in idx if sol[i] > 1.0e-8], dtype=int)

    if e is not None:
        e = np.asarray(e, dtype=float)
        if np.sum(e > 0.99) == 0:
            val = 1.0 / np.sum(e) / 2
            while np.sum(e > val) == 0:
                val /= 2
        else:
            val = 0.99
        idx2 = np.where(e > val)[0]
        order = np.argsort(sol[e > val])[::-1]
        idx2 = idx2[order[:N]]
        idx = np.unique(np.concatenate([idx, idx2])).astype(int)

    lb = np.zeros(L, dtype=np.int64)
    ub = np.zeros(L, dtype=np.int64)
    lb[idx] = np.floor(sol[idx]).astype(np.int64)
    ub[idx] = np.ceil(sol[idx]).astype(np.int64)
    # entries already integral carry no search freedom
    idx = idx[lb[idx] < ub[idx]]
    order = np.argsort(lb[idx])[::-1]
    idx = idx[order]
    return lb[idx], ub[idx], idx


def corner_matrix(lb: np.ndarray, ub: np.ndarray) -> np.ndarray:
    """All floor/ceil corners as columns: (LL, 2^LL), built row by row in
    int32 (reference unpackbits + fancy indexing, misc.py:169-175)."""
    LL = len(lb)
    n = 1 << LL
    cols = np.arange(n, dtype=np.uint32)
    out = np.empty((LL, n), dtype=np.int32)
    for j in range(LL):
        bit = (cols >> np.uint32(j)) & np.uint32(1)
        out[j] = np.where(bit.astype(bool), np.int32(ub[j]), np.int32(lb[j]))
    return out


def _chunk_var00(P: torch.Tensor) -> torch.Tensor:
    """pinv(P_b)[0, 0] for a (C, M, M) batch via one batched eigh."""
    w, V = torch.linalg.eigh(P)
    cutoff = _PINV_RCOND * torch.max(torch.abs(w), dim=-1, keepdim=True).values
    inv_w = torch.where(torch.abs(w) > cutoff, 1.0 / w,
                        torch.zeros((), dtype=w.dtype, device=w.device))
    v0 = V[:, 0, :]  # first row of V
    return torch.sum(v0 * inv_w * v0, dim=-1)


def _corner_variances(basephi: np.ndarray, psi_idx: np.ndarray,
                      ms: np.ndarray) -> np.ndarray:
    """Variances of all corner candidates: the corner PHIs are assembled
    and inverted chunk by chunk on the allocation device."""
    dev = allocation_device()
    M = int(round(np.sqrt(basephi.shape[0])))
    bphi = torch.as_tensor(basephi, dtype=torch.float64, device=dev)
    pidx = torch.as_tensor(psi_idx, dtype=torch.float64, device=dev)
    LL, B = ms.shape
    out = []
    for s in range(0, B, _CHUNK):
        # (a copy: callers hand in reversed column views, and torch takes
        # no negative strides)
        chunk = torch.as_tensor(np.ascontiguousarray(ms[:, s:s + _CHUNK]),
                                dtype=torch.float64, device=dev)
        phis = (bphi[:, None] + pidx @ chunk).T.reshape(-1, M, M)
        out.append(_chunk_var00(phis).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def best_integer_generic(sol, obj: Callable, constr: Callable, N: int,
                         e: np.ndarray | None = None):
    """Generic corner search with Python-callable objective/constraint
    (reference best_closest_integer_solution, misc.py:384-413).  Used by the
    MLMC/MFMC closed forms where LL is tiny."""
    sol = np.asarray(sol, dtype=float)
    lb, ub, idx = feasible_integer_bounds(sol, N, e=e)
    LL = len(idx)
    if LL > 24:
        raise ValueError("Too many dimensions to brute-force it")

    ms = corner_matrix(lb, ub)  # (LL, 2^LL)
    val = np.round(sol).astype(np.int64)
    best_fval = np.inf
    best = None
    for i in range(ms.shape[1]):
        val[idx] = ms[:, i]
        if constr(val):
            f = obj(val)
            if f < best_fval:
                best_fval = f
                best = val.copy()
    if best is None:
        return None, np.inf
    return best, best_fval


def _batch_variances_multi(vals, psis, mappings):
    """Per-output variances of a batch of full integer allocations:
    vals (L, B) -> list of (B,) arrays (pinv(PHI_n)[0,0])."""
    dev = allocation_device()
    out = []
    for n in range(len(mappings)):
        Phi = psis[n] @ vals[mappings[n], :].astype(np.float64)  # (M^2, B)
        M = int(round(np.sqrt(psis[n].shape[0])))
        phis = torch.as_tensor(Phi.T.reshape(-1, M, M), dtype=torch.float64,
                               device=dev)
        out.append(_chunk_var00(phis).cpu().numpy())
    return out


def _feasible_multi(vals, psis, w, e, mappings, budget, eps,
                    max_samples_info, slack=1.0001):
    """(feasible mask, max-variance, cost) for a batch of allocations
    (L, B), enforcing coverage, caps, and the budget/eps constraint."""
    No = len(mappings)
    costs = w @ vals
    ok = np.ones(vals.shape[1], dtype=bool)
    for n in range(No):
        ok &= e[mappings[n]] @ vals[mappings[n], :] >= 1.0
    ES, rhs = max_samples_info
    for ees, rr in zip(ES, rhs):
        ok &= np.asarray(ees) @ vals <= rr
    Vs = _batch_variances_multi(vals, psis, mappings)
    V_max = np.max(np.stack(Vs), axis=0)
    if budget is not None:
        ok &= costs <= slack * budget
    else:
        epsa = np.asarray(eps, dtype=float)
        for n in range(No):
            ok &= Vs[n] <= slack * epsa[n] ** 2
    return ok, V_max, costs


def _greedy_round_multi(sol, psis, w, e, mappings, budget, eps,
                        max_samples_info):
    """Deterministic greedy rounding for LL past the brute-force limit
    (see bluest_tpu/solvers/integer.py:_greedy_round_multi)."""
    sol = np.maximum(np.asarray(sol, dtype=float), 0.0)
    if sol.max() > 0:
        sol[sol < 1e-8 * sol.max()] = 0.0
    floors = np.floor(sol).astype(np.int64)
    ceils = np.ceil(sol).astype(np.int64)
    frac = np.where(floors < ceils)[0]
    if budget is None:
        val = ceils.copy()
        target = floors
        for beta in (1.0, 1.0002, 1.001, 1.01):
            val = np.ceil(beta * sol).astype(np.int64)
            ok0, _, _ = _feasible_multi(val[:, None].astype(np.float64),
                                        psis, w, e, mappings, budget, eps,
                                        max_samples_info)
            if ok0[0]:
                break
    else:
        val = floors.copy()
        target = ceils
        for n in range(len(mappings)):
            en = e[mappings[n]]
            while en @ val[mappings[n]] < 1.0:
                cand = [i for i in frac
                        if val[i] < ceils[i] and e[i] > 0
                        and int(i) in set(int(g) for g in mappings[n])]
                if not cand:
                    break
                i = min(cand, key=lambda i: w[i])
                val[i] = ceils[i]
    ok0, V0, cost0 = _feasible_multi(val[:, None].astype(np.float64), psis,
                                     w, e, mappings, budget, eps,
                                     max_samples_info)
    if not ok0[0]:
        return None, np.inf
    free = [int(i) for i in frac if val[i] != target[i]]
    while free:
        B = len(free)
        vals = np.repeat(val[:, None], B, axis=1).astype(np.float64)
        for j, i in enumerate(free):
            vals[i, j] = target[i]
        ok, V_max, costs = _feasible_multi(vals, psis, w, e, mappings,
                                           budget, eps, max_samples_info)
        cand = [j for j in range(B) if ok[j]]
        if not cand:
            break
        if budget is None:
            j = max(cand, key=lambda j: w[free[j]])
        else:
            j = min(cand, key=lambda j: V_max[j])
        val[free[j]] = target[free[j]]
        free.pop(j)

    ok, V_max, costs = _feasible_multi(val[:, None].astype(np.float64), psis,
                                       w, e, mappings, budget, eps,
                                       max_samples_info)
    if not ok[0]:
        return None, np.inf
    return val, float(V_max[0])


def best_integer_blue_multi(sol, psis: Sequence[np.ndarray], w: np.ndarray,
                            e: np.ndarray, mappings: Sequence[np.ndarray],
                            budget: Optional[float] = None,
                            eps=None, max_samples_info=((), ()),
                            rng: np.random.Generator | None = None,
                            ll_max: int = 15, n_trials: int = 64):
    """Multi-output BLUE corner search
    (reference best_closest_integer_solution_BLUE_multi, misc.py:177-311);
    past the 2^ll_max brute-force limit: greedy round + exact polish of
    the ll_max most significant entries, randomized sweeps last."""
    sol = np.asarray(sol, dtype=float)
    N = int(round(np.sqrt(psis[0].shape[0])))

    lb_f, ub_f, idx_f = feasible_integer_bounds(sol, N, e=e)
    LL = len(idx_f)

    if LL <= ll_max:
        return _multi_helper(sol, psis, w, e, mappings, budget, eps,
                             lb_f, ub_f, idx_f, max_samples_info)

    g_val, g_fval = _greedy_round_multi(sol, psis, w, e, mappings, budget,
                                        eps, max_samples_info)
    if g_val is not None:
        order = np.argsort(sol[idx_f])[::-1]
        top = np.sort(order[:ll_max])
        r_sol = g_val.astype(float)
        p_val, p_fval = _multi_helper(
            r_sol, psis, w, e, mappings, budget, eps,
            lb_f[top], ub_f[top], idx_f[top], max_samples_info)
        if p_val is not None:
            return p_val, p_fval
        return g_val, g_fval

    if rng is None:
        rng = np.random.default_rng(0)
    for _ in range(n_trials):
        perm = rng.permutation(LL)
        bf, rc = perm[:ll_max], perm[ll_max:]
        r_sol = sol.copy()
        pick = rng.integers(2, size=len(rc))
        bnds = np.vstack([lb_f[rc], ub_f[rc]])
        r_sol[idx_f[rc]] = bnds[pick, np.arange(len(rc))]
        best_val, best_fval = _multi_helper(
            r_sol, psis, w, e, mappings, budget, eps,
            lb_f[bf], ub_f[bf], idx_f[bf], max_samples_info)
        if best_val is not None:
            return best_val, best_fval
    return None, np.inf


def _apply_max_sample_filter(ms, idx, baseval, max_samples_info):
    """Columns surviving the per-model max-sample caps
    (reference misc.py:267-276, 344-353). Returns ms or None."""
    ES, rhs = max_samples_info
    if len(ES) == 0:
        return ms
    base = [ees @ baseval for ees in ES]
    if any(b > r for b, r in zip(base, rhs)):
        return None
    checks = [b + np.asarray(ees)[idx] @ ms for b, ees in zip(base, ES)]
    mask = np.all([c <= r for c, r in zip(checks, rhs)], axis=0)
    keep = np.where(mask)[0]
    if len(keep) == 0:
        return None
    return ms[:, keep]


def best_integer_blue(sol, psi: np.ndarray, w: np.ndarray, e: np.ndarray,
                      budget: Optional[float] = None,
                      eps: Optional[float] = None,
                      max_samples_info=((), ())):
    """Single-output BLUE corner search
    (reference best_closest_integer_solution_BLUE, misc.py:313-382)."""
    sol = np.asarray(sol, dtype=float)
    N = int(round(np.sqrt(psi.shape[0])))
    lb, ub, idx = feasible_integer_bounds(sol, N, e=e)
    LL = len(idx)
    if LL > 24:
        raise ValueError("Too many dimensions to brute-force it")

    ms = corner_matrix(lb, ub)
    val = np.round(sol).astype(np.int64)
    baseval = val.copy(); baseval[idx] = 0
    basephi = psi @ baseval
    basecost = w @ baseval
    basee = e @ baseval

    if basee < 1:
        keep = np.where(basee + e[idx] @ ms >= 1)[0]
        if len(keep) == 0:
            return None, np.inf
        ms = ms[:, keep]

    ms = _apply_max_sample_filter(ms, idx, baseval, max_samples_info)
    if ms is None:
        return None, np.inf

    if budget is not None and basecost > budget:
        return None, np.inf

    costs = basecost + w[idx] @ ms
    if budget is not None:
        keep = np.where(costs <= 1.0001 * budget)[0]
        if len(keep) == 0:
            return None, np.inf
        ms = ms[:, keep][:, ::-1]
    else:
        ms = ms[:, np.argsort(costs)[::-1]]

    if ms.size == 0:
        return None, np.inf

    Vs = _corner_variances(basephi, psi[:, idx], ms)

    if budget is not None:
        i = int(np.argmin(Vs))
    else:
        ok = np.where(Vs <= 1.0001 * eps ** 2)[0]
        if len(ok) == 0:
            return None, np.inf
        i = int(ok[-1])  # columns are cost-descending: last feasible = cheapest

    val[idx] = ms[:, i]
    return val, float(Vs[i])


def _multi_helper(sol, psis, w, e, mappings, budget, eps, lb, ub, idx,
                  max_samples_info):
    """(reference ..._BLUE_multi_helper, misc.py:228-311)."""
    No = len(mappings)
    ms = corner_matrix(lb, ub)
    val = np.round(sol).astype(np.int64)
    baseval = val.copy(); baseval[idx] = 0
    basephis = [psis[n] @ baseval[mappings[n]] for n in range(No)]
    basecost = w @ baseval
    basees = [e[mappings[n]] @ baseval[mappings[n]] for n in range(No)]

    # positions within idx belonging to output n, and the matching local
    # (psi_n column) indices, both in idx order (reference misc.py:253-255)
    redmaps, idxs = [], []
    for n in range(No):
        mset = set(int(i) for i in mappings[n])
        red = [i for i in range(len(idx)) if int(idx[i]) in mset]
        loc = [int(np.where(mappings[n] == int(idx[i]))[0][0]) for i in red]
        redmaps.append(np.array(red, dtype=int))
        idxs.append(np.array(loc, dtype=int))

    if budget is not None and basecost > budget:
        return None, np.inf

    # Corner feasibility filter (budget + per-output coverage + caps): one
    # native pass over the 2^LL corners when the C library is built (bit
    # order matches corner_matrix); numpy otherwise.
    ES, rhs = max_samples_info
    if any(ees @ baseval > rr for ees, rr in zip(ES, rhs)):
        return None, np.inf
    keep_mask = None
    if lb.size:
        from .. import _native
        e_rows_l, e_base_l = [], []
        for n in range(No):
            if basees[n] < 1:
                row = np.zeros(len(idx))
                row[redmaps[n]] = e[idx][redmaps[n]]
                e_rows_l.append(row)
                e_base_l.append(basees[n])
        keep_mask = _native.corner_filter(
            lb, ub, basecost, w[idx],
            budget if budget is not None else 0.0,
            e_rows_l, e_base_l,
            [np.asarray(ees)[idx] for ees in ES],
            [rr - ees @ baseval for ees, rr in zip(ES, rhs)])
    if keep_mask is not None:
        ms = ms[:, keep_mask]
        if ms.shape[1] == 0:
            return None, np.inf
        costs = basecost + w[idx] @ ms
        if budget is None:
            ms = ms[:, np.argsort(costs)[::-1]]
    else:
        mask = np.ones(ms.shape[1], dtype=bool)
        for n in range(No):
            if basees[n] < 1:
                mask &= (basees[n]
                         + e[idx][redmaps[n]] @ ms[redmaps[n], :]) >= 1
        keep = np.where(mask)[0]
        if len(keep) == 0:
            return None, np.inf
        ms = ms[:, keep]

        ms = _apply_max_sample_filter(ms, idx, baseval, max_samples_info)
        if ms is None:
            return None, np.inf

        costs = basecost + w[idx] @ ms
        if budget is not None:
            keep = np.where(costs <= 1.0001 * budget)[0]
            if len(keep) == 0:
                return None, np.inf
            ms = ms[:, keep][:, ::-1]
        else:
            ms = ms[:, np.argsort(costs)[::-1]]
    if ms.size == 0:
        return None, np.inf

    Vs = [_corner_variances(basephis[n], psis[n][:, idxs[n]],
                            ms[redmaps[n], :]) for n in range(No)]
    V_max = np.max(np.stack(Vs), axis=0)

    if budget is not None:
        i = int(np.argmin(V_max))
    else:
        eps = np.asarray(eps, dtype=float)
        ok = np.all(np.stack([Vs[n] <= 1.0001 * eps[n] ** 2
                              for n in range(No)]), axis=0)
        ok = np.where(ok)[0]
        if len(ok) == 0:
            return None, np.inf
        i = int(ok[-1])

    val[idx] = ms[:, i]
    return val, float(V_max[i])
