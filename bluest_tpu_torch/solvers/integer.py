"""Integer rounding of continuous sample allocations.

Port of ``bluest_tpu/solvers/integer.py``: the single-output corner
search (``best_integer_blue``), the multi-output one
(``best_integer_blue_multi``) and the generic one the MLMC/MFMC closed
forms run (``best_integer_generic``; misc.py:134-413 of the reference): pick
the ~1.2*N largest allocation entries, enumerate all floor/ceil corners
(2^LL of them), and select the best feasible corner.  The batched
evaluation -- thousands of (M x M) Hermitian pseudo-inverses -- runs on
the allocation device as the JAX package runs it: the corners in chunks
of ``_CHUNK``, their PHIs assembled there and handed to K5's ``pinv00``
(``ops.psd_eig``; ``torch.linalg.eigh`` and the cutoff on the host),
every chunk of every output dispatched before any is read, then
one host read of all variances and statuses (``_gather``).  A search
uploads its inputs in one non-blocking copy a dispatch.  Everything else
is host bookkeeping, identical to the JAX package (including its
documented divergences from the reference: intersection coverage filter,
deterministic greedy rounding past the brute-force limit).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import allocation_device
from ..ops import psd_eig

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


def _upload(arrays, dev: torch.device):
    """numpy arrays -> float64 tensors on ``dev``.  On a card all of them
    go through one pinned host buffer in one non-blocking copy, which does
    not make the host wait; on the host they are the arrays' data."""
    arrays = [np.ascontiguousarray(a, dtype=np.float64) for a in arrays]
    if dev.type == "cpu":
        return [torch.from_numpy(a) for a in arrays]
    offs = np.cumsum([0] + [a.size for a in arrays])
    host = torch.empty(int(offs[-1]), dtype=torch.float64, pin_memory=True)
    flat = host.numpy()
    for a, o in zip(arrays, offs):
        flat[o:o + a.size] = a.ravel()
    buf = host.to(dev, non_blocking=True)
    return [buf[o:o + a.size].view(a.shape) for a, o in zip(arrays, offs)]


def _gather(pending):
    """Every dispatched (var, status) pair read back in one host copy:
    a list of (var, status) numpy pairs."""
    if not pending:
        return []
    flat = torch.cat([t for var, status in pending
                      for t in (var, status.to(var.dtype))]).cpu().numpy()
    out, o = [], 0
    for var, _ in pending:
        n = var.shape[0]
        out.append((flat[o:o + n], flat[o + n:o + 2 * n]))
        o += 2 * n
    return out


def _chunk_var00(P: torch.Tensor):
    """pinv(P_b)[0, 0] for a (C, M, M) batch through K5 (the plain eigh on
    the host): (var (C,), status (C,)), not read back."""
    return psd_eig.pinv00(P.contiguous(), _PINV_RCOND)


def _chunk_corner_var(basephi: torch.Tensor, psi_idx: torch.Tensor,
                      ms_chunk: torch.Tensor):
    """Fused corner-PHI assembly + Hermitian pinv[0,0] on the device:
    basephi (M^2,), psi_idx (M^2, LL), ms_chunk (LL, C) -> (var (C,),
    status (C,))."""
    M = int(round(np.sqrt(basephi.shape[0])))
    phis = (basephi[:, None] + psi_idx @ ms_chunk).T.reshape(-1, M, M)
    return _chunk_var00(phis)


def _corner_var_dispatch(basephi: np.ndarray, psi_idx: np.ndarray,
                         ms: np.ndarray):
    """Dispatch the corner-variance chunks of ``_CHUNK`` columns without
    reading any back: a (var, status) pair of device tensors a chunk.
    Callers gather every pending chunk, across outputs too, in one
    ``_gather``; the inputs go up in one copy.  The JAX package pads the
    chunks and LL for its compile cache; eager PyTorch and K5 take any
    shape, so nothing is padded here."""
    bphi, pidx, cols = _upload([basephi, psi_idx, ms], allocation_device())
    return [_chunk_corner_var(bphi, pidx, cols[:, s:s + _CHUNK])
            for s in range(0, ms.shape[1], _CHUNK)]


def _corner_var_assemble(host_chunks) -> np.ndarray:
    """The variances of gathered chunks.  A block whose Jacobi sweeps ran
    out (status 2) raises; a non-finite one (status 1) gives NaN, as the
    JAX package's eigh does."""
    if not host_chunks:
        return np.zeros(0)
    var = np.concatenate([v for v, _ in host_chunks])
    status = np.concatenate([s for _, s in host_chunks])
    psd_eig.require_converged(status, "corner search")
    var[status == 1] = np.nan
    return var


def _corner_variances(basephi: np.ndarray, psi_idx: np.ndarray,
                      ms: np.ndarray) -> np.ndarray:
    """Variances of all corner candidates, assembled and inverted on the
    allocation device in chunks, read back once."""
    return _corner_var_assemble(_gather(
        _corner_var_dispatch(basephi, psi_idx, ms)))


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
    vals (L, B) -> list of (B,) arrays (pinv(PHI_n)[0,0]).  Every
    output's PHIs go up in one copy and come back in one read."""
    phis = []
    for n in range(len(mappings)):
        Phi = psis[n] @ vals[mappings[n], :].astype(np.float64)  # (M^2, B)
        M = int(round(np.sqrt(psis[n].shape[0])))
        phis.append(Phi.T.reshape(-1, M, M))
    pending = [_chunk_var00(t) for t in _upload(phis, allocation_device())]
    return [_corner_var_assemble([h]) for h in _gather(pending)]


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

    # dispatch every output's chunks first, then one read for all of them
    pend = [_corner_var_dispatch(basephis[n], psis[n][:, idxs[n]],
                                 ms[redmaps[n], :]) for n in range(No)]
    host = _gather([c for chunks in pend for c in chunks])
    Vs, k = [], 0
    for chunks in pend:
        Vs.append(_corner_var_assemble(host[k:k + len(chunks)]))
        k += len(chunks)
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
