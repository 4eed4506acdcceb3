"""Projected-gradient continuous allocation solver (third solver family).

Port of ``bluest_tpu/solvers/spg_alloc.py``.  The reference ships four
interchangeable continuous solvers and its examples cross-check them
(cvxopt/cvxpy SDPs + scipy/ipopt NLPs; reference sap.py:242-456,
solver_test blocks in bluest_NS.py:124-140).  The first two families here
are the interior-point and operator-splitting cone solvers
(solvers/sdp.py, solvers/admm.py) and the scipy trust-constr NLP; this
module adds an algorithmically unrelated one: nonmonotone spectral
projected gradient (linalg/spg.py -- the optimizer the reference uses for
covariance projection) on the budget-constrained variance objective.
Eps-mode solves reduce to budget mode by homogeneity in the callers,
exactly like the NLP path (allocation/sap.py scipy_solve).

Two design points keep SPG honest on this objective:

* ``variance`` via pseudo-inverse is 0 at m = 0 (empty PHI), a spurious
  attractor inside the feasible set {m >= 0, w.m <= B}.  The objective
  here is the *regularized* variance ((PHI + delta0 I)^{-1})_00 with
  delta0 fixed from the starting point's PHI scale: it blows up like
  1/delta0 as m -> 0 (removing the attractor) and perturbs the optimum
  only at relative O(delta0 / ||PHI||) ~ 1e-10.  Solved with Cholesky.
* Projection onto {m >= 0, w.m <= B} is exact: clip, then if over
  budget a 64-step bisection on the KKT shift theta with
  m(theta) = max(x - theta w, 0).

Multi-output: smoothed max over per-output variances (log-sum-exp with
temperature continuation); the bias of the final temperature is below
the cross-validation tolerance this path exists to provide.

Gradient.  The JAX package differentiates the objective with
``jax.grad``; here it is the closed form.  With y = (PHI + delta0 I)^-1 e0
and PHI = reshape(psi @ m), d/dm_g of y_0 is -y^T reshape(psi[:, g]) y,
so the whole gradient is ``-(psi^T vec(y y^T))``: one matvec on top of the
Cholesky solve the value already paid, against a fresh autograd graph
through ``cholesky``/``cholesky_solve`` for each of the thousands of
evaluations of an eager SPG run; and the line search, which needs values
only, pays no gradient at all.  ``_reg_variance`` itself stays
differentiable, and tests/test_torch_spg_alloc.py holds the closed form
against ``torch.autograd`` through it.
"""

from __future__ import annotations

import bisect
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from .. import _native
from ..config import allocation_device
from ..core import psi as psimod
from ..linalg.spg import spg

F64 = torch.float64


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=F64,
                           device=allocation_device())


def budget_projection(w, budget):
    """Exact Euclidean projection onto {m >= 0, w.m <= budget}.

    The bisection tests phi(theta) = w . max(x - theta w, 0) > budget 64
    times.  phi is piecewise linear with breakpoints x_i / w_i, so it is
    evaluated from suffix sums over the sorted breakpoints (one sort and
    two cumulative sums for the whole projection) instead of by 64
    passes over the vector: an eager pass costs three tensor operations,
    and SPG projects twice an iteration."""
    w = _t(w) if not torch.is_tensor(w) else w
    budget = float(budget)
    w_floor = torch.clamp(w, min=1e-300)
    w2 = w * w

    def proj(x):
        xp = torch.clamp(x, min=0.0)
        if not float(w @ xp) > budget:
            return xp
        r, order = torch.sort(xp / w_floor)
        # tails[0][k] = sum_{i >= k} w_i x_i, tails[1][k] = sum_{i >= k}
        # w_i^2 (sorted order), with a trailing 0
        tails = torch.stack([(w * xp)[order], w2[order]]).flip(1) \
            .cumsum(1).flip(1)
        tail_wx = tails[0].tolist() + [0.0]
        tail_w2 = tails[1].tolist() + [0.0]
        r = r.tolist()
        lo, hi = 0.0, r[-1]
        for _ in range(64):
            mid = 0.5 * (lo + hi)
            k = bisect.bisect_right(r, mid)    # entries with x_i <= mid w_i
            if tail_wx[k] - mid * tail_w2[k] > budget:
                lo = mid
            else:
                hi = mid
        return torch.add(xp, w, alpha=-hi).clamp_(min=0.0)

    return proj


def capped_projection(w, budget, cap_rows, cap_rhs, n_sweeps: int = 200,
                      native: bool = True):
    """Dykstra projection onto {m >= 0, w.m <= B, E_i.m <= r_i}.

    Generalizes budget_projection to the per-model sample caps of the
    reference (sap.py:222-240) so the SPG family can cross-validate
    capped instances too.  Dykstra's alternating scheme over the orthant +
    each halfspace converges to the exact Euclidean projection of the
    intersection; a final shrink guarantees strict feasibility regardless
    of where the sweep stopped.  The sweep count is fixed: an early exit
    would change the result.

    The sweeps are sequential and an SPG run projects thousands of
    infeasible points, so they run in the package's native host library
    (``_native.dykstra``, ~20 us a projection at L ~ 30) when it is built,
    and as the same loop over tensors (~13 ms) when it is not
    (``native=False`` forces the latter)."""
    w = _t(w) if not torch.is_tensor(w) else w
    A = torch.cat([w[None, :], _t(cap_rows).reshape(-1, w.shape[0])], dim=0)
    b = torch.cat([_t([float(budget)]), _t(cap_rhs).reshape(-1)])
    nrm2 = torch.clamp(torch.sum(A * A, dim=1), min=1e-300)
    q = A.shape[0]
    rows = [A[i] for i in range(q)]
    b_l = [float(v) for v in b]
    nrm2_l = [float(v) for v in nrm2]
    support = [A[i] > 0 for i in range(q)]
    A_np = np.ascontiguousarray(A.cpu().numpy())
    b_np = np.ascontiguousarray(b.cpu().numpy())
    nrm2_np = np.ascontiguousarray(nrm2.cpu().numpy())

    def dykstra(x):
        if native:
            y = _native.dykstra(x.cpu().numpy(), A_np, b_np, nrm2_np,
                                n_sweeps)
            if y is not None:
                return torch.as_tensor(y, dtype=F64, device=x.device)
        y = x
        P = [torch.zeros_like(x) for _ in range(q)]
        p0 = torch.zeros_like(x)
        for _ in range(n_sweeps):
            z = y + p0                      # orthant
            y = torch.clamp(z, min=0.0)
            p0 = z - y
            for i in range(q):
                z = y + P[i]
                t = max(float(rows[i] @ z) - b_l[i], 0.0) / nrm2_l[i]
                y = torch.add(z, rows[i], alpha=-t)
                P[i] = z - y
        # exact feasibility repair: clip the orthant, then for each still-
        # violated halfspace scale only its SUPPORT down to the boundary.
        # All rows here are elementwise nonnegative (costs, 0/1 cap rows),
        # so a support-local shrink never increases any other constraint
        # and never leaves the orthant.  (A global shrink would be wrong:
        # a legitimate zero-cap RHS b_i = 0 would collapse the whole
        # iterate to the zero vector even from feasible points.)
        y = torch.clamp(y, min=0.0)
        for i in range(q):
            v = float(rows[i] @ y)
            if v > b_l[i]:
                y = torch.where(support[i], y * (b_l[i] / max(v, 1e-300)), y)
        return y

    def proj(x):
        # feasible points are their own projection: skip the (expensive)
        # sweeps for strictly interior SPG iterates, mirroring
        # budget_projection's fast path
        if bool(torch.all(x >= 0.0)) and bool(torch.all(A @ x <= b)):
            return x
        return dykstra(x)

    return proj


def _make_proj(w, budget, cap_rows, cap_rhs):
    if cap_rows.shape[0]:
        return capped_projection(w, budget, cap_rows, cap_rhs)
    return budget_projection(w, budget)


@lru_cache(maxsize=None)
def _eye_e0(M, device):
    eye = torch.eye(M, dtype=F64, device=device)
    return eye, eye[:, :1].clone()


def _reg_solve(data, m, delta0):
    """y = (PHI(m) + delta0 I)^{-1} e0 via Cholesky."""
    eye, e0 = _eye_e0(data.M, m.device)
    PHI = torch.add((data.psi @ m).view(data.M, data.M), eye, alpha=delta0)
    return torch.cholesky_solve(e0, torch.linalg.cholesky(PHI))[:, 0]


def _reg_variance(data, m, delta0):
    """((PHI(m) + delta0 I)^{-1})_00 via Cholesky (differentiable in m)."""
    return _reg_solve(data, m, delta0)[0]


def _reg_grad(data, y):
    """Gradient of ``_reg_variance`` in closed form from its solve ``y``
    (module docstring): -(psi^T vec(y y^T))."""
    return -(data.psi.T @ torch.outer(y, y).view(-1))


def _delta0_for(data, x0):
    PHI0 = psimod.phi_of_m(data.psi, _t(x0), 0.0)
    return 1e-10 * float(torch.mean(torch.diagonal(PHI0)))


class _Objective:
    """Value and gradient of one SPG objective.  ``solve(x)`` does the
    Cholesky solves, ``value(state)`` and ``grad(state)`` read them: the
    line search pays the value alone at each trial point (an eager SPG
    run backtracks ~20 times an iteration under caps), and the
    ``geval(x)`` that follows an accepted ``feval(x)`` reuses its solves.
    A point where the factorization fails evaluates to NaN, which the
    line search backs away from (and, on the first evaluation, reports
    as a failed solve)."""

    def __init__(self, solve, value, grad):
        self._solve, self._value, self._grad = solve, value, grad
        self._x = None
        self._state = None
        self._f = None

    def feval(self, x):
        if self._x is not x:
            try:
                self._state = self._solve(x)
                self._f = float(self._value(self._state))
            except torch.linalg.LinAlgError:
                self._state, self._f = None, float("nan")
            self._x = x
        return self._f

    def geval(self, x):
        self.feval(x)
        if self._state is None:
            return torch.full_like(x, float("nan"))
        return self._grad(self._state)


def _spg_budget_single(data, w, budget, x0, f0, delta0, gtol,
                       cap_rows, cap_rhs):
    obj = _Objective(lambda m: _reg_solve(data, m, delta0),
                     lambda y: y[0] / f0,
                     lambda y: _reg_grad(data, y) / f0)
    proj = _make_proj(w, budget, cap_rows, cap_rhs)
    res = spg(obj.feval, obj.geval, proj, x0, eps=gtol, maxit=3000)
    return res.x, res.f, res.it, res.solver_info


def _cap_arrays(L, cap_rows, cap_rhs):
    if cap_rows is None or len(cap_rows) == 0:
        return np.zeros((0, L)), np.zeros((0,))
    return (np.asarray(cap_rows, dtype=float).reshape(-1, L),
            np.asarray(cap_rhs, dtype=float).ravel())


def solve_budget_spg(data, costs, budget, cap_rows=None, cap_rhs=None,
                     x0=None):
    """Single-output budget-mode solve; returns the allocation (L,).

    ``cap_rows``/``cap_rhs``: optional per-model sample-cap halfspaces
    E_i.m <= r_i (reference sap.py:222-240).  ``x0`` warm-starts the
    iteration (used by the eps+caps budget bisection)."""
    w = np.asarray(costs, dtype=float)
    L = data.L
    cr, crhs = _cap_arrays(L, cap_rows, cap_rhs)
    if x0 is None:
        x0 = np.full(L, 0.95 * budget / w.sum())
    delta0 = _delta0_for(data, x0)
    try:
        f0 = float(_reg_variance(data, _t(x0), delta0))
    except torch.linalg.LinAlgError:
        return None
    if not np.isfinite(f0) or f0 <= 0:
        return None
    # gradient scale: |grad of normalized objective| ~ 1/m-scale
    gtol = 1e-10 / (budget / w.sum())
    x, f, it, info = _spg_budget_single(data, _t(w), float(budget), _t(x0),
                                        f0, delta0, gtol, cr, crhs)
    x = x.cpu().numpy()
    if not np.all(np.isfinite(x)) or (int(info) == 2 and int(it) == 0):
        # info 2 at it 0: the very first line search failed (NaN
        # objective near a singular PHI) and SPG returned the projected
        # start -- finite but not a solve.  it == 0 with info 0 is a
        # warm start that already satisfies the gradient tolerance (the
        # eps+caps budget bisection hits this routinely) and is a valid
        # solution; later-iteration line-search failures keep their
        # feasible best-effort iterate.
        return None
    return np.maximum(x, 0.0)


def eps_caps_budget_search(solve_at, ratio_of, B0,
                           max_doubles: int = 24, iters: int = 26):
    """eps mode under per-model caps for the SPG family.

    Caps break the homogeneity reduction (they do not scale with m), so
    the min-cost-at-tolerance problem is solved by monotone bisection on
    the budget of the *capped* min-max-variance problem: V*(B) is
    nonincreasing in B, and the optimal budget is where the binding
    tolerance ratio hits 1.  ``solve_at(B, x0) -> m | None`` is a capped
    budget solve (warm-startable), ``ratio_of(m) -> max_n V_n/eps_n^2``.
    Returns the cheapest feasible allocation found, or None when the
    caps make the tolerance unreachable at any budget."""
    B = float(B0)
    m = solve_at(B, None)
    r = ratio_of(m) if m is not None else np.inf
    k = 0
    while (m is None or not np.isfinite(r) or r > 1.0) and k < max_doubles:
        # a failed solve at this budget is retryable: larger budgets move
        # the feasible set away from whatever made the solve stall
        B *= 2.0
        m2 = solve_at(B, m)
        if m2 is not None:
            m, r = m2, ratio_of(m2)
        else:
            r = np.inf
        k += 1
    if m is None or not np.isfinite(r) or r > 1.0:
        return None                      # certifiably cap-limited
    m_hi, B_hi = m, B
    if k == 0:
        # already feasible at B0: bracket downward
        B_lo = B0
        for _ in range(max_doubles):
            B_lo = B_lo / 2.0
            m2 = solve_at(B_lo, m_hi)
            if m2 is None:
                break
            r2 = ratio_of(m2)
            if np.isfinite(r2) and r2 <= 1.0:
                m_hi, B_hi = m2, B_lo
            else:
                break
        else:
            return m_hi
    else:
        B_lo = B / 2.0
    for _ in range(iters):
        # each iteration is a full SPG solve: stop once the bracket (or
        # the binding ratio) is tight -- the cross-validation consumers
        # compare costs at ~10% tolerance
        if B_hi - B_lo <= 1e-4 * B_hi:
            break
        Bm = 0.5 * (B_lo + B_hi)
        m2 = solve_at(Bm, m_hi)
        if m2 is None:
            B_lo = Bm
            continue
        r2 = ratio_of(m2)
        if np.isfinite(r2) and r2 <= 1.0:
            m_hi, B_hi = m2, Bm
            if r2 >= 1.0 - 1e-4:
                break                  # binding: already on the frontier
        else:
            B_lo = Bm
    return m_hi


def _smoothed_max(ys, wts, temp):
    """logsumexp(temp * V_n / wts_n) / temp from the per-output solves."""
    vs = torch.stack([y[0] / wt for y, wt in zip(ys, wts)])
    return torch.logsumexp(temp * vs, dim=0) / temp


def _smoothed_max_grad(datas, mappings, ys, wts, temp, L):
    """Gradient of ``_smoothed_max`` in the union allocation: the
    softmax-weighted sum of the per-output closed-form gradients,
    scattered through the mappings."""
    vs = torch.stack([y[0] / wt for y, wt in zip(ys, wts)])
    sm = torch.softmax(temp * vs, dim=0)
    grad = torch.zeros(L, dtype=F64, device=vs.device)
    for n, (d, mp) in enumerate(zip(datas, mappings)):
        grad.index_add_(0, mp, (sm[n] / wts[n]) * _reg_grad(d, ys[n]))
    return grad


def _spg_budget_multi(datas, mappings, w, budget, x0, wts, delta0s,
                      temp, gtol, cap_rows, cap_rhs):
    L = x0.shape[0]
    obj = _Objective(
        lambda m: [_reg_solve(d, m[mp], dd)
                   for d, mp, dd in zip(datas, mappings, delta0s)],
        lambda ys: _smoothed_max(ys, wts, temp),
        lambda ys: _smoothed_max_grad(datas, mappings, ys, wts, temp, L))
    proj = _make_proj(w, budget, cap_rows, cap_rhs)
    res = spg(obj.feval, obj.geval, proj, x0, eps=gtol, maxit=3000)
    return res.x, res.f, res.it, res.solver_info


def solve_budget_spg_multi(datas: Sequence, mappings: Sequence,
                           L: int, costs, budget, weights=None,
                           cap_rows=None, cap_rhs=None, x0=None):
    """Multi-output budget mode: min (smoothed) max_n V_n(m)/weights_n
    over the union allocation, with temperature continuation 16 -> 1024.

    ``weights`` (default all-ones) make the eps-mode homogeneity
    reduction correct for heterogeneous tolerances: minimizing
    max_n V_n/eps_n^2 at a fixed budget and rescaling lands on the
    min-cost point for the *per-output* tolerances, whereas the
    unweighted max would over-serve the loosest output (same role as
    eps_weights on the NLP path)."""
    w = np.asarray(costs, dtype=float)
    No = len(datas)
    weights = (np.ones(No) if weights is None
               else np.asarray(weights, dtype=float))
    cr, crhs = _cap_arrays(L, cap_rows, cap_rhs)
    if x0 is None:
        x0 = np.full(L, 0.95 * budget / w.sum())
    x0 = np.asarray(x0, dtype=float)
    delta0s = tuple(_delta0_for(d, x0[mp])
                    for d, mp in zip(datas, mappings))
    try:
        v0 = [float(_reg_variance(d, _t(x0[mp]), dd)) / wt
              for d, mp, dd, wt in zip(datas, mappings, delta0s, weights)]
    except torch.linalg.LinAlgError:
        return None
    if not np.all(np.isfinite(v0)):
        # Python max skips NaN unless it comes first; an explicit
        # all-finite check keeps a singular-PHI output from slipping a
        # NaN objective into the solve
        return None
    s0 = float(np.max(v0))
    if s0 <= 0:
        return None
    # normalize so the smoothed objective is O(1) at the start
    wts = tuple(float(wt * s0) for wt in weights)
    gtol = 1e-10 / (budget / w.sum())
    dev = allocation_device()
    mapp = tuple(torch.as_tensor(np.asarray(mp), dtype=torch.int64,
                                 device=dev) for mp in mappings)
    x = _t(x0)
    progressed = False
    for temp in (16.0, 128.0, 1024.0):
        # a failed stage returns its (finite) warm start unchanged, so
        # continuation degrades gracefully rather than losing progress
        x, f, it, info = _spg_budget_multi(
            tuple(datas), mapp, _t(w), float(budget), x, wts, delta0s,
            temp, gtol, cr, crhs)
        progressed = progressed or int(info) == 0 or int(it) > 0
    x = x.cpu().numpy()
    if not np.all(np.isfinite(x)) or not progressed:
        # every stage's first line search failed: x is just the
        # projected start, not a solve (mirrors the single-output guard)
        return None
    return np.maximum(x, 0.0)
