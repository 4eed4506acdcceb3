"""Active-set Newton polish of continuous eps-mode allocations.

Copy of ``bluest_tpu/allocation/polish.py`` (numpy only; it talks to
MOSAP/SAP through ``variances``-style closures, ``mappings`` and ``costs``).

Role: close the gap between solver tolerance and the ~1e-8 parity target
(BASELINE.md).  Iterative solvers (IPM ~1e-8 relgap, first-order ~1e-6,
NLP ~1e-6) leave the last digits of the optimum on the table; polishing
fixes the point's support and active tolerance constraints and runs
full Newton on the reduced KKT system

    w_S + sum_n lambda_n dV_n/dm_S + sum_j nu_j a_j|_S = 0  (stationarity)
    V_n(m) = eps_n^2          for active n       (primal feasibility)
    a_j . m = b_j             for active caps j

through the library's own variance/gradient/Hessian closures (a code
path independent of every cone solver's internals -- the same closures
the KKT certificate uses).  From a solver-accurate starting point this
converges quadratically to ~machine precision in 2-4 steps, so two
DIFFERENT solver families polished independently must land on optimal
values agreeing to ~1e-10 unless one of them was not actually near the
optimum -- which is exactly what the golden-parity tier asserts
(tests/test_golden_reference.py of the JAX package).

On massively degenerate optimal faces (the NS K=7 regime) the polished
POINTS may differ across families -- the face is flat -- but the
polished cost and variances still agree at the optimum value.

Scope: eps-form, with optional per-model sample caps ``es``/``rhs``
(the reference's max_model_samples, restrictions_matern.py:169-177).
Budget-mode parity follows from the eps-form by the homogeneity ray
(MOSAP.sdp_solve); polishing there would re-derive the same system
under a rescale.

Caps design notes (three lessons of an earlier, reverted attempt):
* activation/drop thresholds are SYMMETRIC at 1e-6 relative -- a binding
  cap sits ~1e-8-relative INSIDE the bound at solver points, so an
  asymmetric 1e-9 slack test dropped it on iteration one;
* when caps are present, bound-hitting Newton steps freeze ALL
  coordinates driven to zero at once (projected bulk step) -- the capped
  Matern optimum has a diffuse ~63-coordinate degenerate support and the
  one-freeze-per-iteration cascade stalled at stat ~0.12;
* stage 1 keeps INEQUALITY-side feasibility only: there is no exact
  homogeneity rescale under caps (upscaling can cross a cap), so a
  rescaled candidate is accepted only if it also satisfies the caps and
  the best-point bookkeeping measures one-sided violation over ALL
  outputs and caps.
"""

from __future__ import annotations

import numpy as np

from .. import profiling

__all__ = ["polish_eps"]


def _mosap_closures(mos):
    """(variances, grad_n, hess_n, mappings, costs, L) for a MOSAP; a
    single-output SAP is wrapped with a trivial mapping."""
    if hasattr(mos, "SAPS"):
        maps = [np.asarray(mp, dtype=int) for mp in mos.mappings]
        saps = mos.SAPS
        return saps, maps, mos.costs, mos.L, mos.n_outputs
    return [mos], [np.arange(mos.L)], mos.costs, mos.L, 1


@profiling.traced("alloc.cleanup", walk="polish")
def polish_eps(mos, m0, eps, support_rtol: float = 1e-9,
               active_rtol: float = 1e-3, max_newton: int = 40,
               tol: float = 1e-12, trace: bool = False,
               es=None, rhs=None) -> dict:
    """Polish a continuous eps-mode allocation to ~machine precision.

    Three stages, each of which can only improve the point:

    1. **Adaptive clamp + exact rescale.** Solver points carry tail
       coordinates many orders below the support scale (IPM interior
       noise, NLP dust).  V is homogeneous of degree -1 in m, so for
       any clamp threshold the point ``alpha * m_clamped`` with
       ``alpha = max_n V_n(m_clamped)/eps_n^2`` is EXACTLY feasible;
       the largest threshold whose rescaled cost does not exceed the
       others' fixes the true support without any curvature
       information.  Under caps a rescaled candidate is accepted only
       if it also satisfies the caps (no exact rescale exists there);
       if none does, the clamped raw point stands and Newton restores
       feasibility.
    2. **Equality-constrained Newton on the clean support** (the KKT
       system in the module docstring, including active cap rows), with
       a trust-region cap, ratio-test freezing of coordinates the
       optimum pushes to the bound (BULK projected freezes when caps
       are present -- see the module notes), and merit backtracking.
    3. **One reduced-cost readmission round**: frozen/clamped
       coordinates with negative reduced cost re-enter and Newton
       reruns once.  The best feasible point seen anywhere is returned,
       so polishing can never hand back something worse than stage 1.

    ``es``/``rhs``: optional per-model cap rows (a_j . m <= b_j), the
    format of ``MOSAP.get_max_sample_constraints``.

    Returns a dict: ``m``, ``cost``, ``variances``, ``stationarity`` /
    ``feasibility`` / ``complementarity`` (relative residuals at the
    returned point), ``support``, ``active_caps``, ``newton_iters``,
    ``converged``.
    """
    saps, maps, w, L, No = _mosap_closures(mos)
    m_raw = np.maximum(np.asarray(m0, dtype=float).copy(), 0.0)
    eps = np.atleast_1d(np.asarray(eps, dtype=float))
    if eps.shape == (1,):
        eps = np.repeat(eps, No)
    if eps.shape != (No,):
        raise ValueError("eps must be scalar or one value per output")
    epsq = eps ** 2
    # Linear rows a_j . m <= b_j: the model-0 COVERAGE rows (-e_n . m <=
    # -1, the reference formulation's own constraint, sap.py e-row) come
    # first, then the user caps.  Coverage must be part of the KKT
    # system: on the Matern golden the optimum sits ON e.m = 1 with the
    # variance STRICTLY inside (V = 0.968 eps^2), and a polish without
    # the row "recovers" 0.7% of cost by walking to a coverage-violating
    # point (e.m = 0.53).  When coverage is slack (every other golden)
    # the rows are never activated and the trajectory is unchanged.
    if hasattr(mos, "SAPS"):
        cov_rows = mos._e_rows()
    else:
        cov_rows = [np.asarray(mos.e, dtype=float)]
    n_cov = len(cov_rows)
    n_user = 0 if es is None else len(es)
    rows = [-np.asarray(r, dtype=float) for r in cov_rows]
    bvals = [-1.0] * n_cov
    if n_user:
        rows += [np.asarray(e, dtype=float) for e in es]
        bvals += [float(r) for r in np.asarray(rhs, dtype=float)]
    nc = n_cov + n_user
    Ac = np.stack(rows)
    bc = np.asarray(bvals, dtype=float)
    if Ac.shape != (nc, L):
        raise ValueError("es/rhs must be cap rows over the L groups")
    bsafe = np.maximum(np.abs(bc), 1e-300)
    mx = float(m_raw.max())
    if not (np.isfinite(mx) and mx > 0):
        raise ValueError("m0 is not a usable starting point")
    wn = float(np.linalg.norm(w)) + 1e-300

    def cap_viol(mm):
        """One-sided cap violation (relative), over ALL caps."""
        if nc == 0:
            return 0.0
        return float(np.max(np.maximum(Ac @ mm - bc, 0.0) / bsafe))

    def viol_out(V):
        """One-sided feasibility violation over ALL outputs (relative)."""
        if not np.all(np.isfinite(V)):
            return np.inf
        return float(np.max(np.maximum(V - epsq, 0.0) / epsq))

    def variances_at(mm):
        try:
            return np.array([saps[n].variance(mm[maps[n]])
                             for n in range(No)])
        except (AssertionError, np.linalg.LinAlgError):
            # e.g. a step left model 0 uncovered: treat as infinitely
            # infeasible so merit guards reject the point
            return np.full(No, np.inf)

    def grads_at(mm, outs):
        G = {}
        for n in outs:
            g = np.zeros(L)
            g[maps[n]] = np.asarray(
                saps[n].variance_GH(mm[maps[n]], nohess=True)[1])
            G[n] = g
        return G

    # ---------------- stage 1: adaptive clamp + rescale ---------------- #
    def rescaled(threshold):
        """Clamp the tail, then pick the cheapest EXACTLY-feasible scale:
        V is homogeneous of degree -1, so alpha * mc is variance-feasible
        iff alpha >= max_n V_n(mc)/eps_n^2, while each linear row a.m <=
        b bounds alpha from above (a.mc > 0: user caps) or below (a.mc <
        0: coverage rows).  Cost grows linearly in alpha, so the optimum
        of the ray is the LOWER end of the interval -- tight on variance
        or on coverage, whichever binds (lesson 3 of the reverted
        round-4 attempt, made exact: the feasible-ray interval replaces
        the naive variance-only rescale that crossed caps/coverage)."""
        mc = m_raw.copy()
        mc[mc <= threshold * mx] = 0.0
        if mc.max() <= 0:
            return None, np.inf
        Vc = variances_at(mc)
        if not np.all(np.isfinite(Vc)):
            return None, np.inf
        lo = float(np.max(Vc / epsq))
        if not (np.isfinite(lo) and lo > 0):
            return None, np.inf
        hi = np.inf
        for j in range(nc):
            v = float(Ac[j] @ mc)
            if v > 0:
                hi = min(hi, bc[j] / v)
            elif v < 0:
                lo = max(lo, bc[j] / v)
            elif bc[j] < -1e-12:
                return None, np.inf     # 0 <= b < 0: ray infeasible
        if not (np.isfinite(lo) and lo > 0) or lo > hi * (1 + 1e-12):
            return None, np.inf         # empty interval on this clamp
        mc *= lo                        # exact feasibility by homogeneity
        return mc, float(mc @ w)

    # two passes: find the cheapest rescaled clamp, then take the
    # LARGEST threshold (sparsest support) within 1e-9 of it -- a
    # single replace-on-tie pass kept the densest support instead and
    # handed Newton a junk-tail start (observed: a clean scipy point
    # polished onto an entirely wrong 54%-more-expensive vertex)
    cands = []
    for thr in (1e-2, 1e-3, 1e-4, 1e-6, support_rtol):
        mc, cc = rescaled(thr)
        if mc is not None:
            cands.append((mc, cc))
    if not cands:                   # pathological input: raw + rescale
        mc, cc = rescaled(0.0)
        if mc is not None:
            cands.append((mc, cc))
    if cands:
        cost_min = min(cc for _, cc in cands)
        m, _cost1 = next((mc, cc) for mc, cc in cands
                         if cc <= cost_min * (1.0 + 1e-9))
        stage1_feas = 0.0           # exact by homogeneity (+ caps checked)
    else:
        # caps blocked every rescale: keep the dust-clamped solver point
        # and let Newton restore feasibility (recorded one-sided)
        m = m_raw.copy()
        m[m <= support_rtol * mx] = 0.0
        if m.max() <= 0:
            m = m_raw.copy()
        V0 = variances_at(m)
        if not np.any(np.isfinite(V0)):
            raise FloatingPointError("variance closure failed on m0")
        stage1_feas = max(viol_out(V0), cap_viol(m))
    best = {"m": m.copy(), "cost": float(m @ w),
            "V": variances_at(m), "stat": np.inf, "feas": stage1_feas,
            "comp": np.inf}

    V = best["V"]
    active = [n for n in range(No)
              if V[n] >= (1.0 - active_rtol) * epsq[n]]
    if not active:
        active = [int(np.argmax(V / epsq))]
    # active linear rows: SYMMETRIC 1e-6 activation/drop margin (lesson
    # 1), sign-safe (coverage rows have b = -1, so multiplicative
    # margins would flip)
    cact = [j for j in range(nc)
            if float(Ac[j] @ m) >= bc[j] - 1e-6 * bsafe[j]]
    inS = m > 0
    iters = 0
    stat = feas = np.inf
    lam = nu = None

    def feas_at(mm, Vt, act, ca):
        """KKT feasibility: two-sided residual on active equalities
        (outputs + caps) plus one-sided violation over everything."""
        if not np.all(np.isfinite(Vt[act])):
            return np.inf
        f = float(np.max(np.abs(Vt[act] - epsq[act]) / epsq[act]))
        if ca:
            f = max(f, float(np.max(
                np.abs(Ac[ca] @ mm - bc[ca]) / bsafe[ca])))
        return max(f, viol_out(Vt), cap_viol(mm))

    # ------------- stage 2 (+3): Newton with one readmission ----------- #
    for _round in range(3):
        lam = nu = None
        converged = False
        for _ in range(max_newton):
            iters += 1
            S = np.where(inS)[0]
            wS = w[S]
            V = variances_at(m)
            Gfull = grads_at(m, active)
            G = np.stack([Gfull[n][S] for n in active])
            AcS = Ac[np.ix_(cact, S)] if cact else np.zeros((0, S.size))
            na, ka = len(active), len(cact)
            if (lam is None or lam.shape != (na,)
                    or nu is None or nu.shape != (ka,)):
                Mstk = np.concatenate([G, AcS], axis=0)
                ln, *_ = np.linalg.lstsq(-Mstk.T, wS, rcond=None)
                ln = np.maximum(ln, 0.0)
                lam, nu = ln[:na], ln[na:]
            F1 = wS + G.T @ lam + (AcS.T @ nu if ka else 0.0)
            F2 = V[active] - epsq[active]
            F3 = (Ac[cact] @ m - bc[cact]) if ka else np.zeros(0)
            stat = float(np.linalg.norm(F1)) / wn
            # KKT feasibility = two-sided residual on the ACTIVE
            # equalities PLUS one-sided violation over ALL outputs and
            # caps: a Newton step can push an INACTIVE constraint over
            # its bound before the add-correction fires next iteration,
            # and recording that point as "best" on the active residual
            # alone would let polish return an infeasible point.
            feas = max(float(np.max(np.abs(F2) / epsq[active])),
                       float(np.max(np.abs(F3) / bsafe[cact]))
                       if ka else 0.0,
                       viol_out(V), cap_viol(m))
            merit = stat + feas
            if trace:
                print("polish it=%d |S|=%d active=%s caps=%s stat=%.2e "
                      "feas=%.2e cost=%.10e"
                      % (iters, S.size, active, cact, stat, feas,
                         float(m @ w)))
            if feas <= 100 * tol:
                c_now = float(m @ w)
                # cost decides; at cost ties (1e-12 relative -- the
                # noise floor of converged iterates) KKT quality decides
                cheaper = c_now < best["cost"] * (1 - 1e-12)
                tied = abs(c_now - best["cost"]) <= 1e-12 * best["cost"]
                if cheaper or (tied and max(stat, feas)
                               < max(best["stat"], best["feas"])):
                    best = {"m": m.copy(), "cost": c_now, "V": V.copy(),
                            "stat": stat, "feas": feas, "comp": np.inf}
            if stat <= tol and feas <= tol:
                converged = True
                break
            # output + cap active-set corrections (cheap, inline).
            # Cap drop margin mirrors the 1e-6 activation margin
            # (lesson 1: a binding cap sits ~1e-8-relative INSIDE at
            # solver points; an asymmetric tighter slack test dropped
            # it immediately).
            drop = [n for i, n in enumerate(active) if lam[i] <= 0
                    and V[n] < (1.0 - 1e-9) * epsq[n]]
            add = [n for n in range(No) if n not in active
                   and V[n] > (1.0 + 10 * tol) * epsq[n]]
            drop_c = [j for i, j in enumerate(cact) if nu[i] <= 0
                      and float(Ac[j] @ m) < bc[j] - 1e-6 * bsafe[j]]
            add_c = [j for j in range(nc) if j not in cact
                     and float(Ac[j] @ m) > bc[j] + 10 * tol * bsafe[j]]
            if drop or add or drop_c or add_c:
                active = [n for n in active if n not in drop] + add
                if not active:
                    active = [int(np.argmax(V / epsq))]
                cact = [j for j in cact if j not in drop_c] + add_c
                lam = nu = None
                continue

            Hl = {n: np.asarray(saps[n].variance_GH(m[maps[n]])[2])
                  for n in active}
            H = np.zeros((S.size, S.size))
            for i, n in enumerate(active):
                loc = -np.ones(L, dtype=int)
                loc[maps[n]] = np.arange(maps[n].size)
                sel = loc[S]
                has = np.where(sel >= 0)[0]
                H[np.ix_(has, has)] += lam[i] * Hl[n][
                    np.ix_(sel[has], sel[has])]
            nk = na + ka
            Meq = np.concatenate([G, AcS], axis=0)
            KKT = np.block([[H, Meq.T], [Meq, np.zeros((nk, nk))]])
            rhs_v = -np.concatenate([F1, F2, F3])
            try:
                step = np.linalg.solve(KKT, rhs_v)
            except np.linalg.LinAlgError:
                step = None
            if step is None or not np.all(np.isfinite(step)):
                step, *_ = np.linalg.lstsq(KKT, rhs_v, rcond=None)
            dm = step[:S.size]
            dl, dn = step[S.size:S.size + na], step[S.size + na:]
            mS = m[S]
            alpha = 1.0
            # trust region: near-singular reduced Hessians produced
            # ~1e34 raw steps on diffuse supports in an early draft
            dmax = float(np.max(np.abs(dm)))
            tr = 10.0 * (float(np.max(mS)) + 1.0)
            if dmax > tr:
                alpha = tr / dmax
            blocking = None
            neg = np.where(dm < 0)[0]
            if neg.size:
                ratios = -mS[neg] / dm[neg]
                j = int(np.argmin(ratios))
                if ratios[j] < alpha:
                    alpha = float(ratios[j])
                    blocking = int(S[neg[j]])
            if blocking is not None:
                # lesson 2: a diffuse degenerate support (capped Matern:
                # ~63 coordinates) makes the one-freeze-per-iteration
                # cascade slow -- when the Newton direction drives MANY
                # coordinates to the bound at once, take the
                # trust-region step PROJECTED onto m >= 0 and freeze
                # every coordinate it lands on zero, in one iteration.
                # Gated on hit.size >= 4 so short cascades keep the
                # long-validated single-freeze trajectory, and on a
                # feasibility guard (Newton restores the active
                # equalities quadratically afterwards; the best-point
                # bookkeeping protects quality regardless).
                a_bulk = min(1.0, tr / dmax) if dmax > tr else 1.0
                hit = S[(mS + a_bulk * dm) <= 0.0]
                if hit.size >= 4:
                    m_try = m.copy()
                    m_try[S] = np.maximum(mS + a_bulk * dm, 0.0)
                    Vt = variances_at(m_try)
                    ft = feas_at(m_try, Vt, active, cact)
                    if np.isfinite(ft) and ft <= max(10.0 * feas, 1e-6):
                        m = m_try
                        inS[hit] = False
                        lam = nu = None
                        continue
                # projected bulk step rejected: fall through to the
                # classic single-coordinate freeze below
            if blocking is not None:
                # bound-hitting step on the CLEAN support: freeze and
                # continue (at most |S| such steps).  Stationarity may
                # transiently worsen, so no stationarity test -- but
                # FEASIBILITY must survive: an unguarded freeze was
                # observed wrecking V by 38x and freezing the last
                # model-0 group (invalid point) on a degenerate ladder.
                m_try = m.copy()
                m_try[S] = np.maximum(mS + alpha * dm, 0.0)
                m_try[blocking] = 0.0
                Vt = variances_at(m_try)
                ft = (float(np.max(np.abs(Vt[active] - epsq[active])
                                   / epsq[active]))
                      if np.all(np.isfinite(Vt[active])) else np.inf)
                if nc:
                    ft = max(ft, cap_viol(m_try)) if np.isfinite(ft) \
                        else np.inf
                if not np.isfinite(ft) or ft > max(10.0 * feas, 1e-8):
                    break           # invalid freeze: best-so-far stands
                m = m_try
                inS[blocking] = False
                lam = nu = None
                continue

            def kkt_merit(mm, ll, nn):
                Vt = variances_at(mm)
                if not np.all(np.isfinite(Vt[active])):
                    return np.inf
                Gt = grads_at(mm, active)
                GtS = np.stack([Gt[n][S] for n in active])
                r1 = wS + GtS.T @ ll
                if ka:
                    r1 = r1 + AcS.T @ nn
                st = float(np.linalg.norm(r1)) / wn
                fe = float(np.max(np.abs(Vt[active] - epsq[active])
                                  / epsq[active]))
                if ka:
                    fe = max(fe, float(np.max(
                        np.abs(Ac[cact] @ mm - bc[cact]) / bsafe[cact])))
                return st + fe

            accepted = False
            for _bt in range(15):
                m_try = m.copy()
                m_try[S] = np.maximum(mS + alpha * dm, 0.0)
                l_try = lam + alpha * dl
                n_try = nu + alpha * dn
                if kkt_merit(m_try, l_try, n_try) < merit:
                    accepted = True
                    break
                alpha *= 0.5
            if not accepted:
                break               # stalled; stage-1/best guard stands
            m = m_try
            lam = l_try
            nu = n_try

        # ----------------- stage 3: readmission round ------------------ #
        if (lam is None or lam.shape != (len(active),)
                or nu is None or nu.shape != (len(cact),)):
            S = np.where(inS)[0]
            Gfull = grads_at(m, active)
            Gr = np.stack([Gfull[n][S] for n in active])
            AcSr = (Ac[np.ix_(cact, S)] if cact
                    else np.zeros((0, S.size)))
            ln, *_ = np.linalg.lstsq(
                -np.concatenate([Gr, AcSr], axis=0).T, w[S], rcond=None)
            ln = np.maximum(ln, 0.0)
            lam, nu = ln[:len(active)], ln[len(active):]
        else:
            Gfull = grads_at(m, active)
        red = w + sum(lam[i] * Gfull[n] for i, n in enumerate(active))
        if len(cact):
            red = red + Ac[cact].T @ nu
        comp_thr = 1e-6 * wn    # degenerate zeros flicker below this
        readmit = np.where(~inS & (red < -comp_thr))[0]
        if readmit.size == 0:
            break
        inS[readmit] = True

    # endgame selection between the final iterate and the best point
    # seen: FEASIBLE AND CHEAPER wins outright (the problem is convex
    # -- a feasible lower-cost point is simply better, whatever its
    # stationarity residual says about the restricted system it came
    # from; preferring low-stat here once kept a wrong-support vertex
    # 54% above the optimum)
    V = variances_at(m)
    feas_final = feas_at(m, V, active, cact)
    c_final = float(m @ w)
    # stat at the RETURNED final iterate: when the Newton loop exits
    # right after ACCEPTING a step (max_newton exhausted, or a break
    # after m = m_try), the loop-carried `stat` describes the PRE-step
    # iterate.  Recompute with the current multipliers (falling back to
    # least-squares ones) so the report matches the returned point.
    if np.isfinite(feas_final):
        try:
            S = np.where(inS)[0]
            Gf_fin = grads_at(m, active)
            G_fin = np.stack([Gf_fin[n][S] for n in active])
            A_fin = (Ac[np.ix_(cact, S)] if cact
                     else np.zeros((0, S.size)))
            M_fin = np.concatenate([G_fin, A_fin], axis=0)
            if (lam is not None and lam.shape == (len(active),)
                    and nu is not None and nu.shape == (len(cact),)):
                ln_fin = np.concatenate([lam, nu])
            else:
                ln_fin, *_ = np.linalg.lstsq(-M_fin.T, w[S], rcond=None)
                ln_fin = np.maximum(ln_fin, 0.0)
            stat = float(np.linalg.norm(w[S] + M_fin.T @ ln_fin)) / wn
        except (AssertionError, np.linalg.LinAlgError):
            pass                    # keep the loop-carried stat
    take_best = best["feas"] <= 100 * tol and (
        feas_final > 100 * tol
        or best["cost"] < c_final * (1 - 1e-12)
        or (abs(best["cost"] - c_final) <= 1e-12 * c_final
            and max(best["stat"], best["feas"]) < max(stat, feas_final)))
    if take_best:
        m, V = best["m"], best["V"]
        stat, feas = best["stat"], best["feas"]
    else:
        feas = feas_final
    # complementarity at the RETURNED point -- INFORMATIONAL ONLY.  The
    # reduced cost of a frozen coordinate uses the pinv-based variance
    # gradient, and directional derivatives of pseudo-inverses are
    # DISCONTINUOUS across rank changes: a coordinate whose group would
    # expand PHI's range can show a large spurious negative reduced
    # cost at the true optimum (observed: -0.16 relative at a point
    # both solver families pin to 1e-16, where readmitting the
    # coordinate provably does not improve).  This is also why the
    # stage-3 readmission is bounded and best-point-guarded rather than
    # trusted.  Optimality evidence is stat+feas plus the cross-family
    # identity, not this number.
    ret_S = m > 0
    ret_cact = [j for j in range(nc)
                if float(Ac[j] @ m) >= bc[j] - 1e-6 * bsafe[j]]
    if (~ret_S).any():
        try:
            Gf = grads_at(m, active)
            GrS = np.stack([Gf[n][ret_S] for n in active])
            ArS = (Ac[np.ix_(ret_cact, np.where(ret_S)[0])] if ret_cact
                   else np.zeros((0, int(ret_S.sum()))))
            lr, *_ = np.linalg.lstsq(
                -np.concatenate([GrS, ArS], axis=0).T, w[ret_S],
                rcond=None)
            lr = np.maximum(lr, 0.0)
            red_r = w + sum(lr[i] * Gf[n] for i, n in enumerate(active))
            if ret_cact:
                red_r = red_r + Ac[ret_cact].T @ lr[len(active):]
            comp = max(0.0, float(-np.min(red_r[~ret_S])) / wn)
        except (AssertionError, np.linalg.LinAlgError):
            comp = np.inf
    else:
        comp = 0.0
    cost = float(m @ w)
    return {
        "m": m,
        "cost": cost,
        "variances": V,
        "stationarity": stat,
        "feasibility": feas,
        "complementarity": comp,
        "active_outputs": list(active),
        # user-cap indices (positions in es/rhs) and coverage rows
        # reported separately; both share the linear-row machinery
        "active_caps": [j - n_cov for j in ret_cact if j >= n_cov],
        "active_coverage": [j for j in ret_cact if j < n_cov],
        "support": np.where(m > 0)[0],
        "newton_iters": iters,
        # 1e-10 floor: merit backtracking bottoms out a decade or two
        # above machine precision on some starts; that is still two
        # orders past the 1e-8 parity target this module serves
        # comp is deliberately NOT gated (see the note above: pinv
        # rank-change noise makes it unreliable at boundary optima)
        "converged": bool(stat <= max(10 * tol, 1e-10)
                          and feas <= max(10 * tol, 1e-10)),
    }
