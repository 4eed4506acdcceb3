"""Operator-splitting (ADMM / SCS-style) cone solver: the second,
algorithmically independent SDP backend.  Port of
``bluest_tpu/solvers/admm.py`` to torch f64 on ``allocation_device()``.

Solves the same inequality-form cone program as solvers.sdp.solve_cone_lp

    minimize    c^T x
    subject to  Gl x <= hl                          (componentwise)
                sum_i x_i As[b, i]  <=  Hs[b]       (PSD order, per block)

but by a completely different algorithm: Douglas-Rachford splitting on
the homogeneous self-dual embedding (the SCS method of O'Donoghue,
Chu, Parikh & Boyd, "Conic optimization via operator splitting and
homogeneous self-dual embedding", JOTA 2016).  Where the interior-point
solver takes ~60 Newton steps each requiring a factorization of the
iteration-dependent normal matrix, this method takes thousands of cheap
first-order steps against ONE fixed factorization of I + A^T A and a
cone projection (clip for the orthant, eigenvalue clipping for PSD
blocks).  No step of the two solvers is shared -- different embedding
variables, different linear systems, different convergence mechanisms --
which is exactly what makes it a genuine cross-check: agreement between
the two is evidence about the *problem*, not about shared code.

Role: the reference cross-validates allocations across
cvxopt/cvxpy/scipy/ipopt (solver_test blocks, e.g. reference
bluest_NS.py:124-140); this module supplies the *independent SDP*
family next to the IPM
(solvers/sdp.py), the scipy NLP, and the SPG family.  First-order cone
solvers converge linearly at best, so this backend targets validation
accuracy (~1e-6 residuals), not the IPM's 1e-9: use it through
``SAP.solve(solver="admm")`` / ``MOSAP.solve(solver="admm")``, not as
the production default.  The diagonal+capacitance factorization below
makes the linear algebra scale to L in the thousands; what does NOT
scale is first-order convergence on near-degenerate correlation
ladders (rho -> 1-1e-5), where the splitting stalls and the IPM
remains the only solver -- see tests/test_torch_admm.py for the regimes
the cross-check covers.

In SCS notation the problem is  min c'x  s.t.  Ax + s = b, s in K  with
A = [Gl; svec rows of the PSD blocks], b = [hl; svec(Hs)].  The HSD
embedding variable is u = (x, z, tau), v = (0, s, kappa) with the
skew-symmetric KKT operator

    Q = [[0,  A', c], [-A, 0, b], [-c', -b', 0]],

and the iteration (over-relaxation alpha in (0, 2))

    u~    = (I + Q)^{-1} (u + v)
    t     = alpha u~ + (1 - alpha) u
    u^+   = Pi_C(t - v),      C = R^nx x K* x R_+   (K self-dual here)
    v^+   = v - t + u^+

The (I + Q) solve reduces to one Cholesky solve with the cached factor
of I + A'A plus O(m + nx) vector work (paper, section 4).  The whole
iteration -- linear solve, cone projection, residual tracking, best-
iterate bookkeeping -- is the JAX package's, step for step; its one
``lax.while_loop`` becomes a Python loop over eager torch operations, the
scalars the loop tests are Python floats, and of every ``lax.cond`` only
the branch that runs is evaluated.

Large-L structure exploitation (mirrors the IPM's Woodbury):
MLBLUE cone programs lead with the ``m >= 0`` block, a full -I whose
rows have a single nonzero each.  Those rows are split out of A into a
scatter operator (matvec O(pd) instead of O(pd*nx)) and contribute only
a DIAGONAL to A'A, so  I + A'A = D + Ar' Ar  with Ar just the dense
remainder (budget/e/caps rows + the svec'd LMI slabs) of rank
mr ~ nb*(M+1)^2/2 << nx = L+1.  When ``nx >= max(256, 1.5*mr)`` the
solver factors the mr x mr capacitance  I + Ar D^-1 Ar'  instead of the
dense nx x nx matrix -- unlike the IPM's Woodbury there is no 1/mu^2
span to guard against (D >= 1 and the capacitance is I + PSD), so no
refinement is needed.  This removes both the O(nx^3) factorization and
the O(nx^2) per-iteration triangular solves (previously L ~ 3300 meant
an 87 MB dense factor and nx^2 solves per iteration).

Scaling: Ruiz equilibration of A with per-row scalars on the LP block
and ONE scalar per PSD block (per-coordinate scaling of svec rows would
break the cone), diagonal column scaling on x, then b/c norm balancing
-- the standard SCS normalization, without which the splitting crawls
on MLBLUE's badly-scaled LMIs.  On top of the static normalization the
loop runs a DYNAMIC scale update (the SCS 3.x heuristic, expressed as
a rescale of the embedding's rhs): every 256 iterations, if the primal
and dual residuals have drifted more than 5x apart, b is rescaled by
sqrt(pres/dres) and the iterate is remapped through the
Moreau-preserving transform (x and the slack scale with b, the dual
does not; v stays in the normal cone at u).  No refactorization is
needed -- the Sherman-Morrison q-vector of the (I+Q)-solve is linear
in (c, sig*b), so its two halves are precomputed and recombined.  This
is the decisive fix for MLBLUE instances whose model costs span
several decades (the HH/NS regime): a 3-decade-span L=793 eps-form
that stalled at 1e-4 for 60k iterations under static scaling converges
to a true 1e-6 with it.

Termination is measured on ORIGINAL-space residuals (the equilibration
maps back with two elementwise multiplies per iteration).  Scaled-space
metrics were tried first and are NOT safe under dynamic rescaling: a
wide-cost-span instance can pass 1e-6 in scaled space while its
original-space PSD violation is still ~1e-1.

Anderson acceleration (type-II, safeguarded -- what SCS 3.x ships):
a rolling history of ``aa_memory`` iterate/residual pairs of the DR
fixed-point variable z = u - v.  Each iteration solves the tiny
(mem x mem) constrained least-squares  min ||G gamma||, sum gamma = 1
(regularized eigh-pinv, as the JAX package has it) and proposes
the extrapolation  z_aa = sum_i gamma_i (z_i + g_i).  The proposal is
SAFEGUARDED: accepted only if its own fixed-point residual does not
exceed the current one; otherwise the iteration falls back to two
plain (nonexpansive, hence residual-nonincreasing) splitting steps and
the history -- whose stale secants produced the bad proposal -- is
dropped (also on every scale change: the secants describe the old
map).  AA changes WHERE the map is evaluated, never the map, so the
cross-check independence argument above is untouched.
``aa_memory=0`` restores the plain splitting.

The accept/reject of an extrapolation and the rescale trigger are
discontinuous in the iterate, so iteration counts can part from the JAX
package's on last-bit differences while both converge; with
``aa_memory=0, adaptive_scale=False`` the map is smooth and the two
trajectories agree to rounding (tests/test_torch_admm.py).  Out of scope
for first-order splitting: correlation ladders beyond rho ~ 1-1e-4 --
the IPM and its certificates remain the only cone solver there.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import allocation_device
from ..ops import psd_eig
from .sdp import ConeLPResult

__all__ = ["solve_cone_lp_admm"]

F64 = torch.float64
_NAN = float("nan")


# ------------------------------ svec helpers ------------------------------ #

def _svec_indices(n: int):
    iu0, iu1 = np.triu_indices(n)
    wts = np.where(iu0 == iu1, 1.0, np.sqrt(2.0))
    return iu0, iu1, wts


def _svec_np(X: np.ndarray, iu0, iu1, wts) -> np.ndarray:
    """Symmetric vectorization of (..., n, n) -> (..., ns) with the
    sqrt(2) off-diagonal weights that make <X,Y>_F = svec(X).svec(Y)."""
    return X[..., iu0, iu1] * wts


def _nanmax(*vals):
    """max that propagates NaN like an elementwise array maximum."""
    return _NAN if any(math.isnan(v) for v in vals) else max(vals)


# ------------------------------ core solver ------------------------------- #

def _admm_run(cols, coefs, Ar, D, bh, ch, drow, ecol, scb, bnorm_o, cnorm_o,
              p, nb, n, max_iter, tol, alpha, wood, aa_mem, adapt):
    """Scaled-space SCS loop over the ROW-SPLIT constraint matrix
    A = [S; Ar]: S the single-nonzero LP rows as a scatter
    (``S x = coefs * x[cols]``), Ar the dense remainder, with
    D = diag(I + S'S) precomputed on the host.  ``wood`` selects the
    capacitance factorization of I + A'A = diag(D) + Ar'Ar.  bh/ch are
    the equilibrated rhs/objective (rows permuted so the S block leads).
    Returns the best iterate (by worst-of residuals) and its
    diagnostics."""
    dev = Ar.device
    pd = cols.shape[0]
    mr, nx = Ar.shape
    m = pd + mr
    ns = (n * (n + 1)) // 2
    iu0, iu1, wts = _svec_indices(n)
    svec_w = torch.as_tensor(wts, dtype=F64, device=dev)
    iu0_t = torch.as_tensor(iu0, dtype=torch.int64, device=dev)
    iu1_t = torch.as_tensor(iu1, dtype=torch.int64, device=dev)
    # svec^{-1} as one gather: entry (i, j) of the matrix reads svec slot
    # of (min(i,j), max(i,j)), unweighted
    slot = np.zeros((n, n), dtype=np.int64)
    slot[iu0, iu1] = np.arange(ns)
    slot[iu1, iu0] = np.arange(ns)
    mat_idx = torch.as_tensor(slot.reshape(-1), dtype=torch.int64,
                              device=dev)
    inv_w = 1.0 / svec_w

    def Amul(x):
        return torch.cat([coefs * x[cols], Ar @ x])

    def ATmul(z):
        out = torch.zeros(nx, dtype=F64, device=dev)
        out.index_add_(0, cols, coefs * z[:pd])
        return out + Ar.T @ z[pd:]

    # cached factorization of I + A'A = diag(D) + Ar'Ar (the only linear
    # algebra the method ever factors; A is fixed so this happens once
    # per solve)
    if wood and mr:
        # capacitance form: (D + Ar'Ar)^-1 r
        #   = D^-1 r - D^-1 Ar' (I + Ar D^-1 Ar')^-1 Ar D^-1 r
        Di = 1.0 / D
        ArDi = Ar * Di[None, :]
        capF = torch.linalg.cholesky(
            torch.eye(mr, dtype=F64, device=dev) + ArDi @ Ar.T)

        def hsolve(r):
            y = Di * r
            t = torch.cholesky_solve((Ar @ y)[:, None], capF)[:, 0]
            return y - ArDi.T @ t
    elif mr:
        F = torch.linalg.cholesky(torch.diag(D) + Ar.T @ Ar)

        def hsolve(r):
            return torch.cholesky_solve(r[:, None], F)[:, 0]
    else:
        def hsolve(r):
            return r / D

    def msolve(rx, rz):
        """[[I, A'], [-A, I]] (x, y) = (rx, rz)."""
        x = hsolve(rx - ATmul(rz))
        return x, rz + Amul(x)

    # (I + Q)^{-1} via the Sherman-Morrison identity of the SCS paper.
    # The q-vector is LINEAR in (c, sig*b), so the two halves are
    # precomputed once and recombined when sig changes -- the dynamic
    # scale updates below never need a new factorization.
    qxc, qzc = msolve(ch, torch.zeros(m, dtype=F64, device=dev))
    qxb, qzb = msolve(torch.zeros(nx, dtype=F64, device=dev), bh)
    qcache = {}

    def q_of(sig):
        if qcache.get("sig") != sig:
            qx = qxc + sig * qxb
            qz = qzc + sig * qzb
            qcache.update(sig=sig, qx=qx, qz=qz, denom=(
                1.0 + float(ch @ qx) + sig * float(bh @ qz)))
        return qcache["qx"], qcache["qz"], qcache["denom"]

    def iq_solve(wx, wz, wt, sig):
        qx, qz, denom = q_of(sig)
        px, pz = msolve(wx, wz)
        t = (wt + float(ch @ px) + sig * float(bh @ pz)) / denom
        return px - t * qx, pz - t * qz, t

    def proj_cone(z):
        """Projection onto K = R_+^p x PSD^nb (self-dual)."""
        z_lp = torch.clamp(z[:p], min=0.0) if p else z[:p]
        if nb:
            h = z[p:].reshape(nb, ns) * inv_w
            Zs = h[:, mat_idx].reshape(nb, n, n)
            lam, V, status = psd_eig.sym_eigh(Zs.contiguous())
            psd_eig.require_converged(status, "ADMM's PSD projection")
            lam = torch.clamp(lam, min=0.0)
            Zp = (V * lam[:, None, :]) @ V.transpose(-1, -2)
            z_psd = (Zp[:, iu0_t, iu1_t] * svec_w).reshape(-1)
            return torch.cat([z_lp, z_psd])
        return z_lp

    def residuals(ux, uz, ut, vz, sig):
        """ORIGINAL-space SCS termination metrics at the tau-normalized
        candidate, under the dynamic b-scale sig (the effective scaled
        rhs is sig * bh).  The equilibration maps back cheaply:
        A x + s - b = drow * (Ah xh + sh - sig bh th) / (tau scb sig),
        A'z + c   =  ecol * (Ah' zh + ch th) / (tau scb sig) * scb sig
        -- i.e. two elementwise multiplies.  Scaled-space metrics are NOT
        safe: a dynamically-rescaled instance can pass 1e-6 in scaled
        space while the original-space PSD violation is still ~1e-1
        (wide-cost-span instances)."""
        tau = max(ut, 1e-300) if not math.isnan(ut) else _NAN
        Ax = Amul(ux)
        ATz = ATmul(uz)
        sp = 1.0 / (tau * scb * max(sig, 1e-300))
        ctx = float(ch @ ux) * sp
        btz = float(bh @ uz) / (scb * tau)
        pres = (float(torch.linalg.norm(drow * (Ax + vz - (sig * ut) * bh)))
                * sp / (1.0 + bnorm_o))
        dres = (float(torch.linalg.norm(ecol * (ATz + ch * ut)))
                / tau / (1.0 + cnorm_o))
        gap = abs(ctx + btz) / (1.0 + abs(ctx) + abs(btz))
        return pres, dres, gap, Ax, ATz, ctx, btz

    half = nx + m + 1

    def zstep(z, sig):
        """One splitting step in the DR fixed-point variable z = u - v
        (u = Pi_C(z), v = u - z by Moreau):

            u    = Pi_C(z)
            u~   = (I + Q)^{-1} (2u - z)
            z^+  = z + alpha (u~ - u)

        under the dynamic b-scale sig.  Returns z^+, the termination
        diagnostics evaluated at (u, v), and (u, v) themselves."""
        u = torch.cat([
            z[:nx],                                  # x block: free
            proj_cone(z[nx:nx + m]),                 # z block: K*
            torch.clamp(z[-1:], min=0.0),            # tau: R_+
        ])
        v = u - z
        tau = float(u[-1])
        kappa = float(v[-1])

        pres, dres, gap, Ax, ATz, ctx, btz = residuals(
            u[:nx], u[nx:nx + m], tau, v[nx:nx + m], sig)
        err = _nanmax(pres, dres, gap)

        done = 1 if err < tol else 0
        # certificates (SCS section 3.4): tau -> 0 with a cone-feasible
        # ray, tested scale-invariantly on the NORMALIZED ray (the
        # iterate grows along the certificate direction as tau
        # collapses).  z with A'z ~ 0, b'z < 0: primal infeasible.
        # (x, s) with Ax + s ~ 0, c'x < 0: unbounded.
        if tau < 1e-12 * max(1.0, kappa):
            uz_n = float(torch.linalg.norm(u[nx:nx + m]))
            ux_n = float(torch.linalg.norm(u[:nx]))
            raw_btz = float(bh @ u[nx:nx + m])
            raw_ctx = float(ch @ u[:nx])
            z_inf = (uz_n > 1e-12
                     and float(torch.linalg.norm(ATz)) <= 1e-9 * uz_n
                     and raw_btz < -1e-9 * uz_n)
            x_unb = (ux_n > 1e-12
                     and float(torch.linalg.norm(Ax + v[nx:nx + m]))
                     <= 1e-9 * ux_n
                     and raw_ctx < -1e-9 * ux_n)
            if x_unb:
                done = 4
            if z_inf:
                done = 3                             # infeasible wins
        # non-finite data/iterates: every comparison above is False on
        # NaN, which would otherwise grind through all max_iter batched
        # eigh iterations before reporting -- exit now (status 'failed')
        if not math.isfinite(err):
            done = 2

        w = 2.0 * u - z
        tx, tz, tt = iq_solve(w[:nx], w[nx:nx + m], float(w[-1]), sig)
        ut = torch.cat([tx, tz, torch.as_tensor([tt], dtype=F64,
                                                device=dev)])
        zn = z + alpha * (ut - u)
        return zn, (pres, dres, gap, err, done), u, v

    z = torch.zeros(half, dtype=F64, device=dev)
    z[-1] = 1.0
    sig = 1.0
    zn, (pres, dres, gap, err, done), best_u, best_v = zstep(z, sig)
    best_err, best_sig = err, sig
    it = 1
    if aa_mem:
        k = 0
        acc = 0
        Zbuf = torch.zeros((aa_mem, half), dtype=F64, device=dev)
        Gbuf = torch.zeros((aa_mem, half), dtype=F64, device=dev)
        Gram = torch.zeros((aa_mem, aa_mem), dtype=F64, device=dev)
        slots = torch.arange(aa_mem, device=dev)
        zero = torch.zeros((), dtype=F64, device=dev)
        one = torch.ones((), dtype=F64, device=dev)
    else:
        acc = -1

    while it < max_iter and done == 0:
        g = zn - z
        gn = float(torch.linalg.norm(g))

        ok = False
        z_cand = zn
        if aa_mem:
            # rolling type-II AA history: overwrite the oldest slot and
            # refresh its Gram row/column (one (mem, half) matvec).
            sl = k % aa_mem
            Zbuf[sl] = z
            Gbuf[sl] = g
            grow = Gbuf @ g
            Gram[sl, :] = grow
            Gram[:, sl] = grow
            hist = min(k + 1, aa_mem)
            valid = slots < hist
            # min ||G gamma||, sum gamma = 1  ->  gamma prop (GG')^-1 1
            # on the valid slots, via a regularized eigh pseudo-inverse
            lam = 1e-12 * max(float(torch.max(torch.where(
                valid, torch.diagonal(Gram), zero))), 1e-30)
            Gm = torch.where(valid[:, None] & valid[None, :], Gram, zero)
            Gm = Gm + torch.diag(torch.where(valid, lam * one, one))
            ew, V, status = psd_eig.sym_eigh(Gm[None].contiguous())
            psd_eig.require_converged(status, "ADMM's history Gram matrix")
            ew, V = ew[0], V[0]
            cut = max(float(torch.max(torch.abs(ew))), 1e-300) * 1e-14
            ewi = torch.where(torch.abs(ew) > cut, 1.0 / ew, zero)
            a = V @ (ewi * (V.T @ valid.to(F64)))
            a = torch.where(valid, a, zero)
            asum = float(torch.sum(a))
            gamma = a / (asum if abs(asum) > 1e-30 else 1.0)
            z_aa = (Zbuf + Gbuf).T @ gamma
            ok = (hist >= 2 and abs(asum) > 1e-30
                  and bool(torch.all(torch.isfinite(z_aa))))
            if ok:
                z_cand = z_aa

        znc, diagc, uc, vc = zstep(z_cand, sig)
        # safeguard: the extrapolation must not increase the fixed-point
        # residual.  The fallback is TWO plain steps (the map is
        # nonexpansive, so the plain residual never grows) -- acceptance
        # or rejection, the residual sequence stays monotone.
        accept = (not ok) or (float(torch.linalg.norm(znc - z_cand)) <= gn)
        if accept:
            z2, zn2, u2, v2 = z_cand, znc, uc, vc
            pres, dres, gap, err, done = diagc
        else:
            z2 = zn
            zn2, (pres, dres, gap, err, done), u2, v2 = zstep(zn, sig)

        if err < best_err:
            best_err, best_u, best_v, best_sig = err, u2, v2, sig

        # dynamic b-scale (the SCS 3.x scale update, expressed as a
        # rescale of the embedding's rhs): when the primal and dual
        # residuals drift more than 5x apart, multiply sig by
        # sqrt(pres/dres) -- MLBLUE instances whose costs span several
        # decades otherwise park dres orders of magnitude above pres
        # and stall.  The iterate is remapped through the
        # Moreau-preserving transform (x and the slack scale with b,
        # the dual does not; v stays in the normal cone at u, so
        # u = Pi_C(z') survives), the q-vectors are recombined from
        # their precomputed halves (no refactorization), and the AA
        # history -- secants of the OLD map -- is dropped.
        want = False
        if adapt and it % 256 == 0 and done == 0:
            ratio = pres / max(dres, 1e-300)
            if math.isfinite(ratio) and (ratio < 0.2 or ratio > 5.0):
                fac = min(max(math.sqrt(ratio), 1.0 / 30.0), 30.0)
                sig_new = min(max(sig * fac, 1e-6), 1e6)
                fac = sig_new / sig
                want = sig_new != sig    # pinned at a clip bound: no-op
        if want:
            z = torch.cat([fac * u2[:nx], u2[nx:] - fac * v2[nx:]])
            zn = zstep(z, sig_new)[0]
            sig = sig_new
        else:
            z, zn = z2, zn2

        if aa_mem:
            # reset the history after a rejected extrapolation (the
            # stale secants are what produced the bad proposal) and
            # after a scale change (the secants describe the old map)
            k = k + 1 if (accept and not want) else 0
            acc += 1 if (accept and ok) else 0
        it += 1

    pres, dres, gap, _, _, ctx, _ = residuals(
        best_u[:nx], best_u[nx:nx + m], float(best_u[-1]),
        best_v[nx:nx + m], best_sig)
    return (best_u[:nx], float(best_u[-1]), it, done, pres, dres, gap, ctx,
            best_err, acc, best_sig)


def solve_cone_lp_admm(c: np.ndarray,
                       Gl: Optional[np.ndarray] = None,
                       hl: Optional[np.ndarray] = None,
                       As: Optional[np.ndarray] = None,
                       Hs: Optional[np.ndarray] = None,
                       max_iter: int = 60000,
                       tol: float = 1e-6,
                       alpha: float = 1.8,
                       ruiz_iters: int = 10,
                       woodbury: Optional[bool] = None,
                       aa_memory: int = 20,
                       adaptive_scale: bool = True,
                       verbose: bool = False) -> ConeLPResult:
    """Solve the cone program with the operator-splitting method.

    Same contract as :func:`solvers.sdp.solve_cone_lp` (argument layout,
    ConeLPResult, status vocabulary) so callers can swap backends.
    ``woodbury`` forces the capacitance factorization on/off; the
    default auto-enables it when nx >= max(256, 1.5 * (dense rows)).
    ``aa_memory`` sets the Anderson-acceleration history length
    (< 2 disables -- a single slot has no secant, so memory 1 is
    clamped to the plain-splitting path instead of paying dead AA
    overhead); ``adaptive_scale`` toggles the dynamic b-rescale
    (module docstring)."""
    c_np = np.asarray(c, dtype=np.float64)
    nx = c_np.shape[0]
    Gl_np = (np.zeros((0, nx)) if Gl is None
             else np.asarray(Gl, dtype=np.float64).reshape(-1, nx))
    hl_np = (np.zeros(0) if hl is None
             else np.asarray(hl, dtype=np.float64).ravel())
    p = Gl_np.shape[0]
    if As is None or np.size(As) == 0:
        As_np = np.zeros((0, nx, 1, 1))
        Hs_np = np.zeros((0, 1, 1))
    else:
        # symmetrize like solve_cone_lp does: _svec_np keeps only the
        # upper triangle, so an asymmetric input would otherwise make the
        # two 'same contract' backends solve DIFFERENT LMIs -- fatal for
        # the cross-validation role
        As_np = np.asarray(As, dtype=np.float64)
        As_np = (As_np + np.swapaxes(As_np, -1, -2)) / 2.0
        Hs_np = np.asarray(Hs, dtype=np.float64)
        Hs_np = (Hs_np + np.swapaxes(Hs_np, -1, -2)) / 2.0
    nb, _, n, _ = As_np.shape
    ns = (n * (n + 1)) // 2
    m = p + nb * ns
    if m == 0:
        raise ValueError("empty cone")

    # stack A = [Gl; svec(As)] and b = [hl; svec(Hs)]
    iu0, iu1, wts = _svec_indices(n)
    if nb:
        Apsd = np.transpose(_svec_np(As_np, iu0, iu1, wts),
                            (0, 2, 1)).reshape(nb * ns, nx)
        bpsd = _svec_np(Hs_np, iu0, iu1, wts).reshape(-1)
        A = np.vstack([Gl_np, Apsd])
        b = np.concatenate([hl_np, bpsd])
    else:
        A, b = Gl_np, hl_np

    # --- Ruiz equilibration: per-row scalars on the LP block, one scalar
    # per PSD block (cone invariance), diagonal column scaling on x
    d = np.ones(m)
    e = np.ones(nx)
    for _ in range(max(int(ruiz_iters), 0)):
        Asc = A / d[:, None] / e[None, :]
        rn = np.abs(Asc).max(axis=1)
        if nb:
            # uniform within each PSD block (cone invariance): block max
            rpsd = rn[p:].reshape(nb, ns).max(axis=1)
            rn = np.concatenate([rn[:p], np.repeat(rpsd, ns)])
        cn = np.abs(Asc).max(axis=0)
        d *= np.sqrt(np.where(rn > 0, rn, 1.0))
        e *= np.sqrt(np.where(cn > 0, cn, 1.0))
    Ah = A / d[:, None] / e[None, :]
    bh = b / d
    ch = c_np / e
    # balance ||b|| against ||c|| (SCS normalization): the splitting's
    # progress on tau couples the two scales
    bn, cn_ = np.linalg.norm(bh), np.linalg.norm(ch)
    sc_b = np.clip((cn_ + 1.0) / (bn + 1.0), 1e-6, 1e6)
    bh = bh * sc_b

    # --- row split: single-nonzero LP rows (the m >= 0 block and any
    # box rows) become a scatter S and a diagonal contribution to A'A;
    # everything else stays a dense (mr, nx) slab.  LP rows may be
    # permuted among themselves freely (R_+^p is coordinate-symmetric)
    # as long as bh moves with them; equilibration preserves the
    # sparsity pattern, so detection on Ah is detection on A.
    nnz_rows = np.count_nonzero(Ah, axis=1)
    diag_lp = np.flatnonzero((np.arange(m) < p) & (nnz_rows == 1))
    rest = np.setdiff1d(np.arange(m), diag_lp)   # sorted: keeps order
    cols = Ah[diag_lp].nonzero()[1]
    coefs = Ah[diag_lp, cols]
    Ar = Ah[rest]
    bh = np.concatenate([bh[diag_lp], bh[rest]])
    drow = np.concatenate([d[diag_lp], d[rest]])   # for original-space pres
    D = np.ones(nx)
    np.add.at(D, cols, coefs ** 2)
    mr = Ar.shape[0]
    wood = (nx >= max(256, int(1.5 * mr)) if woodbury is None
            else bool(woodbury))

    dev = allocation_device()
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=F64,
                                  device=dev)
    xh, tau, it, done, pres, dres, gap, ctx, best_err, acc, bsig = \
        _admm_run(
            torch.as_tensor(cols, dtype=torch.int64, device=dev), T(coefs),
            T(Ar), T(D), T(bh), T(ch), T(drow), T(e), float(sc_b),
            float(np.linalg.norm(b)), float(np.linalg.norm(c_np)),
            p, nb, n, int(max_iter), float(tol), float(alpha), wood,
            0 if int(aa_memory) < 2 else int(aa_memory),
            bool(adaptive_scale))
    xh = xh.cpu().numpy()

    tau_f = float(tau)
    if int(done) == 2 or tau_f <= 0 or not np.isfinite(tau_f):
        status = {3: "infeasible", 4: "unbounded"}.get(int(done), "failed")
        return ConeLPResult(np.full(nx, np.nan), status, int(it),
                            float(gap), float(pres), float(dres), np.nan)
    # unscale: x = E^{-1} x_hat / (tau * sc_b * sig_at_best_iterate)
    x = np.asarray(xh) / e / tau_f / sc_b / float(bsig)
    pobj = float(c_np @ x)
    err = float(best_err)
    if int(done) == 1 or err < tol:
        status = "optimal"
    elif int(done) == 3:
        status = "infeasible"
    elif int(done) == 4:
        status = "unbounded"
    elif err < 1e-4:
        status = "inaccurate"
    else:
        status = "max_iter"
    if verbose:
        print("admm: it=%d status=%s pres=%.2e dres=%.2e gap=%.2e "
              "aa_acc=%d sig=%.2e"
              % (int(it), status, float(pres), float(dres), float(gap),
                 int(acc), float(bsig)))
    return ConeLPResult(x, status, int(it), float(gap),
                        float(pres), float(dres), pobj)
