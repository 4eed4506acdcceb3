"""Homogeneous self-dual interior-point solver for cone programs with a
nonnegative-orthant block and dense PSD blocks, over torch f64 tensors.

Port of ``bluest_tpu/solvers/sdp.py``.  Solves

    minimize    c^T x
    subject to  Gl x <= hl                           (componentwise)
                sum_i x_i * As[b, i]  <=  Hs[b]      (PSD order, per block b)

via the homogeneous self-dual (HSD) embedding with Nesterov-Todd scaling
and a Mehrotra predictor-corrector (see the JAX module's docstring for
the derivation).  The iteration is the JAX package's, step for step; what
differs is the loop around it.  The JAX package runs the whole solve as
one jitted ``lax.while_loop``; here a Python loop reads its device once an
iteration, one packed tensor of the stopping quantities and the
factorization statuses, and keeps the bookkeeping on the host.  The
iteration's numbers stay 0-d f64 tensors, its branches are selects (the
Mehrotra safeguard forms both the corrected and the centering direction
and keeps one), and its factorizations and eigenvalue and singular value
solves report a status instead of raising or reading back: Cholesky is
``cholesky_ex``, and the NT scaling's SVD and the step lengths'
eigenvalue solves are K3 and K4 (``ops.psd_eig``, hand-written Jacobi
kernels on a card, ``torch.linalg`` on the host).  So on a card the
iteration is one CUDA graph, captured once a solve attempt and replayed
once an iteration (``_IterationGraph``): the iterate lives in static
buffers, and taking a step is a device copy into them.  On the host the
same loop calls the iteration eagerly and gives, bit for bit, the results
of a loop that reads each number as it needs it.  One choice differs from
the JAX package: the normal equations are factored dense up to nx = 4096
(``_DENSE_MAX_NX``), where the JAX package takes its Woodbury path from
nx = 256, because the Woodbury endgame leaves the status to round-off.

Exact re-solves of one cone program (MOSAP rebuilds, repeated
budget-calibration solves) start from the previous solve's final iterate:
a process-wide cache keyed by a content hash of the post-equilibration
program data, blended into the cold start inside ``_ipm_solve``.
``BLUEST_TPU_IPM_WARM=0`` disables it and ``BLUEST_TPU_IPM_WARM_LAMBDA``
sets the blend weight (default 0.99); both are read at call time, under
the JAX package's names.  Two deliberate differences from the JAX
package's cache: ``dims["warm_start"]`` stays True when a warm attempt
that was not OK still outranks its cold re-attempt (there it is cleared
before the comparison), and a hit moves its entry to the newest place, so
the eviction is least-recently-used (there first-in-first-out).

Not ported: the IPM prewarm (it exists to avoid XLA retraces), and the
opt-in Gondzio correctors and f32-GEMM / zero-padding knobs of the
Woodbury path (all off by default there).
"""

from __future__ import annotations

import functools
import hashlib
import math
import os
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import allocation_device, on_allocation_device
from ..ops import psd_eig

__all__ = ["ConeLPResult", "solve_cone_lp"]

F64 = torch.float64
_WOOD_REFINE = 4      # Woodbury refinement steps (JAX package default)
# Largest program that factors the dense normal matrix by default.  Past
# the JAX package's nx >= 256 the Woodbury path's endgame is unreliable:
# there the diagonal spans ~1e18 (groups at zero against active ones),
# the refinement stops converging, and the iterate stalls where round-off
# picks the status (HH at K=5, nx=1585: "failed" or "inaccurate" under
# 1e-15 perturbations; dense: "inaccurate" with a 60x margin every time).
# The dense matrix is 128 MiB at this size.
_DENSE_MAX_NX = 4096


class ConeLPResult(NamedTuple):
    x: np.ndarray
    status: str          # "optimal" | "inaccurate" | "max_iter" |
                         # "failed" | "infeasible" | "unbounded"
    iterations: int
    gap: float
    pres: float
    dres: float
    pobj: float
    dims: Optional[dict] = None   # {nx, p, nb, n, rank, woodbury,
                                  #  warm_start, wall_s, ...}


def ipm_iteration_flops(dims: dict) -> float:
    """Estimated f64 flops of ONE IPM iteration from the problem dims
    recorded in ``ConeLPResult.dims`` (documented model, ~2x accuracy --
    for achieved-FLOP/s reporting, not for exact op counts).  Copy of the
    JAX package's arithmetic.

    Per iteration the solver refactors the normal matrix once and runs
    ~4 solves against it (predictor, corrector, tau border, centering
    fallback), plus batched NT scaling algebra on the (nb, n, n) PSD
    blocks (cholesky x2, SVD, eigh line searches ~ 20 n^3 each).

    Woodbury path: capacitance build ``W^T (W/d0)`` = 2 nx r^2, Cholesky
    r^3/3, and each solve pays (1 + _WOOD_REFINE) refinement rounds of
    one implicit solve + one matvec ~ 8 nx r each.

    Dense path: Hmat formation 2 nb nx^2 n^2 + nx^3/3 factorization +
    solves ~ 4 x 2 nx^2.
    """
    nx = float(dims["nx"])
    nb = float(dims["nb"])
    n = float(dims["n"])
    r = float(dims.get("rank", 0))
    nt = nb * 20.0 * n ** 3
    if dims.get("woodbury"):
        n_ref = 1.0 + _WOOD_REFINE
        return (2.0 * nx * r * r + r ** 3 / 3.0
                + 4.0 * n_ref * 8.0 * nx * r + nt)
    return 2.0 * nb * nx * nx * n * n + nx ** 3 / 3.0 + 8.0 * nx * nx + nt


def prewarm_mlblue(L: int, No: int, n: int,
                   budget_epigraph: bool = False, n_caps: int = 0) -> None:
    """The JAX package traces and compiles its fused IPM program for an
    MLBLUE shape class here.  The port's IPM is an eager loop with
    nothing to compile: kept for callers' scripts, returns at once."""
    del L, No, n, budget_epigraph, n_caps


def _sym(A):
    return (A + A.transpose(-1, -2)) / 2


# The iteration reads nothing back from its device but one packed tensor
# (``_read``).  Its numbers stay 0-d f64 tensors, its branches are
# selects, and its factorizations and eigenvalue and singular value solves
# append a status to ``infos`` instead of raising or reading it back.

def _read(t: torch.Tensor) -> list:
    """The host read of one iteration: its stopping quantities and
    factorization status, packed into one tensor."""
    return t.tolist()


def _eigvalsh(A, infos: list):
    """Eigenvalues, ascending, of a batch of symmetric blocks (K3 on a
    card, ``torch.linalg.eigvalsh`` on the host); the status is appended
    to ``infos``."""
    w, status = psd_eig.sym_eigvalsh(A.contiguous())
    infos.append(status)
    return w


def _svd(A, infos: list):
    """(U, singular values) of a batch of blocks (K4 on a card,
    ``torch.linalg.svd`` on the host); the status is appended to
    ``infos``."""
    U, sig, status = psd_eig.nt_svd(A.contiguous())
    infos.append(status)
    return U, sig


def _cholesky(A, infos: list):
    """Cholesky factor of an SPD matrix (or a batch); its status is
    appended to ``infos`` instead of raising."""
    L, info = torch.linalg.cholesky_ex(A)
    infos.append(info.reshape(-1))
    return L


def _all_ok(infos: list) -> torch.Tensor:
    return torch.cat(infos).eq(0).all()


def _raise_if_failed(infos: list) -> None:
    """Host check of factorization statuses, for code that runs once a
    solve (the start and the final polish), where the iteration's
    exception contract still holds."""
    if infos:
        psd_eig.require_converged(torch.cat(infos), "a Cholesky "
                                  "factorization or an eigenvalue solve",
                                  strict=True)


def _chol_factor(H, infos, jitter=1e-14):
    """Equilibrated Cholesky factor of an SPD matrix (unit-diagonal
    scaling first, so the 1e-14 ridge is scale-invariant)."""
    n = H.shape[0]
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-150))
    Hs = H / d[:, None] / d[None, :]
    L = _cholesky(Hs + jitter * torch.eye(n, dtype=H.dtype, device=H.device),
                  infos)
    return H, L, d


def _chol_apply(fac, RHS):
    """Solve with a _chol_factor result (+ one refinement step)."""
    H, L, d = fac
    one_d = RHS.dim() == 1
    B = RHS[:, None] if one_d else RHS

    def solve(b):
        bs = b / d[:, None]
        y = torch.linalg.solve_triangular(L, bs, upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True) / d[:, None]

    X = solve(B)
    X = X + solve(B - H @ X)  # one step of iterative refinement
    return X[:, 0] if one_d else X


def _psd_lowrank_factor(Ms):
    """(nb, nx, n, n) symmetric slabs -> W (nx, nb*n(n+1)/2) with
    (W W^T)[i,k] = sum_b <Ms[b,i], Ms[b,k]>_F (symmetric vectorization,
    off-diagonals weighted by sqrt(2))."""
    nb, nx, n, _ = Ms.shape
    # made on the device: a host array would be copied in, and a copy
    # from pageable host memory waits for the card
    iu0, iu1 = torch.triu_indices(n, n, device=Ms.device)
    wts = torch.full(iu0.shape, math.sqrt(2.0), dtype=Ms.dtype,
                     device=Ms.device).masked_fill(iu0 == iu1, 1.0)
    V = Ms[:, :, iu0, iu1] * wts                   # (nb, nx, ns)
    return V.permute(1, 0, 2).reshape(nx, nb * iu0.shape[0])


def _wood_factor(d0, W, infos, jitter=1e-14):
    """Factor H = diag(d0) + W W^T via the capacitance matrix
    C = I + W^T diag(1/d0) W (equilibrated Cholesky)."""
    r = W.shape[1]
    Wd = W / d0[:, None]
    C = torch.eye(r, dtype=W.dtype, device=W.device) + W.T @ Wd
    return d0, W, Wd, _chol_factor(C, infos, jitter=jitter)


def _wood_apply(fac, RHS):
    """Woodbury solve with _WOOD_REFINE steps of iterative refinement
    against the exact implicit matvec (see the JAX module: fewer steps
    stall the endgame on large instances)."""
    d0, W, Wd, Cfac = fac
    one_d = RHS.dim() == 1
    B = RHS[:, None] if one_d else RHS

    def solve(b):
        t = b / d0[:, None]
        return t - Wd @ _chol_apply(Cfac, W.T @ t)

    def matvec(x):
        return d0[:, None] * x + W @ (W.T @ x)

    X = solve(B)
    for _ in range(_WOOD_REFINE):
        X = X + solve(B - matvec(X))
    return X[:, 0] if one_d else X


# --------------------- batched PSD cone primitives ----------------------- #

def _nt_scaling(S, Z, infos):
    """Batched NT scaling (Todd-Toh-Tutuncu): returns (Tinv, R, Rinv, lam,
    Ls, Lz) with T = R R^T the metric geometric mean (T Z T = S) and Ls,
    Lz the Cholesky factors of S and Z."""
    Ls = _cholesky(S, infos)
    Lz = _cholesky(Z, infos)
    M = Ls.transpose(-1, -2) @ Lz
    U, sig = _svd(M, infos)
    sig = torch.clamp(sig, min=1e-150)
    R = (Ls @ U) / torch.sqrt(sig)[:, None, :]
    LsTinvU = torch.linalg.solve_triangular(Ls.transpose(-1, -2), U,
                                            upper=True)
    Rinv = torch.sqrt(sig)[:, :, None] * LsTinvU.transpose(-1, -2)
    Tinv = Rinv.transpose(-1, -2) @ Rinv
    return _sym(Tinv), R, Rinv, sig, Ls, Lz


def _max_step_psd(L, dS, infos, k=1):
    """sup {a : S + a dS >= 0} over the blocks of each of ``k`` equal
    parts of the batch, with L the Cholesky factors of the S blocks:
    a (k,) tensor, from one eigenvalue solve.  The step is monotone in
    the least eigenvalue of L^-1 dS L^-T, so the least one of a part
    gives the part's step."""
    M1 = torch.linalg.solve_triangular(L, dS, upper=False)
    M2 = torch.linalg.solve_triangular(L, M1.transpose(-1, -2), upper=False)
    lam_min = _eigvalsh(_sym(M2), infos)[:, 0].reshape(k, -1).amin(dim=1)
    return torch.where(lam_min >= 0, np.inf,
                       -1.0 / torch.clamp(lam_min, max=-1e-150))


def _max_step_lp(s, ds):
    """sup {a : s + a ds >= 0} along the last dimension of ``ds``."""
    return torch.where(ds < 0, -s / ds, np.inf).amin(dim=-1)


def _dual_polish(GT, Gall_mul, gsolve, p, nb, n, cj, z_lp, Z, tau, beta,
                 infos):
    """Minimum-norm dual correction restoring G^T z + c tau = 0,
    cone-limited so z stays strictly interior; ``beta`` is the initial
    step fraction (a 0-d tensor, 0.0 or 1.0)."""
    rd = cj * tau + GT(z_lp, Z)
    delta = -Gall_mul(gsolve(rd))
    if p:
        beta = torch.minimum(beta, 0.99 * _max_step_lp(z_lp, delta[:p]))
    if nb:
        dZc = _sym(delta[p:].reshape(nb, n, n))
        beta = torch.minimum(
            beta, 0.99 * _max_step_psd(_cholesky(Z, infos), dZc, infos)[0])
    beta = torch.clamp(beta, min=0.0)
    z_lp = z_lp + beta * delta[:p]
    if nb:
        Z = _sym(Z + beta * dZc)
    return z_lp, Z


# ---------------------- one HSD predictor-corrector step ------------------ #

def _iteration_core(cj, Glj, hlj, Aj, Hj, g_ops, gsolve, cnorm, step_frac,
                    gl_diag, Rj, woodbury, x, s_lp, S, z_lp, Z, tau, kappa):
    """One NT-scaled Mehrotra step on the HSD embedding (JAX
    ``_iteration_core`` without the opt-in Gondzio correctors), read
    back by nothing.

    Returns (step, ok, gap_cones, pres_r, dres_r), the numbers 0-d
    tensors: the residual metrics of the current iterate, ``step`` =
    (x, s_lp, S, z_lp, Z, tau, kappa, a) of the next one and ``ok``
    whether its factorizations held (the JAX program's NaN step when
    not); ``step`` is None when a decomposition raised instead."""
    p = hlj.shape[0]
    nb, nx, n, _ = Aj.shape
    nu = p + nb * n + 1
    Gl_mul, GlT_mul, Gall_mul = g_ops
    dev = cj.device

    def Gx(v):
        lp = Gl_mul(v) if p else torch.zeros(0, dtype=v.dtype, device=dev)
        psd = torch.einsum('i,binm->bnm', v, Aj) if nb else None
        return lp, psd

    def GT(u_lp, U_psd):
        out = GlT_mul(u_lp) if p else torch.zeros(nx, dtype=F64, device=dev)
        if nb:
            out = out + torch.einsum('binm,bnm->i', Aj, U_psd)
        return out

    Ax_lp, Ax_psd = Gx(x)
    rd = GT(z_lp, Z) + cj * tau
    rp_lp = hlj * tau - Ax_lp - s_lp if p else s_lp[:0]
    Rp = (Hj * tau - Ax_psd - S) if nb else Hj
    hz = (hlj @ z_lp if p else 0.0) + (torch.sum(Hj * Z) if nb else 0.0)
    rg = -(cj @ x) - hz - kappa

    gap_cones = s_lp @ z_lp if p else 0.0
    if nb:
        gap_cones = gap_cones + torch.sum(S * Z)
    pres_r = torch.linalg.norm(
        torch.cat([rp_lp, Rp.reshape(-1)]) if nb else rp_lp)
    dres_r = torch.linalg.norm(rd)
    infos = []
    try:
        step = _hsd_step(cj, Glj, hlj, Aj, Hj, GT, Gx, Gall_mul, gsolve,
                         cnorm, step_frac, gl_diag, Rj, woodbury, x, s_lp,
                         S, z_lp, Z, tau, kappa, rd, rp_lp, Rp, rg,
                         gap_cones, nu, infos)
        ok = _all_ok(infos)
    except torch.linalg.LinAlgError:
        # an eigenvalue or singular value solve failed on a broken-down
        # iterate: the pre-step metrics still count
        step, ok = None, None
    return step, ok, gap_cones, pres_r, dres_r


def _hsd_step(cj, Glj, hlj, Aj, Hj, GT, Gx, Gall_mul, gsolve, cnorm,
              step_frac, gl_diag, Rj, woodbury, x, s_lp, S, z_lp, Z, tau,
              kappa, rd, rp_lp, Rp, rg, gap_cones, nu, infos):
    """Newton directions, step length and dual polish of one iteration,
    every scalar a 0-d tensor and every branch on one a select."""
    p = hlj.shape[0]
    nb, nx, n, _ = Aj.shape
    mu = (gap_cones + tau * kappa) / nu

    d_lp = z_lp / s_lp if p else s_lp
    structured = gl_diag.shape[0] == nx

    def hmat_lp():
        if not structured:
            return (Glj.T * d_lp) @ Glj
        H = torch.diag(d_lp[:nx] * gl_diag ** 2)
        if Rj.shape[0]:
            H = H + torch.einsum('ri,r,rj->ij', Rj, d_lp[nx:], Rj)
        return H

    if nb:
        Tinv, Rnt, Rinv, lam, Ls, Lz = _nt_scaling(S, Z, infos)
        Zinv = _sym(torch.einsum('bij,bj,bkj->bik', Rnt, 1.0 / lam, Rnt))
        TinvH = _sym(torch.einsum('bij,bjl,blm->bim', Tinv, Hj, Tinv))
        if not woodbury:
            # Tinv A_i Tinv for every i as batched matmuls: the einsum
            # of the same products took ~30x longer on the host
            Y = torch.matmul(torch.matmul(Tinv[:, None], Aj),
                             Tinv[:, None])
            Hmat = torch.einsum('binm,bknm->ik', Aj, Y)
            if p:
                Hmat = Hmat + hmat_lp()
    else:
        TinvH = Hj
        if not woodbury:
            Hmat = hmat_lp()

    if woodbury:
        # Hmat = diag(d0) + W W^T, never materialized
        d0 = d_lp[:nx] * gl_diag ** 2
        parts = [Rj.T * torch.sqrt(d_lp[nx:])[None, :]]
        if nb:
            Mb = torch.einsum('baj,bijl,bcl->biac', Rinv, Aj, Rinv)
            parts.append(_psd_lowrank_factor(Mb))
        W = torch.cat(parts, dim=1)
        Hfac = _wood_factor(d0, W, infos)
        hsolve = lambda r: _wood_apply(Hfac, r)
    else:
        Hfac = _chol_factor(Hmat, infos)
        hsolve = lambda r: _chol_apply(Hfac, r)

    def Winv2(u_lp, U_psd):
        """(W^T W)^{-1} applied blockwise."""
        lp = d_lp * u_lp if p else u_lp
        psd = _sym(torch.einsum('bij,bjl,blm->bim', Tinv, U_psd, Tinv)) \
            if nb else U_psd
        return lp, psd

    q = GT(d_lp * hlj if p else hlj[:0], TinvH if nb else None)
    hWh = hlj @ (d_lp * hlj) if p else 0.0
    if nb:
        hWh = hWh + torch.sum(Hj * TinvH)

    v1 = hsolve(cj - q)
    denom = ((cj + q) @ v1) + hWh + kappa / tau

    def direction(fr, bs_lp, Bs_psd, bk):
        bx = fr * rd
        bz_lp = fr * rp_lp
        Bz_psd = fr * Rp if nb else Rp
        bt = fr * rg
        wb_lp, Wb_psd = Winv2(bz_lp + bs_lp,
                              (Bz_psd + Bs_psd) if nb else Bs_psd)
        rx = -bx + GT(wb_lp, Wb_psd)
        v2 = hsolve(rx)
        rt = (-bt - bk / tau
              - (hlj @ wb_lp if p else 0.0)
              - (torch.sum(Hj * Wb_psd) if nb else 0.0))
        dtau = (rt + ((cj + q) @ v2)) / denom
        dx = v2 - dtau * v1
        Adx_lp, Adx_psd = Gx(dx)
        dz_lp, dZ = Winv2(
            (Adx_lp - hlj * dtau - bz_lp - bs_lp) if p else bz_lp,
            (Adx_psd - Hj * dtau - Bz_psd - Bs_psd) if nb else Bs_psd)
        ds_lp = (bz_lp + hlj * dtau - Adx_lp) if p else bz_lp
        dS = (Bz_psd + Hj * dtau - Adx_psd) if nb else Bs_psd
        dkappa = (-bk - kappa * dtau) / tau
        return dx, ds_lp, dS, dz_lp, dZ, dtau, dkappa

    tk = torch.stack([tau, kappa])
    sz = torch.cat([s_lp, z_lp]) if p else None

    def max_steps(*dirs):
        """The largest step along each direction (ds_lp, dS, dz_lp, dZ,
        dtau, dkappa) of ``dirs``: a (len(dirs),) tensor."""
        k = len(dirs)
        a = _max_step_lp(tk, torch.stack([torch.stack([d[4], d[5]])
                                          for d in dirs]))
        if p:
            a = torch.minimum(a, _max_step_lp(sz, torch.stack(
                [torch.cat([d[0], d[2]]) for d in dirs])))
        if nb:
            a = torch.minimum(a, _max_step_psd(
                torch.cat([Ls, Lz] * k),
                torch.cat([t for d in dirs for t in (d[1], d[3])]), infos,
                k))
        return a

    zero_psd = torch.zeros_like(S) if nb else S
    zero_lp = torch.zeros_like(s_lp)

    # predictor (affine scaling)
    aff = direction(1.0, s_lp, S if nb else zero_psd, tau * kappa)
    dxa, dsa_lp, dSa, dza_lp, dZa, dtaua, dkappaa = aff
    a_aff = torch.clamp(max_steps(aff[1:])[0], max=1.0)

    gap_aff = ((s_lp + a_aff * dsa_lp) @ (z_lp + a_aff * dza_lp)
               if p else 0.0)
    if nb:
        gap_aff = gap_aff + torch.sum((S + a_aff * dSa) * (Z + a_aff * dZa))
    gap_aff = gap_aff + (tau + a_aff * dtaua) * (kappa + a_aff * dkappaa)
    gap_tot = gap_cones + tau * kappa
    ratio = gap_aff / gap_tot
    # pow with a tensor exponent rounds once, as float ** 3 does (for the
    # number 3 torch cubes by two products), so the host keeps its bits
    sigma = torch.clamp(torch.pow(ratio, torch.full_like(ratio, 3.0)),
                        1e-8, 1.0)

    # Mehrotra second-order corrections
    corr_lp = dsa_lp * dza_lp / z_lp if p else zero_lp
    if nb:
        dSs = Rinv @ dSa @ Rinv.transpose(-1, -2)       # W^{-T} dS
        dZs = Rnt.transpose(-1, -2) @ dZa @ Rnt          # W dZ
        Q = _sym(dSs @ dZs)
        denom_l = (lam[:, :, None] + lam[:, None, :]) / 2.0
        corr_psd = _sym(Rnt @ (Q / denom_l) @ Rnt.transpose(-1, -2))
    else:
        corr_psd = zero_psd

    smu = sigma * mu
    # z_inv * smu is how torch rounds a float over a tensor, which smu was
    # when the host read it: the host keeps its bits
    z_inv = torch.reciprocal(z_lp) if p else zero_lp
    comb = direction(1.0 - sigma,
                     (s_lp - z_inv * smu + corr_lp) if p else zero_lp,
                     (S - smu * Zinv + corr_psd) if nb else zero_psd,
                     tau * kappa - smu + dtaua * dkappaa)
    # the pure centering direction, for the Mehrotra safeguard below
    sig_c = torch.clamp(sigma, min=0.5)
    smu2 = sig_c * mu
    cent = direction(1.0 - sig_c,
                     (s_lp - z_inv * smu2) if p else zero_lp,
                     (S - smu2 * Zinv) if nb else zero_psd,
                     tau * kappa - smu2)
    a_comb, a_cent = max_steps(comb[1:], cent[1:])

    # Mehrotra safeguard: fall back to the pure centering direction when
    # the second-order correction collapses the step (both directions
    # are formed, and the test selects one: no host read)
    use_cent = a_comb < 0.2 * a_aff
    dx, ds_lp, dS, dz_lp, dZ, dtau, dkappa = (
        torch.where(use_cent, c, m) for c, m in zip(cent, comb))
    a_max = torch.where(use_cent, a_cent, a_comb)

    a = torch.clamp(step_frac * a_max, max=1.0)

    x_n = x + a * dx
    s_lp_n = s_lp + a * ds_lp
    z_lp_n = z_lp + a * dz_lp
    S_n = _sym(S + a * dS) if nb else S
    Z_n = _sym(Z + a * dZ) if nb else Z
    tau_n = tau + a * dtau
    kappa_n = kappa + a * dkappa

    # dual polish, gated on a small dual residual (see the JAX module)
    rd_n = cj * tau_n + GT(z_lp_n, Z_n)
    gate = (torch.linalg.norm(rd_n) < 1e-2 * cnorm * tau_n).to(F64)
    z_lp_n, Z_n = _dual_polish(GT, Gall_mul, gsolve, p, nb, n, cj,
                               z_lp_n, Z_n, tau_n, gate, infos)
    return x_n, s_lp_n, S_n, z_lp_n, Z_n, tau_n, kappa_n, a


# ------------------------------ full solve -------------------------------- #

def _packed_iteration(core, cj, x, s_lp, S, z_lp, Z, tau, kappa):
    """One iteration (``core``, a partial of ``_iteration_core``) and the
    tensor its host read takes: (step, packed), ``packed`` = the
    pre-step iterate's gap, residual norms, c^T x, tau and kappa, then,
    when the step was formed, its step length, next tau and whether its
    factorizations and eigenvalue solves held."""
    step, ok, gap_r, pres_r, dres_r = core(x, s_lp, S, z_lp, Z, tau, kappa)
    packed = [gap_r, pres_r, dres_r, cj @ x, tau, kappa]
    if step is not None:
        packed += [step[7], step[5], ok.to(F64)]
    return step, torch.stack([torch.as_tensor(v, dtype=F64, device=cj.device)
                              for v in packed])


class _IterationGraph:
    """The iteration over static buffers: the iterate (x, s_lp, S, z_lp, Z,
    tau, kappa) lives in ``iterate``, ``run()`` gives the step and the
    packed read from it, and ``adopt(step)`` copies the step into it.

    With ``capture`` (a card) the first ``run()`` warms the iteration up
    on a side stream (its results are dropped: the iteration only reads
    the iterate) and captures it into one CUDA graph, whose outputs are
    then the step and the packed read of every replay; each ``run()``
    replays it and counts the K3/K4 launches it recorded
    (``psd_eig.count_replay``).  A capture that fails raises; nothing
    falls back to the eager iteration.  ``step_frac`` and ``cnorm`` are
    part of the captured work, so a graph serves one solve attempt.
    Without ``capture`` ``run()`` calls the iteration eagerly on the same
    buffers (the host tests hold this against the eager loop)."""

    def __init__(self, core, cj, iterate, capture):
        self.core, self.cj, self.capture = core, cj, capture
        self.iterate = tuple(t.clone() for t in iterate)
        self.graph = None
        self.out = None
        self.captured = {}       # K3/K4 wrapper -> launches in one replay

    def _step(self):
        return _packed_iteration(self.core, self.cj, *self.iterate)

    def _capture(self):
        kernels = (psd_eig.sym_eigvalsh, psd_eig.nt_svd)
        side = torch.cuda.Stream(device=self.cj.device)
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self._step()                  # warm-up, outside the capture
            before = {fn: fn.captured for fn in kernels}
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = self._step()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        if out[0] is None:
            raise RuntimeError("the captured IPM iteration formed no step")
        self.captured = {fn: fn.captured - before[fn] for fn in kernels}
        self.graph, self.out = graph, out

    def run(self):
        if not self.capture:
            return self._step()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        psd_eig.count_replay(self.captured)
        return self.out

    def adopt(self, step):
        for dst, src in zip(self.iterate, step[:7]):
            dst.copy_(src)



def _ipm_solve(cj, Glj, hlj, Aj, Hj, Gall, GtG, gl_diag, Rj, cnorm, hnorm,
               step_frac, tol, feastol, max_iter, verbose=False,
               woodbury=False, warm=None, wlam=0.0, loop=None):
    """Full HSD-IPM solve: least-squares start (blended with the cached
    iterate ``warm`` = (x, s_lp, S, z_lp, Z) at weight ``wlam`` when
    given), predictor-corrector loop with stall / best-iterate /
    convergence bookkeeping, final dual polish and (in)feasibility
    certificate data.  Also returns the de-homogenized final iterate for
    the caller's warm-start cache.

    The start and the end read the device freely (they run once); each
    iteration reads one packed tensor, and the bookkeeping runs on the
    host on those numbers.  ``loop`` says how an iteration runs: "graph"
    (the default on a card) replays one CUDA graph of it over static
    buffers (``_IterationGraph``); "eager" (the default on the host) calls
    it as operations; "static" calls it as operations over the graph
    path's static buffers.  Tests compare the three.

    done codes: 0 running, 1 converged, 2 non-finite, 3 stall/tiny-step,
    4 tau collapse (infeasible or numerically dead embedding)."""
    p = hlj.shape[0]
    nb, nx, n, _ = Aj.shape
    dev = cj.device
    eye_n = torch.eye(n, dtype=F64, device=dev)

    if woodbury:
        def Gl_mul(v):
            return torch.cat([gl_diag * v, Rj @ v])

        def GlT_mul(u):
            return gl_diag * u[:nx] + Rj.T @ u[nx:]

        def Gall_mul(v):
            parts = [Gl_mul(v)]
            if nb:
                parts.append(torch.einsum('binm,i->bnm', Aj,
                                          v).reshape(nb * n * n))
            return torch.cat(parts)

        def GallT_mul(u):
            out = GlT_mul(u[:p])
            if nb:
                out = out + torch.einsum(
                    'binm,bnm->i', Aj, u[p:].reshape(nb, n, n))
            return out
    else:
        def Gl_mul(v):
            return Glj @ v

        def GlT_mul(u):
            return Glj.T @ u

        def Gall_mul(v):
            return Gall @ v

        def GallT_mul(u):
            return Gall.T @ u

    # ----- initialization: least-squares primal/dual start at tau = 1 -----
    hall = torch.cat([hlj, Hj.reshape(nb * n * n)]) if nb else hlj
    infos = []
    if woodbury:
        parts0 = [Rj.T]
        if nb:
            parts0.append(_psd_lowrank_factor(Aj))
        Gfac = _wood_factor(gl_diag ** 2, torch.cat(parts0, dim=1), infos)
        gsolve = lambda r: _wood_apply(Gfac, r)
    else:
        Gfac = _chol_factor(GtG, infos)
        gsolve = lambda r: _chol_apply(Gfac, r)
    _raise_if_failed(infos)
    x = gsolve(GallT_mul(hall))
    z_all = Gall_mul(gsolve(-cj))
    s_lp = hlj - Gl_mul(x)
    S = Hj - torch.einsum('i,binm->bnm', x, Aj) if nb else Hj
    z_lp = z_all[:p]
    Z = _sym(z_all[p:].reshape(nb, n, n)) if nb else Hj

    # shift initial points into the cone interior (cvxopt-style)
    def shift_lp(v):
        if p == 0:
            return v
        m = float(torch.min(v))
        return v + max(0.0, -m) + 1.0 if m < 1e-8 else v

    def shift_psd(V):
        if nb == 0:
            return V
        lam = float(torch.min(_eigvalsh(V, infos)))
        _raise_if_failed(infos)
        return V + (1.0 - min(lam, 0.0)) * eye_n[None] if lam < 1e-8 else V

    s_lp = shift_lp(s_lp)
    z_lp = shift_lp(z_lp)
    S = shift_psd(S)
    Z = shift_psd(Z)
    one = torch.ones((), dtype=F64, device=dev)
    tau, kappa = one, one

    # ----- optional warm start -----
    # Blend a cached previous solution of the SAME program into the cold
    # start (Skajaa/Jorgensen/Andersen-style HSD warm start): the HSD
    # initialization is an arbitrary interior point, so blending is always
    # admissible.  Active constraints in the warm point sit on the
    # boundary, so blended slacks get an elementwise interior floor and
    # kappa moves to the blended complementarity mean to stay near the
    # central path.  wlam = 0 (or no cached iterate) leaves the cold
    # start untouched, bit for bit.
    if warm is not None and wlam != 0.0:
        wx, ws_lp, wS, wz_lp, wZ = warm
        one_m = 1.0 - wlam
        x = one_m * x + wlam * wx
        if p:
            ds = wlam * 1e-6 * (1.0 + float(torch.mean(torch.abs(s_lp))))
            dz = wlam * 1e-6 * (1.0 + float(torch.mean(torch.abs(z_lp))))
            s_lp = torch.clamp(one_m * s_lp + wlam * ws_lp, min=ds)
            z_lp = torch.clamp(one_m * z_lp + wlam * wz_lp, min=dz)
        if nb:
            dS = wlam * 1e-6 * (1.0 + float(torch.mean(torch.abs(S))))
            dZ = wlam * 1e-6 * (1.0 + float(torch.mean(torch.abs(Z))))

            def psd_floor(V, delta):
                lam_min = _eigvalsh(V, infos)[:, 0]
                _raise_if_failed(infos)
                add = torch.clamp(delta - lam_min, min=0.0)
                return V + add[:, None, None] * eye_n[None]

            S = psd_floor(one_m * S + wlam * _sym(wS), dS)
            Z = psd_floor(one_m * Z + wlam * _sym(wZ), dZ)
        mu0 = ((float(s_lp @ z_lp) if p else 0.0)
               + (float(torch.sum(S * Z)) if nb else 0.0)) / max(p + nb * n, 1)
        kappa = torch.full((), one_m + wlam * max(mu0, 1e-10), dtype=F64,
                           device=dev)

    g_ops = (Gl_mul, GlT_mul, Gall_mul)
    best = dict(merit=np.inf, x=x, gap=np.inf, pres=np.inf, dres=np.inf,
                pobj=np.nan)
    core = functools.partial(_iteration_core, cj, Glj, hlj, Aj, Hj, g_ops,
                             gsolve, cnorm, step_frac, gl_diag, Rj, woodbury)
    if loop is None:
        loop = "graph" if dev.type == "cuda" else "eager"
    if loop not in ("graph", "static", "eager"):
        raise ValueError("loop must be 'graph', 'static' or 'eager', got %r"
                         % (loop,))
    if loop == "graph" and dev.type != "cuda":
        raise ValueError("a CUDA graph of the iteration needs a card, the "
                         "solve runs on %s" % dev)
    stepper = None
    if loop != "eager" and max_iter > 0:
        stepper = _IterationGraph(core, cj, (x, s_lp, S, z_lp, Z, tau, kappa),
                                  capture=loop == "graph")
        x, s_lp, S, z_lp, Z, tau, kappa = stepper.iterate
    stall = 0
    done = 0
    it = 0
    while it < max_iter and done == 0:
        if stepper is None:
            step, packed = _packed_iteration(core, cj, x, s_lp, S, z_lp, Z,
                                             tau, kappa)
        else:
            step, packed = stepper.run()
        it += 1
        vals = _read(packed)
        gap_r, pres_r, dres_r, cx, tau_h, kappa_h = vals[:6]
        if step is None or vals[8] == 0.0:
            x_n, tau_n, a = None, np.nan, 0.0    # no step to take
        else:
            x_n, s_n, S_n, z_n, Z_n, tau_t, kappa_t = step[:7]
            a, tau_n = vals[6], vals[7]
        # de-homogenized metrics of the pre-step iterate
        gap = gap_r / tau_h ** 2
        pres = pres_r / tau_h / hnorm
        dres = dres_r / tau_h / cnorm
        pobj = cx / tau_h
        finite = bool(np.isfinite(gap) and np.isfinite(pres)
                      and np.isfinite(dres) and np.isfinite(pobj))
        relgap = gap / max(1.0, abs(pobj)) if finite else np.nan
        merit = (max(relgap * (feastol / tol), max(pres, dres)) if finite
                 else np.nan)
        improved = finite and merit < best["merit"]
        if verbose:
            print("ipm %d: gap=%.2e pres=%.2e dres=%.2e tau=%.2e kappa=%.2e "
                  "step=%.3f" % (it, relgap, pres, dres, tau_h, kappa_h, a))
        converged = finite and pres < feastol and dres < feastol \
            and relgap < tol
        stall = 0 if improved else stall + 1
        stall_limit = 30 if (finite and pres < 1e-6 and dres < 1e-6) else 60
        endgame = best["merit"] < 1e2 * tol and stall >= 4
        stalled = stall >= stall_limit or a < 1e-10 or endgame
        tau_dead = tau_n < 1e-12
        if not finite or x_n is None:
            done = 2
        elif converged:
            done = 1
        elif tau_dead:
            done = 4
        elif stalled:
            done = 3
        if improved:
            best = dict(merit=merit, x=x / tau, gap=gap, pres=pres,
                        dres=dres, pobj=pobj)
        if finite and x_n is not None:
            if stepper is None:
                x, s_lp, S, z_lp, Z, tau, kappa = (x_n, s_n, S_n, z_n, Z_n,
                                                   tau_t, kappa_t)
            else:
                stepper.adopt(step)

    # fold in the final iterate, after an unconditional dual polish
    tau_h, kappa_h = float(tau), float(kappa)

    def GT_f(zl, Zm):
        out = GlT_mul(zl) if p else torch.zeros(nx, dtype=F64, device=dev)
        if nb:
            out = out + torch.einsum('binm,bnm->i', Aj, Zm)
        return out

    infos = []
    try:
        z_lp_f, Z_f = _dual_polish(GT_f, Gall_mul, gsolve, p, nb, n, cj,
                                   z_lp, Z, tau, one, infos)
        _raise_if_failed(infos)
    except torch.linalg.LinAlgError:
        z_lp_f = None           # no polished point to fold in
    if z_lp_f is not None:
        rd = cj * tau + GT_f(z_lp_f, Z_f)
        rp_lp = hlj * tau - Gl_mul(x) - s_lp if p else s_lp[:0]
        parts = [rp_lp]
        if nb:
            Rp = Hj * tau - torch.einsum('i,binm->bnm', x, Aj) - S
            parts.append(Rp.reshape(-1))
        gap_f = ((float(s_lp @ z_lp_f) if p else 0.0)
                 + (float(torch.sum(S * Z_f)) if nb else 0.0)) / tau_h ** 2
        pres_f = float(torch.linalg.norm(torch.cat(parts))) / tau_h / hnorm
        dres_f = float(torch.linalg.norm(rd)) / tau_h / cnorm
        pobj_f = float(cj @ x) / tau_h
        relgap_f = gap_f / max(1.0, abs(pobj_f))
        merit_f = max(relgap_f * (feastol / tol), max(pres_f, dres_f))
        if np.isfinite(merit_f) and tau_h > 1e-12 and merit_f < best["merit"]:
            best = dict(merit=merit_f, x=x / tau, gap=gap_f, pres=pres_f,
                        dres=dres_f, pobj=pobj_f)

    # (in)feasibility certificate data at the final (un-normalized) iterate
    uz = torch.cat([z_lp, Z.reshape(-1)]) if nb else z_lp
    s_all = torch.cat([s_lp, S.reshape(-1)]) if nb else s_lp
    z_nrm = max(float(torch.linalg.norm(uz)), 1e-300)
    x_nrm = max(float(torch.linalg.norm(x)), 1e-300)
    htz_rel = ((float(hlj @ z_lp) if p else 0.0)
               + (float(torch.sum(Hj * Z)) if nb else 0.0)) / z_nrm
    zres_rel = float(torch.linalg.norm(GallT_mul(uz))) / z_nrm
    xres_rel = float(torch.linalg.norm(Gall_mul(x) + s_all)) / x_nrm
    ctx_rel = float(cj @ x) / x_nrm
    kap_rel = kappa_h / max(1.0, max(z_nrm, x_nrm))
    # de-homogenized FINAL iterate for the warm-start cache (the caller
    # stores it only on an OK status; the tau guard is numerical safety)
    tau_safe = max(tau_h, 1e-300)
    final = (x / tau_safe, s_lp / tau_safe, S / tau_safe, z_lp / tau_safe,
             Z / tau_safe)
    return (best, it, done, (kap_rel, htz_rel, zres_rel, ctx_rel, xres_rel),
            final)


# --------------------------- warm-start cache ----------------------------- #
# Process-level cache of final HSD iterates keyed by a content hash of the
# (post-equilibration) program data.  Entries are host numpy arrays, moved
# to the solve's device on use, so an entry that a host solve stored may
# seed a card solve of the same program (and the other way round).
# Safety: a content-hash key cannot cross-seed different instances, a
# non-OK warm outcome falls back to the bit-exact cold start, and only
# finite OK-status iterates are stored.
_WARM_CACHE: dict = {}
_WARM_LOCK = threading.Lock()
_WARM_CACHE_MAX = 8
_WARM_OK = ("optimal", "inaccurate")


def _warm_fingerprint(c_np, Gl_np, hl_np, As_np, Hs_np, gl_diag, R_np,
                      nx, p, nb, n) -> str:
    """Content hash of the cone program (post-equilibration arrays).
    With the structured [-diag; rows] Gl the compact pieces (gl_diag, R)
    stand for it; an unstructured Gl is hashed whole."""
    h = hashlib.sha1()
    h.update(np.asarray([nx, p, nb, n], dtype=np.int64).tobytes())
    for a in (c_np, hl_np, As_np, Hs_np, gl_diag, R_np):
        h.update(np.ascontiguousarray(a).tobytes())
    if gl_diag.shape[0] != nx:
        h.update(np.ascontiguousarray(Gl_np).tobytes())
    return h.hexdigest()


@on_allocation_device
def solve_cone_lp(c: np.ndarray,
                  Gl: Optional[np.ndarray],
                  hl: Optional[np.ndarray],
                  As: Optional[np.ndarray] = None,
                  Hs: Optional[np.ndarray] = None,
                  tol: float = 1.0e-8,
                  feastol: float = 1.0e-8,
                  max_iter: int = 200,
                  step_frac: float = 0.99,
                  equilibrate: bool = True,
                  verbose: bool = False,
                  woodbury: Optional[bool] = None,
                  *, device=None) -> ConeLPResult:
    """Solve  min c^T x  s.t.  Gl x <= hl,  sum_i x_i As[b,i] <= Hs[b].

    ``As``: (nb, nx, n, n) symmetric coefficient slices; ``Hs``: (nb, n, n).
    Host numpy in, host numpy out; the solve runs in float64 in an
    allocation scope of ``device`` (None: the current allocation device,
    the card outside any scope)."""
    c_np = np.asarray(c, dtype=np.float64)
    nx = c_np.shape[0]
    if Gl is None:
        Gl = np.zeros((0, nx))
        hl = np.zeros((0,))
    Gl_np = np.asarray(Gl, dtype=np.float64).reshape(-1, nx)
    hl_np = np.asarray(hl, dtype=np.float64).ravel()
    p = Gl_np.shape[0]
    if As is None:
        As = np.zeros((0, nx, 1, 1))
        Hs = np.zeros((0, 1, 1))
    As_np = np.asarray(As, dtype=np.float64)
    As_np = (As_np + np.swapaxes(As_np, -1, -2)) / 2
    Hs_np = np.asarray(Hs, dtype=np.float64)
    Hs_np = (Hs_np + np.swapaxes(Hs_np, -1, -2)) / 2
    nb, _, n, _ = As_np.shape

    # column (variable) equilibration: x = colscale * x_tilde
    colscale = np.ones(nx)
    if equilibrate:
        norms = np.sqrt((Gl_np ** 2).sum(axis=0)
                        + (As_np ** 2).sum(axis=(0, 2, 3)))
        colscale = np.where(norms > 1e-150, 1.0 / np.maximum(norms, 1e-150),
                            1.0)
        Gl_np = Gl_np * colscale[None, :]
        As_np = As_np * colscale[None, :, None, None]
        c_np = c_np * colscale
    if p + nb * n == 0:
        raise ValueError("empty cone")

    hnorm = max(1.0, float(np.linalg.norm(hl_np)) + float(np.linalg.norm(Hs_np)))
    cnorm = max(1.0, float(np.linalg.norm(c_np)))

    # structured-Gl detection: MLBLUE programs are [-diag; few rows]
    if p >= nx and np.count_nonzero(
            Gl_np[:nx] - np.diag(np.diag(Gl_np[:nx]))) == 0:
        gl_diag = np.diag(Gl_np[:nx]).copy()
        R_np = Gl_np[nx:]
    else:
        gl_diag = np.zeros(0)
        R_np = np.zeros((0, nx))
    diag_ok = gl_diag.shape[0] == nx and bool(np.all(gl_diag != 0))

    # Woodbury path: normal matrix = diag + rank-r with structured Gl, for
    # programs too large for the dense one (_DENSE_MAX_NX)
    rank_lr = (p - nx) + nb * (n * (n + 1)) // 2
    if woodbury is None:
        woodbury = (diag_ok and nx > _DENSE_MAX_NX
                    and 2 * nx >= 3 * rank_lr)
    elif woodbury and not diag_ok:
        raise ValueError("woodbury=True requires the structured "
                         "[-diag; rows] Gl form with a fully nonzero "
                         "diagonal")

    dev = allocation_device()
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=F64,
                                  device=dev)
    if woodbury:
        Gall = GtG = None
    else:
        if nb:
            Gall_np = np.concatenate(
                [Gl_np, As_np.reshape(nb, nx, n * n).transpose(0, 2, 1)
                 .reshape(nb * n * n, nx)], axis=0)
        else:
            Gall_np = Gl_np
        Gall = T(Gall_np)
        GtG = T(Gall_np.T @ Gall_np)
    arrays = (T(c_np), T(Gl_np), T(hl_np), T(As_np), T(Hs_np), Gall, GtG,
              T(gl_diag), T(R_np))
    # warm-start lookup: a hit implies the identical program (same-shape
    # different instances must never cross-seed)
    warm_entry = None
    fp = None
    if os.environ.get("BLUEST_TPU_IPM_WARM", "1") != "0":
        fp = _warm_fingerprint(c_np, Gl_np, hl_np, As_np, Hs_np, gl_diag,
                               R_np, nx, p, nb, n)
        with _WARM_LOCK:
            warm_entry = _WARM_CACHE.pop(fp, None)
            if warm_entry is not None:
                _WARM_CACHE[fp] = warm_entry    # a hit is the newest entry
    wlam = float(os.environ.get("BLUEST_TPU_IPM_WARM_LAMBDA", "0.99"))
    dims_rec = {"nx": int(nx), "p": int(p), "nb": int(nb), "n": int(n),
                "rank": int(max(rank_lr, 0)), "woodbury": bool(woodbury),
                "warm_start": warm_entry is not None}

    def _attempt(frac, warm=None):
        """One solve + status derivation.  Returns (result, final iterate
        for the warm-start cache)."""
        try:
            best, it, done, cert, final = _ipm_solve(
                *arrays, cnorm, hnorm, frac, tol, feastol, max_iter,
                verbose=verbose, woodbury=bool(woodbury),
                warm=None if warm is None else tuple(T(a) for a in warm),
                wlam=wlam if warm is not None else 0.0)
        except torch.linalg.LinAlgError:
            # a factorization broke down on the start (the fused JAX
            # program reports this as a non-finite, failed solve)
            best, it, done, cert, final = dict(merit=np.inf), 0, 2, None, None
        if not np.isfinite(best["merit"]):
            return ConeLPResult(x=np.full(nx, np.nan), status="failed",
                                iterations=it, gap=np.inf, pres=np.inf,
                                dres=np.inf, pobj=np.nan,
                                dims=dims_rec), None
        kap_rel, htz_rel, zres_rel, ctx_rel, xres_rel = cert
        gap_f, pres_f, dres_f = best["gap"], best["pres"], best["dres"]
        pobj_f = best["pobj"]
        xb = best["x"].cpu().numpy() * colscale
        relgap = gap_f / max(1.0, abs(pobj_f))
        if pres_f < feastol and dres_f < feastol and relgap < tol:
            status = "optimal"
        elif (pres_f < 1e3 * feastol and dres_f < 1e4 * feastol
              and relgap < 1e4 * tol):
            # degenerate optimal faces: f64 gap floor above the nominal
            # tol with feasibility at machine precision (see JAX module)
            status = "inaccurate"
        elif (pres_f < 1e2 * feastol and dres_f < 1e5 * feastol
              and relgap < 1e4 * tol):
            # dres-only overshoot on a primal-excellent iterate
            status = "inaccurate"
        elif done == 4:
            # tau collapse: discriminate by the final iterate's ray
            z_cert = htz_rel < -1e-9 and zres_rel < 1e-6
            x_cert = ctx_rel < -1e-9 and xres_rel < 1e-6
            if kap_rel < 1e-12 and not (z_cert or x_cert):
                status = "failed"
            elif x_cert and not z_cert:
                status = "unbounded"
            else:
                status = "infeasible"
        elif it >= max_iter:
            status = "max_iter"
        else:
            status = "failed"
        return ConeLPResult(x=xb, status=status, iterations=it, gap=gap_f,
                            pres=pres_f, dres=dres_f, pobj=pobj_f,
                            dims=dims_rec), \
            tuple(a.cpu().numpy() for a in final)

    rank = {"optimal": 0, "inaccurate": 1, "infeasible": 2,
            "unbounded": 2, "max_iter": 3, "failed": 4}
    t0 = time.perf_counter()
    res, wout = _attempt(step_frac, warm_entry)
    dims_rec["wall_attempt_s"] = time.perf_counter() - t0
    dims_rec["retried"] = False
    if warm_entry is not None and res.status not in _WARM_OK:
        # The warm start must never cost robustness: any non-OK outcome
        # of a warm-seeded solve falls back to the bit-exact cold start,
        # and the cold result is preferred unless the warm one was
        # strictly better-ranked.  The stale entry is dropped so later
        # re-solves do not repeat the detour.
        with _WARM_LOCK:
            _WARM_CACHE.pop(fp, None)
        t1 = time.perf_counter()
        res_c, wout_c = _attempt(step_frac)
        t_cold = time.perf_counter() - t1
        if not rank.get(res.status, 4) < rank.get(res_c.status, 4):
            res, wout = res_c, wout_c
            dims_rec["warm_start"] = False
            dims_rec["wall_attempt_s"] = t_cold
    if res.status == "failed" and step_frac > 0.92:
        # a 0.99 fraction-to-boundary can wedge the iterate off-center
        # near the PSD boundary on generic cone programs: retry once at
        # 0.85 and keep the better-ranked result
        t1 = time.perf_counter()
        res2, wout2 = _attempt(0.85)
        t_second = time.perf_counter() - t1
        dims_rec["retried"] = True

        def _worst(r):
            rg = r.gap / max(1.0, abs(r.pobj)) if np.isfinite(r.pobj) \
                else r.gap
            return max(r.pres, r.dres, rg)

        if rank.get(res2.status, 4) < rank.get(res.status, 4) or (
                res2.status == res.status and _worst(res2) < _worst(res)):
            res, wout = res2, wout2
            dims_rec["warm_start"] = False
            dims_rec["wall_attempt_s"] = t_second
    dims_rec["wall_s"] = time.perf_counter() - t0
    if (fp is not None and wout is not None and res.status in _WARM_OK
            and all(np.all(np.isfinite(a)) for a in wout)):
        with _WARM_LOCK:
            _WARM_CACHE.pop(fp, None)
            _WARM_CACHE[fp] = wout
            while len(_WARM_CACHE) > _WARM_CACHE_MAX:
                _WARM_CACHE.pop(next(iter(_WARM_CACHE)))
    return res
