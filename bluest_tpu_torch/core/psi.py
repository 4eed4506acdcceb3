"""MLBLUE information-matrix kernels as batched torch f64 linear algebra.

Port of ``bluest_tpu/core/psi.py``.  With per-size-class one-hot
selectors ``E_k (Lk, k, M)`` and inverse covariance blocks
``ic_k (Lk, k, k)``,

    psi_k           = einsum('gjm,gjl,gln->g(mn)', E, ic, E)
    PHI(m)          = reshape(psi @ m, (M, M))       (misc.py:459-461)
    variance(m)     = PHI(m)^+ [0, 0]                (misc.py:463-477)
    W[g, m]         = scatter_g(ic_g @ phi0|_g)      ("influence" rows)
    grad(m)         = -W @ phi0
    hess(m)         = 2 * W @ PHI^+ @ W^T
    cleanup matrix  = W^T

where phi0 = PHI^+[:, 0].  Every function takes the allocation vector
``m`` as a float64 tensor on the ``GroupData``'s device and returns
tensors there; the host-side numpy versions with the exact
nnz-restriction semantics (``host_variance``, ``host_estimator``) are
kept for the estimator assembly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..config import allocation_device
from ..ops import psd_eig
from .groups import GroupStructure

F64 = torch.float64


@dataclass(frozen=True, eq=False)
class GroupData:
    """Static f64 tensors for one SAP, keyed by size class, on one device."""
    M: int
    L: int
    onehots: tuple          # k-1 -> (Lk, k, M)
    invcovs: tuple          # k-1 -> (Lk, k, k)
    cumsizes: tuple
    psi: torch.Tensor       # (M*M, L)

    @classmethod
    def build(cls, gs: GroupStructure, device=None) -> "GroupData":
        if gs.invcovs is None:
            raise ValueError("GroupStructure has no covariance set")
        device = allocation_device() if device is None else device
        onehots = tuple(torch.as_tensor(E, dtype=F64, device=device)
                        for E in gs.onehots)
        invcovs = tuple(torch.as_tensor(ic, dtype=F64, device=device)
                        for ic in gs.invcovs)
        psi = assemble_psi(gs.M, onehots, invcovs)
        return cls(M=gs.M, L=gs.L, onehots=onehots, invcovs=invcovs,
                   cumsizes=tuple(int(c) for c in gs.cumsizes), psi=psi)


def assemble_psi(M: int, onehots, invcovs) -> torch.Tensor:
    """psi matrix (M^2, L): column g is vec(R_g^T C_g^{-1} R_g)
    (reference assemble_psi, misc.py:591-604 / cmisc.cpp:10-23)."""
    cols = []
    device = onehots[0].device if onehots else allocation_device()
    for E, ic in zip(onehots, invcovs):
        if E.shape[0] == 0:
            continue
        slab = torch.einsum('gjm,gjl,gln->gmn', E, ic, E)
        cols.append(slab.reshape(E.shape[0], M * M).T)
    if not cols:
        return torch.zeros((M * M, 0), dtype=F64, device=device)
    return torch.cat(cols, dim=1)


def phi_of_m(psi: torch.Tensor, m: torch.Tensor,
             delta: float = 0.0) -> torch.Tensor:
    M = int(round(np.sqrt(psi.shape[0])))
    PHI = (psi @ m).reshape(M, M)
    return PHI + delta * torch.eye(M, dtype=PHI.dtype, device=PHI.device)


def _pinv_h(A: torch.Tensor, rcond: float = 1.0e-12) -> torch.Tensor:
    """Hermitian pseudo-inverse via eigendecomposition (K5's sym_eigh on
    a card)."""
    w, V, status = psd_eig.sym_eigh(A[None].contiguous())
    psd_eig.require_converged(status, "_pinv_h")
    w, V = w[0], V[0]
    cutoff = rcond * torch.max(torch.abs(w))
    inv_w = torch.where(torch.abs(w) > cutoff, 1.0 / w,
                        torch.zeros((), dtype=w.dtype, device=w.device))
    return (V * inv_w) @ V.T


def variance(data: GroupData, m: torch.Tensor,
             delta: float = 0.0) -> torch.Tensor:
    """Estimator variance (PHI(m)^+)_{00} (K5's pinv00 on a card)."""
    var, status = psd_eig.pinv00(phi_of_m(data.psi, m, delta)[None]
                                 .contiguous(), 1.0e-12)
    psd_eig.require_converged(status, "variance")
    return var[0]


def _influence_rows(data: GroupData, phi0: torch.Tensor) -> torch.Tensor:
    """W (L, M): row g scatters C_g^{-1} phi0|_g back to model space."""
    rows = []
    for E, ic in zip(data.onehots, data.invcovs):
        if E.shape[0] == 0:
            continue
        pg = torch.einsum('gjm,m->gj', E, phi0)
        u = torch.einsum('gjl,gl->gj', ic, pg)
        rows.append(torch.einsum('gj,gjm->gm', u, E))
    return torch.cat(rows, dim=0)


def variance_grad_hess(data: GroupData, m: torch.Tensor, delta: float = 0.0,
                       nohess: bool = False):
    """(variance, gradient, Hessian) of m -> (PHI(m)^+)_{00}
    (reference variance_GH_full, misc.py:479-505)."""
    invPHI = _pinv_h(phi_of_m(data.psi, m, delta))
    var = invPHI[0, 0]
    phi0 = invPHI[:, 0]
    W = _influence_rows(data, phi0)
    grad = -(W @ phi0)
    if nohess:
        return var, grad, None
    return var, grad, 2.0 * (W @ invPHI @ W.T)


def cleanup_matrix(data: GroupData, m: torch.Tensor,
                   delta: float = 0.0) -> torch.Tensor:
    """X (M, L) = W^T used by the null-space sparsifier
    (reference assemble_cleanup_matrix, misc.py:507-516)."""
    invPHI = _pinv_h(phi_of_m(data.psi, m, delta))
    return _influence_rows(data, invPHI[:, 0]).T


def estimator_from_sums(data: GroupData, m: torch.Tensor, y: torch.Tensor):
    """BLUE estimator (mu, var) from the model-space sum vector y
    (reference PHIinvY0, misc.py:518-544):  mu = (PHI^+ y)_0."""
    invPHI = _pinv_h(phi_of_m(data.psi, m))
    return invPHI[0, :] @ y, invPHI[0, 0]


def scatter_group_sums(data: GroupData, sums_flat: List) -> torch.Tensor:
    """y in R^M with y_i = sum_{S ni i} (C_S^{-1} sums_S)_i
    (reference SAP.compute_BLUE_estimator scatter, sap.py:111-117)."""
    device = data.psi.device
    y = torch.zeros((data.M,), dtype=F64, device=device)
    gidx = 0
    for E, ic in zip(data.onehots, data.invcovs):
        Lk = E.shape[0]
        if Lk == 0:
            continue
        k = E.shape[1]
        s = torch.as_tensor(np.array(sums_flat[gidx:gidx + Lk],
                                     dtype=np.float64).reshape(Lk, k),
                            dtype=F64, device=device)
        u = torch.einsum('gjl,gl->gj', ic, s)
        y = y + torch.einsum('gj,gjm->m', u, E)
        gidx += Lk
    return y


# ----------------------------------------------------------------------- #
# Host-side (numpy) versions with the exact nnz-restriction semantics of
# misc.py:463-477 and misc.py:518-544; used for the final estimator
# assembly and the allocation's variance evaluations.
# ----------------------------------------------------------------------- #

def host_variance(gs: GroupStructure, psi: np.ndarray, m: np.ndarray,
                  delta: float = 0.0) -> float:
    m = np.asarray(m, dtype=float)
    if np.abs(m).max() < 0.05:
        return np.inf
    M = gs.M
    PHI = delta * np.eye(M) + (psi @ m).reshape(M, M)
    idx = gs.covered_models(m)
    if len(idx) == 0 or idx[0] != 0:
        raise AssertionError("model 0 must always be sampled")
    sub = PHI[np.ix_(idx, idx)]
    rhs = np.zeros(len(idx)); rhs[0] = 1.0
    return float(np.linalg.solve(sub, rhs)[0])


def host_estimator(gs: GroupStructure, psi: np.ndarray, m: np.ndarray, y):
    """(mu, var) with nnz restriction; supports array-valued y entries."""
    m = np.asarray(m, dtype=float)
    M = gs.M
    PHI = (psi @ m).reshape(M, M)
    idx = gs.covered_models(m)
    if len(idx) == 0 or idx[0] != 0:
        raise AssertionError("model 0 must always be sampled")
    sub = np.linalg.pinv(PHI[np.ix_(idx, idx)])
    var = sub[0, 0]
    mu = 0
    for col, i in enumerate(idx):
        mu = mu + sub[0, col] * y[i]
    return mu, var
