"""SPD projections for model covariance matrices.

Port of ``bluest_tpu/linalg/spd.py`` (reference blue_models.py:348-433):
a plain eigenvalue-clip projection when the covariance is fully known,
and a masked least-squares projection onto the SPD cone, solved with SPG
(``linalg/spg.py``), when only some entries are known.  Both run in f64
on ``config.allocation_device()``; the nearest-SPD subproblem is the
reference's ``feval/geval/proj`` triple (blue_models.py:366-382).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SPD_THRESHOLD, UNCORRELATED_RHO_TOL, allocation_device
from ..ops import psd_eig
from .spg import spg


def clip_spd(C: torch.Tensor, eps: float = SPD_THRESHOLD) -> torch.Tensor:
    """Symmetrize and clip eigenvalues at ``eps`` (blue_models.py:366-371;
    K5's sym_eigh on a card)."""
    S = (C + C.T) / 2
    w, V, status = psd_eig.sym_eigh(S[None].contiguous())
    psd_eig.require_converged(status, "clip_spd")
    w, V = torch.clamp(w[0], min=eps), V[0]
    return (V * w) @ V.T


def project_covariance_full(C: np.ndarray, eps: float = SPD_THRESHOLD):
    """Fully-known covariance: single eigh clip (blue_models.py:385-392).

    Returns (C_new, frobenius projection error)."""
    C_t = torch.as_tensor(np.asarray(C, dtype=float), dtype=torch.float64,
                          device=allocation_device())
    C_new = clip_spd(C_t, eps).cpu().numpy()
    err = float(np.linalg.norm(C - C_new, "fro"))
    return C_new, err


def project_covariance_masked(C: np.ndarray, mask: np.ndarray,
                              spd_eps: float = SPD_THRESHOLD,
                              spg_eps: float = 1.0e-10,
                              maxit: int = 10000,
                              max_fevals: int = 10 ** 8,
                              lmbda_min: float = 1e-30,
                              lmbda_max: float = 1e30,
                              history: int = 10):
    """Nearest SPD matrix to the known entries of ``C``.

    ``mask`` is 1 where C is known, 0 where free (NaN in the reference's
    encoding).  Minimizes 0.5*||mask*(X - C)||_F^2 over the eps-SPD cone via
    SPG with eigh-clip projection (blue_models.py:373-396).

    Returns (C_new, error, SPGResult)."""
    M = C.shape[0]
    dev = allocation_device()
    maskf = torch.as_tensor(np.asarray(mask, dtype=float).ravel(),
                            dtype=torch.float64, device=dev)
    Ct = torch.as_tensor(np.asarray(C, dtype=float).ravel(),
                         dtype=torch.float64, device=dev)
    target = torch.where(maskf > 0, torch.nan_to_num(Ct),
                         torch.zeros((), dtype=torch.float64, device=dev))

    def proj(x):
        return clip_spd(x.reshape(M, M), spd_eps).reshape(-1)

    def feval(x):
        r = maskf * (x - target)
        return 0.5 * float(r @ r)

    def geval(x):
        return maskf * (x - target)

    x0 = proj(maskf * target)
    res = spg(feval, geval, proj, x0, eps=spg_eps, maxit=maxit,
              max_fevals=max_fevals, lmbda_min=lmbda_min,
              lmbda_max=lmbda_max, history=history)
    C_new = res.x.reshape(M, M).cpu().numpy()
    return C_new, float(res.f), res


def mark_uncorrelated(C_new: np.ndarray, keep_nan_mask: np.ndarray | None = None,
                      rho_tol: float = UNCORRELATED_RHO_TOL) -> np.ndarray:
    """Post-projection sentinel pass (blue_models.py:410-414): entries with
    |rho| < tol become inf (uncorrelated marker); ``keep_nan_mask`` entries
    are reset to NaN (uncoupled pairs stay uncoupled)."""
    out = C_new.copy()
    s = np.sqrt(np.diag(out))
    rho = out / np.outer(s, s)
    off = ~np.eye(out.shape[0], dtype=bool)
    out[(np.abs(rho) < rho_tol) & off] = np.inf
    if keep_nan_mask is not None:
        out[keep_nan_mask] = np.nan
    return out
