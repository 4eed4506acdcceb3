"""SPD projections for model covariance matrices (fully known case).

Port of the eigenvalue-clip part of ``bluest_tpu/linalg/spd.py``
(reference blue_models.py:348-433): the flagship's pilot fills every
covariance entry, so ``project_covariance_full`` is the projection on its
path.  The masked SPG projection for partially known covariances is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SPD_THRESHOLD, UNCORRELATED_RHO_TOL, allocation_device


def clip_spd(C: torch.Tensor, eps: float = SPD_THRESHOLD) -> torch.Tensor:
    """Symmetrize and clip eigenvalues at ``eps`` (blue_models.py:366-371)."""
    S = (C + C.T) / 2
    w, V = torch.linalg.eigh(S)
    w = torch.clamp(w, min=eps)
    return (V * w) @ V.T


def project_covariance_full(C: np.ndarray, eps: float = SPD_THRESHOLD):
    """Fully-known covariance: single eigh clip (blue_models.py:385-392).

    Returns (C_new, frobenius projection error)."""
    C_t = torch.as_tensor(np.asarray(C, dtype=float), dtype=torch.float64,
                          device=allocation_device())
    C_new = clip_spd(C_t, eps).cpu().numpy()
    err = float(np.linalg.norm(C - C_new, "fro"))
    return C_new, err


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
