"""Assembly of MLBLUE sample-allocation problems as cone programs.

Builds the LP + LMI data consumed by solvers.sdp.solve_cone_lp for both
optimization modes of the reference (sap.py:242-307, mosap.py:395-463):

  budget mode:  min t   s.t.  m >= 0, w.m <= 1 (m normalized by budget),
                e_n.m >= 1/budget,  ES_i.m <= rhs_i/budget,
                [[scale_n PHI_n(m), sqrt(scale_n) e0], [., t]] >= 0
  eps mode:     min w.m/|w|  s.t.  m >= 0, e_n.m >= q, ES_i.m <= q rhs_i,
                [[scale_n PHI_n(m), sqrt(scale_n)/eps_n e0], [., 1]] >= 0
                (m carries the reference's meps^2 rescaling, q = meps^2)

The reference's conditioning heuristics are kept: per-output column scaling
``scale_n = 1/mean(colsum |psi_n|)`` (sap.py:258) and the eps-mode
``meps = 100/sqrt(n_MC_samples)`` rescale (mosap.py:430-434).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def psi_scales(psis: Sequence[np.ndarray]) -> np.ndarray:
    return np.array([1.0 / np.abs(psi).sum(axis=0).mean() for psi in psis])


def build_budget_sdp(psis: Sequence[np.ndarray],
                     mappings: Sequence[np.ndarray],
                     L: int, w: np.ndarray,
                     e_rows: Sequence[np.ndarray],
                     budget: float,
                     max_sample_rows: Sequence[np.ndarray] = (),
                     max_sample_rhs: Sequence[float] = (),
                     eps_weights=None):
    """x = (t, m/budget).  Returns (c, Gl, hl, As, Hs, scales).

    ``eps_weights`` (optional, per output) turns the epigraph into
    t >= V_n(m)/eps_n^2 -- the weighted min-max problem whose solution,
    rescaled by t*, solves the eps-mode problem exactly (the estimator
    variance is homogeneous of degree -1 in m)."""
    No = len(psis)
    scales = psi_scales(psis)
    Ns = [int(round(np.sqrt(p.shape[0]))) for p in psis]
    n = max(Ns) + 1
    if eps_weights is None:
        eps_weights = np.ones(No)

    c = np.zeros(L + 1)
    c[0] = 1.0

    rows = [-np.eye(L + 1)]
    rhs = [np.zeros(L + 1)]
    rows.append(np.concatenate([[0.0], w])[None, :])
    rhs.append(np.array([1.0]))
    for ee in e_rows:
        rows.append(np.concatenate([[0.0], -ee])[None, :])
        rhs.append(np.array([-1.0 / budget]))
    for ees, rr in zip(max_sample_rows, max_sample_rhs):
        rows.append(np.concatenate([[0.0], ees])[None, :])
        rhs.append(np.array([rr / budget]))
    Gl = np.vstack(rows)
    hl = np.concatenate(rhs)

    As = np.zeros((No, L + 1, n, n))
    Hs = np.zeros((No, n, n))
    for b in range(No):
        Nb = Ns[b]
        As[b, 0, Nb, Nb] = -1.0
        psi = psis[b]
        for j, gcol in enumerate(mappings[b]):
            As[b, 1 + gcol, :Nb, :Nb] = -scales[b] * psi[:, j].reshape(Nb, Nb)
        Hs[b, Nb, 0] = Hs[b, 0, Nb] = np.sqrt(scales[b]) / eps_weights[b]
        # pad: unused trailing rows made PSD-neutral with identity slack
        for d in range(Nb + 1, n):
            Hs[b, d, d] = 1.0
    return c, Gl, hl, As, Hs, scales


def build_eps_sdp(psis: Sequence[np.ndarray],
                  mappings: Sequence[np.ndarray],
                  L: int, w: np.ndarray,
                  e_rows: Sequence[np.ndarray],
                  eps: np.ndarray,
                  meps: float = 1.0,
                  max_sample_rows: Sequence[np.ndarray] = (),
                  max_sample_rhs: Sequence[float] = ()):
    """x = m * meps^2 (see module docstring).  eps passed already divided by
    meps.  Returns (c, Gl, hl, As, Hs, scales)."""
    No = len(psis)
    scales = psi_scales(psis)
    Ns = [int(round(np.sqrt(p.shape[0]))) for p in psis]
    n = max(Ns) + 1
    q = meps ** 2

    c = w / np.linalg.norm(w)

    rows = [-np.eye(L)]
    rhs = [np.zeros(L)]
    for ee in e_rows:
        rows.append(-ee[None, :])
        rhs.append(np.array([-q]))
    for ees, rr in zip(max_sample_rows, max_sample_rhs):
        rows.append(np.asarray(ees, dtype=float)[None, :])
        rhs.append(np.array([q * rr]))
    Gl = np.vstack(rows)
    hl = np.concatenate(rhs)

    As = np.zeros((No, L, n, n))
    Hs = np.zeros((No, n, n))
    for b in range(No):
        Nb = Ns[b]
        psi = psis[b]
        for j, gcol in enumerate(mappings[b]):
            As[b, gcol, :Nb, :Nb] = -scales[b] * psi[:, j].reshape(Nb, Nb)
        Hs[b, Nb, 0] = Hs[b, 0, Nb] = np.sqrt(scales[b]) / eps[b]
        Hs[b, Nb, Nb] = 1.0
        for d in range(Nb + 1, n):
            Hs[b, d, d] = 1.0
    return c, Gl, hl, As, Hs, scales
