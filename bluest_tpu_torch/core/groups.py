"""Static group (coupling) structure for a sample allocation problem.

A *group* S is a set of models evaluated on the same random input.  The
reference stores groups as ragged Python lists plus flattened inverse
covariance buffers consumed by C scatter loops (sap.py:66-95, cmisc.cpp).
Here each size class k holds a padded ``(Lk, k)`` index array, a
``(Lk, k, k)`` stack of inverse covariance blocks, and a dense one-hot
selector ``(Lk, k, M)`` so that every downstream kernel is an einsum /
matmul (MXU) rather than a gather-scatter loop.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..config import REAL


class GroupStructure:
    """Holds groups partitioned by size class for ``M`` models.

    Parameters
    ----------
    M : number of models.
    groups_by_size : ``groups_by_size[k-1]`` lists the size-k groups, each a
        sorted tuple/list of model indices (reference SAP.__init__ input,
        sap.py:53).  Empty size classes are allowed.
    C : optional (M, M) covariance; when given, per-group inverse covariance
        blocks ``pinv(C[S, S])`` are precomputed (reference sap.py:69-79).
    """

    def __init__(self, M: int, groups_by_size: Sequence[Sequence[Sequence[int]]],
                 C: np.ndarray | None = None):
        self.M = int(M)
        self.K = len(groups_by_size)

        self.groups: List[np.ndarray] = []
        self.flat_groups: List[List[int]] = []
        sizes = [0]
        for k in range(1, self.K + 1):
            gk = [list(map(int, g)) for g in groups_by_size[k - 1]]
            for g in gk:
                if len(g) != k:
                    raise ValueError("group %r in size class %d" % (g, k))
                self.flat_groups.append(g)
            arr = np.array(gk, dtype=np.int64).reshape((len(gk), k))
            self.groups.append(arr)
            sizes.append(len(gk))

        self.sizes = sizes
        self.cumsizes = np.cumsum(sizes)
        self.L = int(self.cumsizes[-1])
        # the model of every (group, slot) pair in flat-group order: the
        # scatter index of the estimator's right-hand side
        self.members = np.array([i for g in self.flat_groups for i in g],
                                dtype=np.int64)

        # Model-membership indicator rows: ES[i][g] = 1 iff model i in group g
        # (reference sap.py:89-95).  e = ES[0] marks groups containing the
        # high-fidelity model.
        ES = np.zeros((self.M, self.L), dtype=REAL)
        for gidx, g in enumerate(self.flat_groups):
            ES[np.array(g, dtype=int), gidx] = 1.0
        self.ES = ES
        self.e = ES[0]

        # One-hot selectors per size class: onehots[k-1][g, j, m].
        self.onehots: List[np.ndarray] = []
        for k in range(1, self.K + 1):
            gk = self.groups[k - 1]
            E = np.zeros((gk.shape[0], k, self.M), dtype=REAL)
            if gk.shape[0]:
                E[np.arange(gk.shape[0])[:, None], np.arange(k)[None, :], gk] = 1.0
            self.onehots.append(E)

        self.invcovs: List[np.ndarray] | None = None
        if C is not None:
            self.set_covariance(C)

    # ------------------------------------------------------------------ #

    def set_covariance(self, C: np.ndarray) -> None:
        """(Re)compute the per-group inverse covariance blocks."""
        C = np.asarray(C, dtype=REAL)
        ics: List[np.ndarray] = []
        for k in range(1, self.K + 1):
            gk = self.groups[k - 1]
            Lk = gk.shape[0]
            if Lk == 0:
                ics.append(np.zeros((0, k, k), dtype=REAL))
                continue
            # one batched pinv per size class (numpy broadcasts over the
            # leading dim) instead of Lk tiny host factorizations --
            # construction is O(K) LAPACK calls even at L in the thousands
            subs = C[gk[:, :, None], gk[:, None, :]]
            ics.append(np.linalg.pinv(subs).astype(REAL, copy=False))
        self.invcovs = ics

    # ------------------------------------------------------------------ #

    def group_costs(self, model_costs: np.ndarray) -> np.ndarray:
        """cost of one joint sample per group = sum of member model costs
        (reference blue_models.py:137-140)."""
        w = np.asarray(model_costs, dtype=REAL)
        return np.array([w[g].sum() for g in self.flat_groups], dtype=REAL)

    def split_by_size(self, m: np.ndarray) -> List[np.ndarray]:
        return [m[self.cumsizes[k]:self.cumsizes[k + 1]] for k in range(self.K)]

    def covered_models(self, m: np.ndarray, tol: float = 1.0e-6) -> np.ndarray:
        """Models appearing in any group with |m_g| > tol (reference
        get_nnz_rows_cols, misc.py:453-457)."""
        mask = np.abs(np.asarray(m)) > tol
        covered = (self.ES[:, mask].sum(axis=1) > 0)
        return np.where(covered)[0]

    def index_of(self, group: Sequence[int]) -> int:
        g = list(map(int, group))
        for i, fg in enumerate(self.flat_groups):
            if fg == g:
                return i
        raise KeyError("group %r not present" % (g,))
