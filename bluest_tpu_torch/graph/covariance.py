"""Model-covariance bookkeeping with explicit masks.

The reference encodes covariance knowledge as sentinel values threaded
through a networkx graph, with a 0 <-> inf swap between the user encoding
and the graph-weight encoding (blue_models.py:232-263, 166-184).  We keep
the same *user-facing* sentinel semantics:

    user C[i, j] = NaN  -> unknown, estimate from pilot samples
    user C[i, j] = inf  -> models i, j can never be coupled (sampled jointly)
    user C[i, j] = 0    -> known to be uncorrelated
    finite              -> known covariance

but store explicit boolean masks internally (couplable / unknown /
uncorrelated / edges) so nothing depends on sentinel arithmetic.  The
``covariance()`` accessor reproduces the reference ``get_covariance``
output exactly (NaN for uncouplable-or-unknown, 0 for uncorrelated).
"""

from __future__ import annotations

import numpy as np

from ..config import UNCORRELATED_RHO_TOL
from . import cliques as _cl


class CovarianceGraph:
    """Covariance structure of M models for a single output."""

    def __init__(self, C_user: np.ndarray):
        C = np.array(C_user, dtype=float)
        M = C.shape[0]
        if C.shape != (M, M):
            raise ValueError("covariance must be square")
        self.M = M

        isinf = np.isinf(C)
        isnan = np.isnan(C)
        iszero = (C == 0.0) & ~isinf & ~isnan

        self.couplable = ~isinf
        np.fill_diagonal(self.couplable, True)
        self.unknown = isnan & self.couplable
        self.uncorrelated = iszero & self.couplable
        self.value = np.where(self.unknown | self.uncorrelated | ~self.couplable,
                              0.0, C)
        np.fill_diagonal(self.uncorrelated, False)

        # Graph edges: couplable pairs, including (for now) uncorrelated ones
        # -- mirroring the reference where a user 0 becomes an inf-weight edge
        # until check_graph prunes it (blue_models.py:252, 307-311).
        self.edges = self.couplable.copy()

        # Connected component of model 0 (recomputed by check()).
        self.component = list(range(M))

    # ------------------------------------------------------------------ #

    def covariance(self) -> np.ndarray:
        """User-facing covariance matrix (reference get_covariance,
        blue_models.py:166-179): NaN where models have no edge or the entry
        is unknown, 0 where known-uncorrelated, the value otherwise."""
        C = np.where(self.uncorrelated, 0.0, self.value)
        C = np.where(self.edges & ~self.unknown, C, np.nan)
        return C

    def correlation(self) -> np.ndarray:
        C = self.covariance()
        s = np.sqrt(np.diag(C))
        return C / np.outer(s, s)

    def adjacency(self) -> np.ndarray:
        """Reference graph-encoded adjacency (for npz compatibility,
        blue_models.py:267): 0 = no edge, inf = uncorrelated, NaN = unknown,
        finite = value."""
        A = np.where(self.uncorrelated, np.inf, self.value)
        A = np.where(self.unknown, np.nan, A)
        A = np.where(self.edges, A, 0.0)
        np.fill_diagonal(A, np.diag(np.where(np.isnan(A), np.nan, A)))
        return A

    @classmethod
    def from_adjacency(cls, A: np.ndarray) -> "CovarianceGraph":
        """Inverse of :meth:`adjacency` (reference load_graph_data path,
        blue_models.py:284-292)."""
        g = cls.__new__(cls)
        A = np.asarray(A, dtype=float)
        M = A.shape[0]
        g.M = M
        no_edge = (A == 0.0) & ~np.isnan(A)
        np.fill_diagonal(no_edge, False)
        g.edges = ~no_edge
        g.couplable = g.edges.copy()
        g.unknown = np.isnan(A) & g.edges
        g.uncorrelated = np.isinf(A) & g.edges
        g.value = np.where(g.unknown | g.uncorrelated | ~g.edges, 0.0, A)
        g.component = list(range(M))
        return g

    # ------------------------------------------------------------------ #

    def missing_rows(self) -> list:
        """Models involved in any unknown entry (the pilot sampling set,
        reference blue_models.py:327-328)."""
        need = np.any(self.unknown, axis=1)
        return [int(i) for i in np.where(need)[0]]

    def set_estimated(self, i: int, j: int, cov_ij: float, rho_ij: float) -> None:
        """Record an estimated entry; |rho| below tolerance marks the pair
        uncorrelated (reference blue_models.py:341-346)."""
        for a, b in ((i, j), (j, i)):
            self.unknown[a, b] = False
            if abs(rho_ij) < UNCORRELATED_RHO_TOL and a != b:
                self.uncorrelated[a, b] = True
                self.value[a, b] = 0.0
            else:
                self.uncorrelated[a, b] = False
                self.value[a, b] = cov_ij

    def apply_projection(self, C_new: np.ndarray) -> None:
        """Install an SPD-projected covariance (reference
        blue_models.py:410-431).  ``C_new`` uses the sentinel encoding:
        NaN = keep uncoupled, inf = now-uncorrelated, finite = value."""
        M = self.M
        for i in range(M):
            for j in range(M):
                v = C_new[i, j]
                if np.isnan(v):
                    # stays uncoupled: reference sets the edge weight to 0,
                    # which get_covariance decodes back to NaN.
                    if self.edges[i, j] and i != j:
                        self.edges[i, j] = False
                    continue
                self.unknown[i, j] = False
                self.edges[i, j] = True
                if np.isinf(v) and i != j:
                    self.uncorrelated[i, j] = True
                    self.value[i, j] = 0.0
                else:
                    self.uncorrelated[i, j] = False
                    self.value[i, j] = v

    def check(self, remove_uncorrelated: bool = True, warn=None) -> None:
        """Prune uncorrelated edges and find the component of model 0
        (reference check_graph, blue_models.py:305-316)."""
        if remove_uncorrelated:
            self.edges &= ~self.uncorrelated
            np.fill_diagonal(self.edges, True)
        adj = self.edges.copy()
        np.fill_diagonal(adj, False)
        comp = _cl.connected_component(adj, 0)
        self.component = comp
        if len(comp) < self.M and warn is not None:
            warn("WARNING! Model graph is not connected. "
                 "Connected graph size: %d" % len(comp))

    # ------------------------------------------------------------------ #

    def clique_adjacency(self) -> np.ndarray:
        adj = self.edges.copy()
        np.fill_diagonal(adj, False)
        return adj

    def permute(self, ordering) -> None:
        """Relabel models (reference reorder_graph_nodes,
        blue_models.py:204-230)."""
        p = np.asarray(ordering, dtype=int)
        for name in ("couplable", "unknown", "uncorrelated", "value", "edges"):
            A = getattr(self, name)
            setattr(self, name, A[np.ix_(p, p)])
        inv = {int(o): i for i, o in enumerate(p)}
        self.component = sorted(inv[c] for c in self.component if c in inv)
