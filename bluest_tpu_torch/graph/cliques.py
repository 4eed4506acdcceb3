"""Clique and connectivity utilities over small model graphs.

The reference uses networkx for clique enumeration, connectivity checks and
graph intersections (blue_models.py:2,254,313-316,465,598,663,811).  Model
counts are tiny (M <= a few tens), so we use Python-int bitmask adjacency:
branch-free set algebra, no graph library, and orders of magnitude faster
than networkx for the all-cliques sweep used by ``setup_solver``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def adjacency_bitmasks(adj: np.ndarray) -> List[int]:
    """Convert a boolean adjacency matrix to per-node neighbor bitmasks.

    Self-loops are ignored: bit j of mask[i] is set iff i != j and adj[i, j].
    """
    M = adj.shape[0]
    masks = []
    for i in range(M):
        m = 0
        row = adj[i]
        for j in range(M):
            if j != i and row[j]:
                m |= 1 << j
        masks.append(m)
    return masks


def enumerate_cliques(adj: np.ndarray, max_size: int,
                      nodes: Sequence[int] | None = None) -> List[List[int]]:
    """All cliques of the graph with size <= max_size, as sorted node lists.

    Matches the set produced by networkx ``enumerate_all_cliques`` truncated
    at ``max_size`` (reference blue_models.py:465-470).  ``nodes`` optionally
    restricts the universe (used to stay inside the connected component of
    model 0, reference blue_models.py:468).

    Dispatches to the native C++ kernel (_native/bluest_native.cpp) when
    built; the pure-Python bitmask DFS below is the fallback and the oracle.
    """
    M = adj.shape[0]
    if M <= 64:
        try:
            from .. import _native
            out = _native.enumerate_cliques(np.asarray(adj, dtype=bool),
                                            max_size, nodes)
            if out is not None:
                return out
        except Exception:
            pass
    masks = adjacency_bitmasks(adj)
    if nodes is None:
        universe = list(range(M))
    else:
        universe = sorted(nodes)
    allowed = 0
    for v in universe:
        allowed |= 1 << v

    out: List[List[int]] = []

    # DFS: extend each clique only with neighbors of all members that have a
    # larger index than the last member -> every clique generated exactly once.
    def grow(clique: List[int], cand: int) -> None:
        if len(clique) >= max_size:
            return
        c = cand
        while c:
            v = (c & -c).bit_length() - 1
            c &= c - 1
            nxt = clique + [v]
            out.append(nxt)
            # neighbors of v with index > v, still common to the clique
            higher = ~((1 << (v + 1)) - 1)
            grow(nxt, cand & masks[v] & higher)

    for v in universe:
        out.append([v])
        higher = ~((1 << (v + 1)) - 1)
        grow([v], masks[v] & allowed & higher)

    return out


def connected_component(adj: np.ndarray, start: int = 0) -> List[int]:
    """Nodes reachable from ``start`` (BFS over the boolean adjacency)."""
    M = adj.shape[0]
    masks = adjacency_bitmasks(adj)
    seen = 1 << start
    frontier = 1 << start
    while frontier:
        nxt = 0
        f = frontier
        while f:
            v = (f & -f).bit_length() - 1
            f &= f - 1
            nxt |= masks[v]
        frontier = nxt & ~seen
        seen |= frontier
    return [i for i in range(M) if (seen >> i) & 1]


def is_connected(adj: np.ndarray) -> bool:
    return len(connected_component(adj, 0)) == adj.shape[0]


def is_clique(adj: np.ndarray, nodes: Sequence[int]) -> bool:
    """True iff ``nodes`` form a clique (reference is_subclique,
    blue_models.py:33-36; note self-edges always count)."""
    nodes = list(nodes)
    for a in range(len(nodes)):
        for b in range(a + 1, len(nodes)):
            if not adj[nodes[a], nodes[b]]:
                return False
    return True


def has_path_edges(adj: np.ndarray, chain: Sequence[int]) -> bool:
    """True iff every consecutive pair in ``chain`` is an edge
    (MLMC chain feasibility, reference blue_models.py:669)."""
    return all(adj[i, j] for i, j in zip(chain[:-1], chain[1:]))
