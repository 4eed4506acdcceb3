"""ctypes loader for the native host kernels (with auto-build attempt)."""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "libbluest_native.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # make compares time stamps, so a library older than its source is
    # rebuilt (into a temporary name, then renamed: several processes may
    # get here at once)
    try:
        subprocess.run(["make", "-C", _HERE], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        if not os.path.exists(_LIB_PATH):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.bluest_dykstra
    except (OSError, AttributeError):
        return None
    lib.bluest_enumerate_cliques.restype = ctypes.c_int64
    lib.bluest_enumerate_cliques.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.bluest_corner_filter.restype = ctypes.c_int64
    lib.bluest_corner_filter.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.bluest_dykstra.restype = None
    lib.bluest_dykstra.argtypes = [dptr, dptr, dptr, dptr, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32, dptr, dptr]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def corner_filter(lb, ub, base_cost, w, budget, e_rows, e_base,
                  cap_rows, cap_rhs):
    """Feasibility mask over all 2^LL floor/ceil corners, computed in one
    native pass (budget, coverage, and cap rows together).  Returns a
    (2^LL,) bool array or None when the shared library is unavailable.

    ``budget <= 0`` disables the budget row.  ``cap_rhs`` must already
    have the frozen part of the allocation subtracted."""
    lib = _load()
    if lib is None:
        return None
    lb = np.ascontiguousarray(lb, dtype=np.int64)
    ub = np.ascontiguousarray(ub, dtype=np.int64)
    LL = len(lb)
    w = np.ascontiguousarray(w, dtype=np.float64)
    e_rows = np.ascontiguousarray(np.atleast_2d(e_rows), dtype=np.float64) \
        if len(e_rows) else np.zeros((0, LL))
    e_base = np.ascontiguousarray(e_base, dtype=np.float64)
    cap_rows = np.ascontiguousarray(np.atleast_2d(cap_rows),
                                    dtype=np.float64) \
        if len(cap_rows) else np.zeros((0, LL))
    cap_rhs = np.ascontiguousarray(cap_rhs, dtype=np.float64)
    keep = np.empty(1 << LL, dtype=np.uint8)
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.bluest_corner_filter(
        lb.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ub.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), LL,
        float(base_cost), w.ctypes.data_as(dptr),
        float(budget) if budget is not None else 0.0,
        e_rows.ctypes.data_as(dptr), e_base.ctypes.data_as(dptr),
        e_rows.shape[0], cap_rows.ctypes.data_as(dptr),
        cap_rhs.ctypes.data_as(dptr), cap_rows.shape[0],
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.astype(bool)


def dykstra(x, A, b, nrm2, n_sweeps):
    """Dykstra projection of ``x`` onto {y >= 0, A y <= b} with the exact
    feasibility repair (see bluest_native.cpp); ``A`` is (q, L) C-contiguous
    float64.  Returns a new (L,) array, or None when the shared library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    q, L = A.shape
    work = np.empty((q + 2) * L, dtype=np.float64)
    y = np.empty(L, dtype=np.float64)
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.bluest_dykstra(x.ctypes.data_as(dptr), A.ctypes.data_as(dptr),
                       b.ctypes.data_as(dptr), nrm2.ctypes.data_as(dptr),
                       q, L, int(n_sweeps), work.ctypes.data_as(dptr),
                       y.ctypes.data_as(dptr))
    return y


def enumerate_cliques(adj: np.ndarray, max_size: int, nodes=None):
    """Native all-cliques enumeration; returns list of lists or None when
    the shared library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    M = adj.shape[0]
    if M > 64:
        return None
    adj8 = np.ascontiguousarray(adj.astype(np.uint8))
    universe = np.ascontiguousarray(
        np.arange(M, dtype=np.int32) if nodes is None
        else np.asarray(sorted(nodes), dtype=np.int32))
    width = int(max_size) + 1
    cap = (1 << 20) * width
    while True:
        out = np.empty(cap, dtype=np.int32)
        n = lib.bluest_enumerate_cliques(
            adj8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), M,
            int(max_size),
            universe.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(universe),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if n == -1:
            cap *= 4
            continue
        if n < 0:
            return None
        break
    rec = out[:n * width].reshape(n, width)
    cliques = [None] * n
    sizes = rec[:, 0]
    idx_all = np.arange(n)
    for k in range(1, width):
        rows = idx_all[sizes == k]
        if len(rows) == 0:
            continue
        block = rec[rows, 1:k + 1].tolist()
        for r, c in zip(rows, block):
            cliques[r] = c
    return cliques
