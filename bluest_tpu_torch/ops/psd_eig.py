"""K3 and K4: the interior-point iteration's batched eigenvalue and
singular value solves of small dense float64 matrices, their plain
versions and their loader.

* :func:`sym_eigvalsh` (K3): the eigenvalues, ascending, of each
  symmetric matrix of a batch (B, n, n): ``(w (B, n), status (B,))``.
* :func:`nt_svd` (K4): the left singular vectors and the singular values,
  descending, of each matrix of a batch (B, n, n): ``(U (B, n, n),
  S (B, n), status (B,))``.  V is not formed.

``status`` is int32, one a matrix: 0 converged, 1 a non-finite entry
(the results NaN), 2 the Jacobi sweeps ran out.  The interior-point
solver (``solvers/sdp.py``) folds it into the statuses of its one packed
read, as it does ``torch.linalg.cholesky_ex``'s.

* A CUDA tensor launches the hand-written kernel of
  ``bluest_tpu_torch/csrc/psd_eig.cu`` (cyclic Jacobi, one warp a matrix
  for n <= 32, one thread block a matrix past that), built with nvcc at
  first use into ``build/bluest_tpu_torch/`` and loaded through ctypes.
  It never synchronises, so an IPM iteration can be captured in one CUDA
  graph.  Each launch is counted in the
  wrapper's ``launches``; a launch recorded into a graph being captured
  is counted in ``captured`` instead, and the graph's owner adds its
  captured launches to ``launches`` at each replay (:func:`count_replay`).
  Nothing falls back: a build or launch failure raises.
* A CPU tensor runs the plain version, :func:`sym_eigvalsh_plain` or
  :func:`nt_svd_plain`: ``torch.linalg.eigvalsh`` and ``torch.linalg.svd``
  reduced to (U, S), the calls the IPM made before, with a zero status (a
  failed LAPACK solve raises ``torch.linalg.LinAlgError`` as it did).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import _build

__all__ = ["sym_eigvalsh", "nt_svd", "sym_eigvalsh_plain", "nt_svd_plain",
           "count_replay", "build_library"]

_SOURCE = os.path.join(_build.CSRC_DIR, "psd_eig.cu")
NVCC_FLAGS = list(_build.BASE_FLAGS)

_lib = None
_lib_lock = threading.Lock()
build_log = ""          # nvcc's output (register / spill report) of the build


def build_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the K3/K4 shared library."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _build.build(_SOURCE, NVCC_FLAGS)
        build_log = _build.build_logs.get(path, "")
        lib = ctypes.CDLL(path)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.bluest_sym_eigvalsh_f64.restype = I
        lib.bluest_sym_eigvalsh_f64.argtypes = [P, P, P, P, P, I, I, P]
        lib.bluest_nt_svd_f64.restype = I
        lib.bluest_nt_svd_f64.argtypes = [P, P, P, P, P, P, I, I, P]
        lib.bluest_psd_empty.restype = I
        lib.bluest_psd_empty.argtypes = [I, P]
        lib.bluest_psd_work_doubles.restype = ctypes.c_longlong
        lib.bluest_psd_work_doubles.argtypes = [I, I]
        _lib = lib
        return _lib


def _check(A: torch.Tensor, name: str) -> None:
    if not isinstance(A, torch.Tensor):
        raise TypeError("%s: the batch must be a torch.Tensor" % name)
    if A.dtype != torch.float64:
        raise TypeError("%s: the batch must be float64, got %s"
                        % (name, A.dtype))
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError("%s: the batch must be (B, n, n), got %s"
                         % (name, tuple(A.shape)))
    if not A.is_contiguous():
        raise ValueError("%s: the batch must be contiguous" % name)
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (name, A.device))
    if A.numel() >= 2 ** 31:
        raise ValueError("%s: B * n * n = %d exceeds the kernel's int index"
                         % (name, A.numel()))


def _zero_status(A: torch.Tensor) -> torch.Tensor:
    return torch.zeros(A.shape[0], dtype=torch.int32, device=A.device)


def sym_eigvalsh_plain(A: torch.Tensor):
    """Plain version of K3 on any device: ``torch.linalg.eigvalsh``."""
    _check(A, "sym_eigvalsh")
    return torch.linalg.eigvalsh(A), _zero_status(A)


def nt_svd_plain(M: torch.Tensor):
    """Plain version of K4 on any device: ``torch.linalg.svd`` reduced to
    (U, S)."""
    _check(M, "nt_svd")
    U, S, _ = torch.linalg.svd(M)
    return U, S, _zero_status(M)


def _workspace(lib, kind: int, A: torch.Tensor) -> torch.Tensor:
    """The global-memory working copies of a batch whose matrices do not
    fit a block's shared memory (an empty tensor when they fit)."""
    words = lib.bluest_psd_work_doubles(kind, A.shape[1])
    return torch.empty(A.shape[0] * words, dtype=torch.float64,
                       device=A.device)


def _counted(fn) -> None:
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1        # recorded, not run: counted at each replay
    else:
        fn.launches += 1


def count_replay(captured: dict) -> None:
    """Add one replay of a graph to the launch counts: ``captured`` maps
    each wrapper to the launches recorded in the graph's capture."""
    for fn, k in captured.items():
        fn.launches += k


def sym_eigvalsh(A: torch.Tensor):
    """(B, n, n) symmetric float64 -> (eigenvalues (B, n) ascending,
    status (B,) int32).  CUDA tensors launch K3 or raise; CPU tensors run
    :func:`sym_eigvalsh_plain`."""
    _check(A, "sym_eigvalsh")
    if A.device.type == "cpu":
        return sym_eigvalsh_plain(A)
    B, n = A.shape[0], A.shape[1]
    w = torch.empty((B, n), dtype=torch.float64, device=A.device)
    status = torch.empty(B, dtype=torch.int32, device=A.device)
    if B == 0 or n == 0:
        return w, status.zero_()
    lib = build_library()
    with torch.cuda.device(A.device):
        work = _workspace(lib, 3, A)
        rc = lib.bluest_sym_eigvalsh_f64(
            A.data_ptr(), w.data_ptr(), status.data_ptr(), None,
            work.data_ptr(), B, n, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("sym_eigvalsh: K3 launch failed: CUDA error %d "
                           "(B=%d, n=%d)" % (rc, B, n))
    _counted(sym_eigvalsh)
    return w, status


def nt_svd(M: torch.Tensor):
    """(B, n, n) float64 -> (U (B, n, n), singular values (B, n)
    descending, status (B,) int32), M = U diag(S) V^T.  CUDA tensors
    launch K4 or raise; CPU tensors run :func:`nt_svd_plain`."""
    _check(M, "nt_svd")
    if M.device.type == "cpu":
        return nt_svd_plain(M)
    B, n = M.shape[0], M.shape[1]
    U = torch.empty((B, n, n), dtype=torch.float64, device=M.device)
    S = torch.empty((B, n), dtype=torch.float64, device=M.device)
    status = torch.empty(B, dtype=torch.int32, device=M.device)
    if B == 0 or n == 0:
        return U, S, status.zero_()
    lib = build_library()
    with torch.cuda.device(M.device):
        work = _workspace(lib, 4, M)
        rc = lib.bluest_nt_svd_f64(
            M.data_ptr(), U.data_ptr(), S.data_ptr(), status.data_ptr(),
            None, work.data_ptr(), B, n,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("nt_svd: K4 launch failed: CUDA error %d "
                           "(B=%d, n=%d)" % (rc, B, n))
    _counted(nt_svd)
    return U, S, status


for _fn in (sym_eigvalsh, nt_svd):
    _fn.launches = 0
    _fn.captured = 0
del _fn
