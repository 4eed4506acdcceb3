"""K3, K4 and K5: the allocation's batched eigenvalue, singular value and
eigenvector solves of small dense float64 matrices, their plain versions
and their loader.

* :func:`sym_eigvalsh` (K3): the eigenvalues, ascending, of each
  symmetric matrix of a batch (B, n, n): ``(w (B, n), status (B,))``.
* :func:`nt_svd` (K4): the left singular vectors and the singular values,
  descending, of each matrix of a batch (B, n, n): ``(U (B, n, n),
  S (B, n), status (B,))``.  V is not formed.
* :func:`sym_eigh` (K5): the eigenvalues, ascending, and the eigenvectors
  of each symmetric matrix: ``(w (B, n), V (B, n, n), status (B,))``, A =
  V diag(w) V^T.
* :func:`pinv00` (K5): ``pinv(A)[0, 0]`` of each symmetric matrix, the
  eigenvalues with ``|w| <= rcond max|w|`` cut off: ``(var (B,),
  status (B,))``.  The integer corner search's variances (rcond 1e-10)
  and ``core.psi.variance`` (1e-12).

``status`` is int32, one a matrix: 0 converged, 1 a non-finite entry
(the results NaN), 2 the Jacobi sweeps ran out.  The interior-point
solver (``solvers/sdp.py``) folds it into the statuses of its one packed
read, as it does ``torch.linalg.cholesky_ex``'s; every caller that
reads it checks it with :func:`require_converged`.

* A CUDA tensor launches the hand-written kernel of
  ``bluest_tpu_torch/csrc/psd_eig.cu`` (cyclic Jacobi, one warp a matrix
  for n <= 32, one thread block a matrix past that; K5 is K3 with its
  rotations accumulated, K3's eigenvalues bit for bit), built with nvcc
  at first use into ``build/bluest_tpu_torch/`` and loaded through
  ctypes.  It never synchronises, so an IPM iteration can be captured in
  one CUDA graph and the corner search can dispatch every chunk before
  it reads any.  Each launch is counted in the wrapper's ``launches``; a
  launch recorded into a graph being captured is counted in ``captured``
  instead, and the graph's owner adds its captured launches to
  ``launches`` at each replay (:func:`count_replay`).  Nothing falls
  back: a build or launch failure raises.
* A CPU tensor runs the plain version, :func:`sym_eigvalsh_plain`,
  :func:`nt_svd_plain`, :func:`sym_eigh_plain` or :func:`pinv00_plain`:
  ``torch.linalg.eigvalsh``, ``torch.linalg.svd`` reduced to (U, S) and
  ``torch.linalg.eigh`` (with the cutoff and the sum for pinv00), the
  calls the allocation made before, with a zero status (a failed LAPACK
  solve raises ``torch.linalg.LinAlgError`` as it did).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import _build

__all__ = ["sym_eigvalsh", "nt_svd", "sym_eigh", "pinv00",
           "sym_eigvalsh_plain", "nt_svd_plain", "sym_eigh_plain",
           "pinv00_plain", "require_converged", "count_replay",
           "build_library"]

_SOURCE = os.path.join(_build.CSRC_DIR, "psd_eig.cu")
NVCC_FLAGS = list(_build.BASE_FLAGS)

_lib = None
_lib_lock = threading.Lock()
build_log = ""          # nvcc's output (register / spill report) of the build


def build_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the K3/K4/K5 shared
    library."""
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
        lib.bluest_sym_eigh_f64.restype = I
        lib.bluest_sym_eigh_f64.argtypes = [P, P, P, P, P, P, I, I, P]
        lib.bluest_pinv00_f64.restype = I
        lib.bluest_pinv00_f64.argtypes = [P, P, P, P, P, ctypes.c_double,
                                          I, I, P]
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


def sym_eigh_plain(A: torch.Tensor):
    """Plain version of K5's eigendecomposition on any device:
    ``torch.linalg.eigh``."""
    _check(A, "sym_eigh")
    w, V = torch.linalg.eigh(A)
    return w, V, _zero_status(A)


def pinv00_plain(A: torch.Tensor, rcond: float):
    """Plain version of K5's ``pinv(A)[0, 0]`` on any device:
    ``torch.linalg.eigh``, the eigenvalues with ``|w| <= rcond max|w|``
    cut off, then ``sum(v0 * (1 / w) * v0)`` over V's first row (the JAX
    package's ``integer._chunk_var00``)."""
    _check(A, "pinv00")
    w, V = torch.linalg.eigh(A)
    cutoff = rcond * torch.max(torch.abs(w), dim=-1, keepdim=True).values
    inv_w = torch.where(torch.abs(w) > cutoff, 1.0 / w,
                        torch.zeros((), dtype=w.dtype, device=w.device))
    v0 = V[:, 0, :]
    return torch.sum(v0 * inv_w * v0, dim=-1), _zero_status(A)


def require_converged(status, name: str, strict: bool = False) -> None:
    """Raise ``torch.linalg.LinAlgError``, naming the first failed matrix
    of the batch, where the Jacobi sweeps ran out (status 2), as a failed
    ``torch.linalg`` solve raises; a non-finite matrix (status 1, its
    results NaN as LAPACK's) passes.  ``strict`` raises on any non-zero
    status (the interior-point solver's start and polish, whose statuses
    include ``torch.linalg.cholesky_ex``'s).  ``status`` is a tensor (a
    card's is read once, one synchronisation) or an array already
    read."""
    bad = status != 0 if strict else status >= 2
    if bool(bad.any()):
        k = int(bad.nonzero()[0][0])
        raise torch.linalg.LinAlgError(
            "%s: matrix %d of the batch failed with status %d (1: a "
            "non-finite entry, 2: the Jacobi sweeps ran out, else a "
            "Cholesky factorization's)" % (name, k, int(status[k])))


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


# the C entry point and the kernel's name for each workspace kind
_ENTRIES = {3: ("bluest_sym_eigvalsh_f64", "K3"),
            4: ("bluest_nt_svd_f64", "K4"),
            5: ("bluest_sym_eigh_f64", "K5"),
            6: ("bluest_pinv00_f64", "K5")}


def _launch(fn, kind: int, A: torch.Tensor, outs, *args) -> None:
    """Launch the kernel of ``kind`` on the batch A (B >= 1, n >= 1) into
    ``outs`` on the current stream: the entry point takes A, the outputs,
    a null sweeps pointer, the workspace, ``args``, B, n and the stream.
    Raises on a CUDA error; counts the launch on the wrapper ``fn``."""
    lib = build_library()
    entry, name = _ENTRIES[kind]
    B, n = A.shape[0], A.shape[1]
    with torch.cuda.device(A.device):
        work = _workspace(lib, kind, A)
        rc = getattr(lib, entry)(
            A.data_ptr(), *[t.data_ptr() for t in outs], None,
            work.data_ptr(), *args, B, n,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("%s: %s launch failed: CUDA error %d (B=%d, n=%d)"
                           % (fn.__name__, name, rc, B, n))
    _counted(fn)


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
    _launch(sym_eigvalsh, 3, A, (w, status))
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
    _launch(nt_svd, 4, M, (U, S, status))
    return U, S, status


def sym_eigh(A: torch.Tensor):
    """(B, n, n) symmetric float64 -> (eigenvalues (B, n) ascending,
    eigenvectors V (B, n, n) as columns, status (B,) int32), A = V diag(w)
    V^T, from A's lower triangle.  CUDA tensors launch K5 or raise; CPU
    tensors run :func:`sym_eigh_plain`."""
    _check(A, "sym_eigh")
    if A.device.type == "cpu":
        return sym_eigh_plain(A)
    B, n = A.shape[0], A.shape[1]
    w = torch.empty((B, n), dtype=torch.float64, device=A.device)
    V = torch.empty((B, n, n), dtype=torch.float64, device=A.device)
    status = torch.empty(B, dtype=torch.int32, device=A.device)
    if B == 0 or n == 0:
        return w, V, status.zero_()
    _launch(sym_eigh, 5, A, (w, V, status))
    return w, V, status


def pinv00(A: torch.Tensor, rcond: float):
    """(B, n, n) symmetric float64 -> (pinv(A_b)[0, 0] (B,), status (B,)
    int32), the eigenvalues with ``|w| <= rcond max|w|`` cut off.  CUDA
    tensors launch K5 or raise; CPU tensors run :func:`pinv00_plain`."""
    _check(A, "pinv00")
    if A.device.type == "cpu":
        return pinv00_plain(A, rcond)
    B, n = A.shape[0], A.shape[1]
    var = torch.empty(B, dtype=torch.float64, device=A.device)
    status = torch.empty(B, dtype=torch.int32, device=A.device)
    if B == 0 or n == 0:
        return var.zero_(), status.zero_()
    _launch(pinv00, 6, A, (var, status), float(rcond))
    return var, status


for _fn in (sym_eigvalsh, nt_svd, sym_eigh, pinv00):
    _fn.launches = 0
    _fn.captured = 0
del _fn
