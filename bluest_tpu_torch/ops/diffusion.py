"""K1: the fused diffusion model, its plain PyTorch version and its loader.

``diffusion_outputs`` is the port of
``bluest_tpu/ops/pallas_diffusion.py:diffusion_outputs_pallas``: batched
three-QoI evaluation of the lognormal diffusion model, ``xis (B, n_kl)``
(already masked to the model's modes) -> ``(B, 3)`` in ``xis``' dtype.

* A CUDA tensor launches the hand-written kernel of
  ``bluest_tpu_torch/csrc/diffusion.cu`` (float32 or float64), built with
  nvcc at first use into ``build/bluest_tpu_torch/`` next to the package
  and loaded through ctypes.  Nothing falls back: a build or launch
  failure raises.
* A CPU tensor runs :func:`diffusion_outputs_plain`, the same Thomas loop
  order over a ``(n, B)`` layout in PyTorch ops.  The tests use it on the
  CPU, and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

__all__ = ["diffusion_outputs", "diffusion_outputs_plain", "mode_matrix",
           "build_library"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "diffusion.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "bluest_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lib_lock = threading.Lock()
build_log = ""          # nvcc's output (register / spill report) of the build


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the K1 diffusion kernel is built from "
            "bluest_tpu_torch/csrc/diffusion.cu at first use and needs the "
            "CUDA toolkit (nvcc on PATH or /usr/local/cuda/bin/nvcc)")
    return nvcc


def build_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the K1 shared library."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(_SOURCE, "rb") as f:
            src = f.read()
        tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        path = os.path.join(BUILD_DIR, "libbluest_diffusion_%s.so" % tag[:16])
        if not os.path.exists(path):
            nvcc = _find_nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [nvcc] + NVCC_FLAGS + ["-o", tmp, _SOURCE],
                    capture_output=True, text=True, timeout=600)
                build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError("nvcc failed to build %s:\n%s"
                                       % (_SOURCE, build_log))
                os.replace(tmp, path)     # atomic: concurrent builds agree
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(path)
        for name in ("bluest_diffusion_outputs_f32",
                     "bluest_diffusion_outputs_f64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
                ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
        _lib = lib
        return _lib


@functools.lru_cache(maxsize=64)
def mode_matrix(n_cells: int, n_kl: int, sigma: float, nu: float,
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """mck (n_cells, n_kl): sin(pi x_i k) * sigma k^-nu sqrt(2), x_i the
    cell-face midpoints (i + 1/2) h -- computed in f64 on the host, then
    cast, as the Pallas kernel does.  Read-only: cached per shape."""
    h = 1.0 / n_cells
    xf = (np.arange(n_cells) + 0.5) * h
    k = np.arange(1, n_kl + 1)
    ck = sigma * k ** (-nu) * np.sqrt(2.0)
    mck = np.sin(np.pi * xf[:, None] * k[None, :]) * ck[None, :]
    return torch.as_tensor(mck, dtype=dtype).to(device).contiguous()


def _check(xis: torch.Tensor, n_cells: int):
    if not isinstance(xis, torch.Tensor):
        raise TypeError("xis must be a torch.Tensor")
    if xis.dtype not in (torch.float32, torch.float64):
        raise TypeError("xis must be float32 or float64, got %s" % xis.dtype)
    if xis.dim() != 2 or xis.shape[1] < 1:
        raise ValueError("xis must be (B, n_kl) with n_kl >= 1, got %s"
                         % (tuple(xis.shape),))
    if not xis.is_contiguous():
        raise ValueError("xis must be contiguous")
    if int(n_cells) < 1:
        raise ValueError("n_cells must be >= 1, got %s" % n_cells)


def diffusion_outputs_plain(xis: torch.Tensor, n_cells: int,
                            sigma: float = 1.0,
                            nu: float = 1.5) -> torch.Tensor:
    """Plain PyTorch version of K1: the kernel's operations in the
    kernel's order, vectorized over the batch in a (row, batch) layout."""
    _check(xis, n_cells)
    n = int(n_cells)
    dt, dev = xis.dtype, xis.device
    B, n_kl = xis.shape
    m = n - 1
    if m <= 0 or B == 0:
        return torch.zeros((B, 3), dtype=dt, device=dev)
    h = 1.0 / n
    inv_h2 = torch.tensor(1.0 / h ** 2, dtype=dt, device=dev)
    h_t = torch.tensor(h, dtype=dt, device=dev)
    mck = mode_matrix(n, n_kl, float(sigma), float(nu), dt, dev)
    xiT = xis.T
    log_a = mck[:, 0:1] * xiT[0:1]
    for k in range(1, n_kl):
        log_a = log_a + mck[:, k:k + 1] * xiT[k:k + 1]
    a = torch.exp(log_a)                                   # (n, B)

    cps = torch.empty((m, B), dtype=dt, device=dev)
    dps = torch.empty((m, B), dtype=dt, device=dev)
    cp_prev = torch.zeros(B, dtype=dt, device=dev)
    dp_prev = torch.zeros(B, dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    for i in range(m):
        ai, ai1 = a[i], a[i + 1]
        diag = (ai + ai1) * inv_h2
        low = -(ai * inv_h2)
        up = -(ai1 * inv_h2)
        denom = diag - low * cp_prev
        cp_prev = up / denom
        dp_prev = (one - low * dp_prev) / denom
        cps[i] = cp_prev
        dps[i] = dp_prev

    mid = n // 2 - 1
    x_next = torch.zeros(B, dtype=dt, device=dev)
    s_int = torch.zeros(B, dtype=dt, device=dev)
    energy = torch.zeros(B, dtype=dt, device=dev)
    x_mid = torch.zeros(B, dtype=dt, device=dev)
    for i in range(m - 1, -1, -1):
        x = dps[i] - cps[i] * x_next
        s_int = s_int + x
        d = x_next - x
        energy = energy + (a[i + 1] * d) * d
        if i == mid:
            x_mid = x
        x_next = x
    energy = energy + (a[0] * x_next) * x_next
    return torch.stack([h_t * s_int, x_mid, energy / h_t], dim=1)


def diffusion_outputs(xis: torch.Tensor, n_cells: int, sigma: float = 1.0,
                      nu: float = 1.5) -> torch.Tensor:
    """K1 wrapper: (B, n_kl) masked xi -> (B, 3) QoIs.  CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    _check(xis, n_cells)
    if xis.device.type == "cpu":
        return diffusion_outputs_plain(xis, n_cells, sigma, nu)
    if xis.device.type != "cuda":
        raise ValueError("diffusion_outputs: unsupported device %s"
                         % xis.device)
    n = int(n_cells)
    B, n_kl = xis.shape
    if B >= 2 ** 31:
        raise ValueError("diffusion_outputs: B=%d exceeds the kernel's int "
                         "batch index" % B)
    out = torch.empty((B, 3), dtype=xis.dtype, device=xis.device)
    if B == 0:
        return out
    lib = build_library()
    fn = (lib.bluest_diffusion_outputs_f32 if xis.dtype == torch.float32
          else lib.bluest_diffusion_outputs_f64)
    mck = mode_matrix(n, n_kl, float(sigma), float(nu), xis.dtype,
                      xis.device)
    ws = torch.empty((max(3 * n - 2, 1) * B,), dtype=xis.dtype,
                     device=xis.device)
    h = 1.0 / n
    with torch.cuda.device(xis.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xis.data_ptr(), mck.data_ptr(), out.data_ptr(),
                ws.data_ptr(), B, n_kl, n, 1.0 / h ** 2, h, stream)
    if rc != 0:
        raise RuntimeError("K1 diffusion kernel launch failed: CUDA error "
                           "%d (B=%d, n_kl=%d, n_cells=%d)"
                           % (rc, B, n_kl, n))
    diffusion_outputs.launches += 1
    return out


diffusion_outputs.launches = 0
