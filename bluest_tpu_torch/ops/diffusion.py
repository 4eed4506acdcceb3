"""K1: the fused diffusion model, its plain PyTorch version and its loader.

``diffusion_outputs`` is the port of
``bluest_tpu/ops/pallas_diffusion.py:diffusion_outputs_pallas``: batched
three-QoI evaluation of the lognormal diffusion model, ``xis (B, n_kl)``
(already masked to the model's modes) -> ``(B, 3)`` in ``xis``' dtype,
for any n_cells >= 1 and any n_kl >= 1.

* A CUDA tensor launches a hand-written kernel of
  ``bluest_tpu_torch/csrc/diffusion.cu`` (float32 or float64), built with
  nvcc at first use into ``build/bluest_tpu_torch/`` next to the package
  and loaded through ctypes.  :func:`tier` picks it: K1 where K1 has a
  tile (n_cells <= 1025, a lane's rows in registers, and the tile's
  coefficients and xi in one block's shared memory), the wide tier
  everywhere else.  The wide tier runs two stages over slabs of samples
  whose coefficients fit ~32 MB: stage 1 synthesizes a = exp(xis @
  mck^T) into a buffer that the wrapper allocates (FP64 tensor cores in
  f64), stage 2 solves each sample from it.  Nothing falls back: a build
  or launch failure of either tier raises.
* A CPU tensor runs :func:`diffusion_outputs_plain`, which is
  :func:`solve_plain` of :func:`synthesize_plain`: the mode sum taken in
  order, then the kernels' partitioned tridiagonal solve with the same
  partition of rows among lanes (:func:`lanes_per_sample`), loop order
  and reduction trees, in PyTorch ops over ``(B, lanes)``.  K1 and the
  wide tier in f32 are bit-equal to it; the wide tier in f64 is
  bit-equal to :func:`solve_plain` of its own stage 1, whose tensor-core
  sum differs from the in-order one within the bound of a sum taken in
  any order.  The tests use it on the CPU, and ``chip_smoke.py`` holds
  the kernels and each wide stage against it on the card.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np
import torch

from . import _build

__all__ = ["diffusion_outputs", "diffusion_outputs_plain", "synthesize_plain",
           "solve_plain", "synthesize", "solve", "mode_matrix",
           "lanes_per_sample", "partition", "tier", "launch",
           "build_library"]

_SOURCE = os.path.join(_build.CSRC_DIR, "diffusion.cu")
BUILD_DIR = _build.BUILD_DIR
NVCC_FLAGS = list(_build.BASE_FLAGS)    # K1 takes the base flags alone
_NO_TILE = -1              # the launcher's return for a shape it refuses
K1_MAX_CELLS = 32 * 32 + 1  # K1's reach: a lane keeps <= 32 rows in registers
MAX_LANES = 1024            # lanes of one sample at most (one block)
_MAX_SMEM = 232448          # opt-in shared memory of one block (H100)

_lib = None
_lib_lock = threading.Lock()
build_log = ""          # nvcc's output (register / spill report) of the build


def build_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the K1 shared library."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _build.build(_SOURCE, NVCC_FLAGS)
        build_log = _build.build_logs.get(path, "")
        lib = ctypes.CDLL(path)
        for name in ("bluest_diffusion_outputs_f32",
                     "bluest_diffusion_outputs_f64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
        for name in ("bluest_diffusion_wide_f32", "bluest_diffusion_wide_f64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
                ctypes.c_int] * 3 + [ctypes.c_double, ctypes.c_double,
                                     ctypes.c_void_p]
        for name in ("bluest_diffusion_wide_workspace_f32",
                     "bluest_diffusion_wide_workspace_f64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_longlong)]
        for name in ("bluest_diffusion_synth_f32",
                     "bluest_diffusion_synth_f64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
        for name in ("bluest_diffusion_solve_f32",
                     "bluest_diffusion_solve_f64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
                ctypes.c_int] * 2 + [ctypes.c_double] * 2 + [ctypes.c_void_p]
        lib.bluest_diffusion_wide_lanes.restype = ctypes.c_int
        lib.bluest_diffusion_wide_lanes.argtypes = [ctypes.c_int]
        lib.bluest_diffusion_wide_store.restype = ctypes.c_longlong
        lib.bluest_diffusion_wide_store.argtypes = [ctypes.c_int]
        lib.bluest_diffusion_max_cells.restype = ctypes.c_int
        lib.bluest_diffusion_max_cells.argtypes = []
        lib.bluest_diffusion_k1_fits.restype = ctypes.c_int
        lib.bluest_diffusion_k1_fits.argtypes = [ctypes.c_int] * 3
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


def lanes_per_sample(n_cells: int) -> int:
    """L(n): lanes that share one sample in the solve -- the smallest power
    of two that is >= min(n, 32) and >= ceil((n-1)/32), at most 1024.  A
    warp (32) for 33 <= n <= 1025, K1's reach; past it a lane still owns
    <= 32 rows up to n = 32769 (128 lanes at n = 4096)."""
    need = max(min(int(n_cells), 32), -(-(int(n_cells) - 1) // 32))
    lanes = 1
    while lanes < need and lanes < MAX_LANES:
        lanes <<= 1
    return lanes


def tier(n_cells: int, n_kl: int, dtype: torch.dtype) -> str:
    """Which kernel evaluates (B, n_kl) xi at n_cells on the card: "k1"
    where K1 has a tile -- n_cells <= 1025 and its tile of S samples (16
    in f32, 8 in f64) of padded coefficients and xi fits one block's
    shared memory, as ``csrc/diffusion.cu:k1_smem`` sizes it -- else
    "wide".  Pure Python, so the CPU and the card agree on it."""
    n = int(n_cells)
    itemsize = 4 if dtype == torch.float32 else 8
    S = 16 if itemsize == 4 else 8
    tile_ld = (n - 1) + ((n - 1) >> 5) + 1       # K1's padded row length
    fits = (n <= K1_MAX_CELLS
            and S * (tile_ld + int(n_kl)) * itemsize <= _MAX_SMEM)
    return "k1" if fits else "wide"


def partition(n_cells: int, lanes: int):
    """K1's rows per lane: the m = n-1 unknowns split over P = min(lanes,
    m) lanes, lane p owning rows [p m // P, (p+1) m // P) (one or more);
    lanes p >= P own none.  Returns P and the (lanes,) bounds s, e."""
    m = n_cells - 1
    P = min(lanes, m)
    p = torch.arange(lanes)
    s = torch.where(p < P, p * m // P, torch.full_like(p, m))
    e = torch.where(p < P, (p + 1) * m // P, torch.full_like(p, m))
    return P, s, e


def _fold(v: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (B,): the kernel's butterfly sum, as lane 0 sees it (at
    each level lane j adds lane j + L/2)."""
    while v.shape[1] > 1:
        half = v.shape[1] // 2
        v = v[:, :half] + v[:, half:]
    return v[:, 0]


def _shift(v: torch.Tensor, k: int, fill: float) -> torch.Tensor:
    """Lane p gets lane p - k (k > 0) or p + |k| (k < 0); `fill` where
    that lane is outside the group (the kernel's shfl_up / shfl_down)."""
    out = torch.full_like(v, fill)
    if k > 0:
        out[:, k:] = v[:, :-k]
    else:
        out[:, :k] = v[:, -k:]
    return out


def synthesize_plain(xis: torch.Tensor, n_cells: int, sigma: float = 1.0,
                     nu: float = 1.5) -> torch.Tensor:
    """a (B, n) = exp(xis @ mck^T), each cell's sum taken mode by mode in
    order k = 0, 1, ... with separate multiplies and adds: the plain
    version of the wide tier's stage 1 (and of K1's synthesis)."""
    _check(xis, n_cells)
    n = int(n_cells)
    B, n_kl = xis.shape
    mck = mode_matrix(n, n_kl, float(sigma), float(nu), xis.dtype,
                      xis.device)
    log_a = xis[:, 0:1] * mck[:, 0]                       # (B, n), k in order
    for k in range(1, n_kl):
        log_a = log_a + xis[:, k:k + 1] * mck[:, k]
    return torch.exp(log_a)


def solve_plain(a: torch.Tensor, n_cells: int) -> torch.Tensor:
    """(B, n) coefficients a -> (B, 3) QoIs: the kernels' partitioned
    tridiagonal solve with their partition of rows among L(n) lanes, loop
    order and reduction trees, vectorized over (B, lanes) -- the plain
    version of the wide tier's stage 2 (and of K1's solve).  See
    csrc/diffusion.cu for the method."""
    n = int(n_cells)
    dt, dev = a.dtype, a.device
    B = a.shape[0]
    if a.dim() != 2 or a.shape[1] != n:
        raise ValueError("a must be (B, n_cells=%d), got %s"
                         % (n, tuple(a.shape)))
    if n == 1 or B == 0:
        return torch.zeros((B, 3), dtype=dt, device=dev)
    m = n - 1
    L = lanes_per_sample(n)
    P, s, e = partition(n, L)
    s, e = s.to(dev), e.to(dev)
    c = e - s                                  # rows of each lane
    ni = (c - 1).clamp(min=0)                  # its interior rows
    lane = torch.arange(L, device=dev)
    active = lane < P
    last_lane = lane == P - 1
    h = 1.0 / n
    h2 = torch.tensor(h * h, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    Z = torch.zeros((B, L), dtype=dt, device=dev)

    def w(idx):                                # a at cell idx of each lane
        return a[:, idx.clamp(max=n - 1)]

    # interior rows s .. e-2 of each lane: Thomas down the rows for the
    # unit load (dpy) and the load w_s at the first row (dpa).  Past K1's
    # lanes (L > 32) each pivot is wi1 + e, its excess e = wi e' r' over the
    # next coefficient formed from the row before without cancellation
    # (the same value as (wi + wi1) - wi^2 r'); K1's form up to 32 lanes
    flux = L > 32
    CM = int(ni.max())
    cp, dpy, dpa, dpb, ex, r = Z, Z, Z, Z, Z, Z
    CP, DPY, DPA = [], [], []
    for t in range(CM):
        act = t < ni
        wi, wi1 = w(s + t), w(s + t + 1)
        lo = -wi
        if flux:
            ex = wi if t == 0 else torch.where(act, (wi * r) * ex, ex)
            r = torch.where(act, one / (wi1 + ex), r)
        else:
            r = one / ((wi + wi1) - lo * cp)
        cp = torch.where(act, -wi1 * r, cp)
        dpy = torch.where(act, (h2 - lo * dpy) * r, dpy)
        dpa = torch.where(act, ((wi if t == 0 else Z) - lo * dpa) * r, dpa)
        dpb = torch.where(t == ni - 1, wi1 * r, dpb)
        CP.append(cp)
        DPY.append(dpy)
        DPA.append(dpa)
    # back up the rows: each row's response to the unit load (Y), to the
    # left separator (A) and to the lane's own separator (Bt)
    Yn, An, Bn = Z, Z, Z
    RESP = [None] * CM
    for t in range(CM - 1, -1, -1):
        act = t < ni
        Yn = torch.where(act, DPY[t] - CP[t] * Yn, Yn)
        An = torch.where(act, DPA[t] - CP[t] * An, An)
        Bn = torch.where(act, torch.where(t == ni - 1, dpb, Z) - CP[t] * Bn,
                         Bn)
        RESP[t] = (Yn, An, Bn)
    has = ni > 0
    yF, aF, bF = (torch.where(has, Yn, Z), torch.where(has, An, Z),
                  torch.where(has, Bn, one))
    yL, aL, bL = (torch.where(has, dpy, Z), torch.where(has, dpa, one),
                  torch.where(has, dpb, Z))

    # the reduced system on the separators (the last row of each lane)
    wr, wr1 = w(e - 1), w(e)
    yFn, aFn, bFn = (torch.where(last_lane, Z, _shift(v, -1, 0.0))
                     for v in (yF, aF, bF))
    A = torch.where(active & (lane > 0), -(wr * aL), Z)
    Bd = torch.where(active, ((wr + wr1) - wr * bL) - wr1 * aFn, one)
    C = torch.where(active, -(wr1 * bFn), Z)
    R = torch.where(active, (h2 + wr * yL) + wr1 * yFn, Z)
    d = 1
    while d < L:                               # parallel cyclic reduction
        Am, Bm, Cm, Rm = (_shift(v, d, f) for v, f in
                          ((A, 0.0), (Bd, 1.0), (C, 0.0), (R, 0.0)))
        Ap, Bp, Cp, Rp = (_shift(v, -d, f) for v, f in
                          ((A, 0.0), (Bd, 1.0), (C, 0.0), (R, 0.0)))
        k1, k2 = A / Bm, C / Bp
        A, Bd, C, R = (-(k1 * Am), (Bd - k1 * Cm) - k2 * Ap, -(k2 * Cp),
                       (R - k1 * Rm) - k2 * Rp)
        d *= 2
    S = R / Bd
    Sprev = _shift(S, 1, 0.0)

    # each lane's rows in order: the QoI sums
    mid = n // 2 - 1
    s_int, eng, x_mid, x_prev = Z, Z, Z, Sprev
    for t in range(int(c.max())):
        act = t < c
        x = S
        if t < CM:
            Y, Al, Bl = RESP[t]
            x = torch.where(t < ni, (Y + Sprev * Al) + S * Bl, S)
        dd = x - x_prev
        s_int = torch.where(act, s_int + x, s_int)
        eng = torch.where(act, eng + (w(s + t) * dd) * dd, eng)
        x_mid = torch.where(act & (s + t == mid), x, x_mid)
        x_prev = torch.where(act, x, x_prev)
    dd = zero - x_prev                         # the last cell, to u(1) = 0
    eng = torch.where(last_lane, eng + (w(torch.full_like(s, m)) * dd) * dd,
                      eng)
    h_t = torch.tensor(h, dtype=dt, device=dev)
    n_t = torch.tensor(float(n), dtype=dt, device=dev)
    return torch.stack([h_t * _fold(s_int), _fold(x_mid),
                        n_t * _fold(eng)], dim=1)




def diffusion_outputs_plain(xis: torch.Tensor, n_cells: int,
                            sigma: float = 1.0,
                            nu: float = 1.5) -> torch.Tensor:
    """Plain PyTorch version of both tiers: :func:`solve_plain` of
    :func:`synthesize_plain`."""
    _check(xis, n_cells)
    n = int(n_cells)
    if n == 1 or xis.shape[0] == 0:
        return torch.zeros((xis.shape[0], 3), dtype=xis.dtype,
                           device=xis.device)
    return solve_plain(synthesize_plain(xis, n, sigma, nu), n)


@functools.lru_cache(maxsize=64)
def _mode_matrix_t(n_cells: int, n_kl: int, sigma: float, nu: float,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """mck transposed, (n_kl, n_cells): the kernel's coalesced layout."""
    return mode_matrix(n_cells, n_kl, sigma, nu, dtype, device).T.contiguous()


def diffusion_outputs(xis: torch.Tensor, n_cells: int, sigma: float = 1.0,
                      nu: float = 1.5) -> torch.Tensor:
    """(B, n_kl) masked xi -> (B, 3) QoIs.  CUDA tensors launch the kernel
    that :func:`tier` picks, or raise; CPU tensors run the plain version,
    which is that tier's (and the other's) arithmetic."""
    _check(xis, n_cells)
    if xis.device.type == "cpu":
        return diffusion_outputs_plain(xis, n_cells, sigma, nu)
    return launch(tier(int(n_cells), xis.shape[1], xis.dtype), xis, n_cells,
                  sigma, nu)


def launch(which: str, xis: torch.Tensor, n_cells: int, sigma: float = 1.0,
           nu: float = 1.5) -> torch.Tensor:
    """Launch one tier's kernel ("k1" or "wide") on CUDA xis, counted in
    ``diffusion_outputs.launches`` and ``launches_by_tier``.
    :func:`diffusion_outputs` passes the tier that :func:`tier` names;
    the wide tier takes every shape, K1 only those :func:`tier` gives it
    (else ``RuntimeError``), so both can be timed at a K1 shape."""
    _check(xis, n_cells)
    if xis.device.type != "cuda":
        raise ValueError("diffusion_outputs: unsupported device %s"
                         % xis.device)
    if which not in ("k1", "wide"):
        raise ValueError("diffusion_outputs: no tier %r" % (which,))
    n = int(n_cells)
    B, n_kl = xis.shape
    if B >= 2 ** 31:
        raise ValueError("diffusion_outputs: B=%d exceeds the kernel's int "
                         "batch index" % B)
    out = torch.empty((B, 3), dtype=xis.dtype, device=xis.device)
    if B == 0:
        return out
    lib = build_library()
    f32 = xis.dtype == torch.float32
    mckT = _mode_matrix_t(n, n_kl, float(sigma), float(nu), xis.dtype,
                          xis.device)
    h = 1.0 / n
    with torch.cuda.device(xis.device):
        stream = torch.cuda.current_stream().cuda_stream
        if which == "k1":
            fn = (lib.bluest_diffusion_outputs_f32 if f32
                  else lib.bluest_diffusion_outputs_f64)
            rc = fn(xis.data_ptr(), mckT.data_ptr(), out.data_ptr(), B, n_kl,
                    n, h * h, h, stream)
        else:
            elems = ctypes.c_longlong(0)
            plan = (lib.bluest_diffusion_wide_workspace_f32 if f32
                    else lib.bluest_diffusion_wide_workspace_f64)
            rc = plan(B, n, ctypes.byref(elems))
            if rc == 0:
                ws = torch.empty(elems.value, dtype=xis.dtype,
                                 device=xis.device)
                diffusion_outputs.workspace_bytes = (ws.numel()
                                                     * ws.element_size())
                fn = (lib.bluest_diffusion_wide_f32 if f32
                      else lib.bluest_diffusion_wide_f64)
                rc = fn(xis.data_ptr(), mckT.data_ptr(), out.data_ptr(),
                        ws.data_ptr() if ws.numel() else None, ws.numel(),
                        B, n_kl, n, h * h, h, stream)
    if rc == _NO_TILE:
        raise RuntimeError(
            "diffusion_outputs: the %s tier refused n_cells=%d, n_kl=%d "
            "(tier() names %r for it; where that is this tier, "
            "csrc/diffusion.cu and tier() disagree)"
            % (which, n, n_kl, tier(n, n_kl, xis.dtype)))
    if rc != 0:
        raise RuntimeError("diffusion kernel (%s tier) launch failed: CUDA "
                           "error %d (B=%d, n_kl=%d, n_cells=%d)"
                           % (which, rc, B, n_kl, n))
    diffusion_outputs.launches += 1
    diffusion_outputs.launches_by_tier[which] += 1
    return out


diffusion_outputs.launches = 0          # every launch, both tiers
diffusion_outputs.launches_by_tier = {"k1": 0, "wide": 0}
diffusion_outputs.workspace_bytes = 0   # the last wide launch's slab buffer


def synthesize(xis: torch.Tensor, n_cells: int, sigma: float = 1.0,
               nu: float = 1.5) -> torch.Tensor:
    """The wide tier's stage 1 alone: a (B, n) = exp(xis @ mck^T).  CUDA
    tensors launch it (FP64 tensor cores in f64, so the sum's order is
    the hardware's; f32 on CUDA cores, bit-equal to the plain version),
    counted in ``synthesize.launches``; CPU tensors run
    :func:`synthesize_plain`.  For holding each stage on its own."""
    _check(xis, n_cells)
    if xis.device.type == "cpu":
        return synthesize_plain(xis, n_cells, sigma, nu)
    n = int(n_cells)
    B, n_kl = xis.shape
    a = torch.empty((B, n), dtype=xis.dtype, device=xis.device)
    if B == 0:
        return a
    lib = build_library()
    mckT = _mode_matrix_t(n, n_kl, float(sigma), float(nu), xis.dtype,
                          xis.device)
    fn = (lib.bluest_diffusion_synth_f32 if xis.dtype == torch.float32
          else lib.bluest_diffusion_synth_f64)
    with torch.cuda.device(xis.device):
        rc = fn(xis.data_ptr(), mckT.data_ptr(), a.data_ptr(), B, n_kl, n,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("wide tier stage 1 launch failed: CUDA error %d "
                           "(B=%d, n_kl=%d, n_cells=%d)" % (rc, B, n_kl, n))
    synthesize.launches += 1
    return a


def solve(a: torch.Tensor, n_cells: int) -> torch.Tensor:
    """The wide tier's stage 2 alone: (B, n) a -> (B, 3) QoIs, bit-equal
    to :func:`solve_plain` in both dtypes.  CUDA tensors launch it,
    counted in ``solve.launches``; CPU tensors run :func:`solve_plain`."""
    n = int(n_cells)
    if (a.dim() != 2 or a.shape[1] != n or not a.is_contiguous()
            or a.dtype not in (torch.float32, torch.float64)):
        raise ValueError("a must be contiguous float32/float64 (B, %d), got "
                         "%s %s" % (n, a.dtype, tuple(a.shape)))
    if a.device.type == "cpu":
        return solve_plain(a, n)
    B = a.shape[0]
    out = torch.empty((B, 3), dtype=a.dtype, device=a.device)
    if B == 0:
        return out
    lib = build_library()
    store = torch.empty(B * lib.bluest_diffusion_wide_store(n),
                        dtype=a.dtype, device=a.device)
    fn = (lib.bluest_diffusion_solve_f32 if a.dtype == torch.float32
          else lib.bluest_diffusion_solve_f64)
    h = 1.0 / n
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), out.data_ptr(),
                store.data_ptr() if store.numel() else None, store.numel(),
                B, n, h * h, h, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("wide tier stage 2 launch failed: error %d "
                           "(B=%d, n_cells=%d)" % (rc, B, n))
    solve.launches += 1
    return out


synthesize.launches = 0
solve.launches = 0
