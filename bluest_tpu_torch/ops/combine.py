"""K6: the sampling combiner's masked float64 MLBLUE sums of a chunk, its
plan and its loader.

``combine_sums(outs, base, N, into)`` folds the chunk ``outs`` --
(k, rows, No[, d]) model-major outputs, float32 or float64, any strides,
on a CUDA card -- into the sums ``(se, sc, d1, d2, n_failed)`` of
``sampling.engine.combine_plain``: new tensors, or added in place into
``into`` (the call's running sums).  It is the port's counterpart of the
JAX package's combiner (``bluest_tpu/sampling/kernel_engine.py:293``,
``_get_combiners``' einsums).

* One launch of the hand-written kernel of
  ``bluest_tpu_torch/csrc/combine.cu`` a call, built with nvcc at first
  use into ``build/bluest_tpu_torch/`` and loaded through ctypes, by the
  plan :func:`plan` makes from the shape alone; each launch is counted
  in ``combine_sums.launches``.  Nothing falls back: a build or launch
  failure raises.
* Its scratch (the blocks' partial sums and the ticket that elects the
  block which adds them) is kept per device and stream and grows with
  the entries; no call allocates it anew.
* The plain version, for CPU tensors and the tests, is
  ``sampling.engine.combine_plain``; ``tests/test_torch_combine.py``
  mirrors the kernel's order of summation on the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from . import _build

__all__ = ["combine_sums", "plan", "Plan", "per_output", "build_library",
           "NE", "THREADS", "MAX_BLOCKS", "TILE_BYTES", "MAX_PITCH"]

THREADS = 256            # a block (csrc: K6_THREADS)
MAX_BLOCKS = 264         # blocks at most (csrc: K6_MAX_BLOCKS)
NE = 8                   # running sums a thread holds (csrc: K6_NE)
TILE_BYTES = 32768       # the staged rows of a block, float64
MAX_PITCH = 4095         # a row's values at most (csrc: K6_MAX_PITCH)

_SOURCE = os.path.join(_build.CSRC_DIR, "combine.cu")
# the base flags alone: the source rounds every operation on its own
NVCC_FLAGS = list(_build.BASE_FLAGS)

_lib = None
_lib_lock = threading.Lock()
build_log = ""          # nvcc's output (register / spill report) of the build


def build_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the K6 shared library."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _build.build(_SOURCE, NVCC_FLAGS)
        build_log = _build.build_logs.get(path, "")
        lib = ctypes.CDLL(path)
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bluest_combine_sums.restype = I
        lib.bluest_combine_sums.argtypes = [P, I, P, P, LL, LL, P, P, I, P,
                                            P, P, P]
        for name, want in (("bluest_combine_max_blocks", MAX_BLOCKS),
                           ("bluest_combine_threads", THREADS),
                           ("bluest_combine_ne", NE)):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = I, []
            if fn() != want:
                raise RuntimeError("csrc/combine.cu: %s() is %d, "
                                   "ops.combine says %d"
                                   % (name, fn(), want))
        _lib = lib
        return _lib


def per_output(k: int, d: int) -> int:
    """The sums one output of a row feeds: se (k d), sc (i <= j), d1
    (i < j, d each) and d2 (i < j)."""
    return k * d + k * (k + 1) // 2 + k * (k - 1) // 2 * (d + 1)


class Plan(NamedTuple):
    """A launch, from the shape alone (csrc/combine.cu, Layout)."""
    width: int           # a row's values, No k d
    pitch: int           # its stride in the tile (odd)
    per_output: int
    entries: int         # No per_output
    slots: int           # S: a power of two, entries a pass over NE
    rows: int            # R: rows a tile
    blocks: int
    passes: int
    region: int          # doubles of the tile (and of the lanes' sums)
    shared_bytes: int


def plan(k: int, rows: int, No: int, d: int) -> Plan:
    """The launch for a chunk of ``rows`` rows of k models, No outputs of
    dimension d: the (slot, lane) split, the tile, and the grid, which
    fix the order of every sum."""
    k, rows, No, d = int(k), int(rows), int(No), int(d)
    if min(k, No, d) < 1 or not 0 <= rows < 2 ** 31:
        raise ValueError("combine: k, No, d >= 1 and 0 <= rows < 2**31, "
                         "got %s" % ((k, rows, No, d),))
    width = No * k * d
    pitch = width | 1
    if pitch > MAX_PITCH:
        raise ValueError("combine: a row of No k d = %d values is wider "
                         "than K6's tile takes (%d)" % (width, MAX_PITCH))
    p = per_output(k, d)
    entries = No * p
    slots = 1
    while slots < THREADS and slots * NE < entries:
        slots *= 2
    passes = -(-entries // (slots * NE))
    tile_rows = min(THREADS, TILE_BYTES // (8 * pitch))
    blocks = max(1, min(MAX_BLOCKS, -(-rows // tile_rows)))
    lanes = THREADS // slots
    region = max(tile_rows * pitch, slots * (lanes // min(lanes, 32)) * NE)
    shared = 8 * region + 4 * slots * NE + 4 * tile_rows
    return Plan(width, pitch, p, entries, slots, tile_rows, blocks, passes,
                region, shared)


def _flat(strides: Sequence[int], k: int, No: int, d: int) -> bool:
    """Whether value (n, i, c) of a row lies at (n k + i) d + c from the
    row's start (the group engine's blocks; the factored engine's at k =
    1)."""
    s_model, _, s_out, s_comp = strides
    return ((d == 1 or s_comp == 1) and (k == 1 or s_model == d)
            and (No == 1 or s_out == k * d))


@functools.lru_cache(maxsize=256)
def _launch_args(shape, strides):
    """The plan of a chunk of this shape (k, rows, No[, d]) and these
    strides, its (k, rows, No, d), and the C entry point's shape, strides
    and plan arrays: made once a shape, since a chunk's launch is on the
    sampling loop's path."""
    if len(shape) not in (3, 4):
        raise ValueError("combine_sums: outs must be (k, rows, No[, d]), "
                         "got %s" % (tuple(shape),))
    shape, strides = tuple(shape) + (1,) * (4 - len(shape)), \
        tuple(strides) + (1,) * (4 - len(strides))
    k, rows, No, d = shape
    pl = plan(k, rows, No, d)
    ints = (ctypes.c_int * 11)(
        pl.width, pl.pitch, pl.per_output, pl.entries, pl.slots, pl.rows,
        pl.blocks, pl.passes, pl.region, int(_flat(strides, k, No, d)),
        pl.shared_bytes)
    return (pl, shape, (ctypes.c_int * 4)(*shape),
            (ctypes.c_longlong * 4)(*strides), ints)


_scratch = {}           # (device index, stream) -> (part, nf_part, ticket)
_scratch_lock = threading.Lock()


def _scratch_for(device: torch.device, stream: int, doubles: int):
    """The scratch of one device and stream, grown to ``doubles``."""
    key = (device.index, stream)
    have = _scratch.get(key)
    if have is not None and have[0].numel() >= doubles:
        return have
    with _scratch_lock:
        have = _scratch.get(key)
        if have is None or have[0].numel() < doubles:
            ticket = (have[2] if have is not None else
                      torch.zeros(1, dtype=torch.int32, device=device))
            have = (torch.empty(doubles, dtype=torch.float64, device=device),
                    torch.empty(MAX_BLOCKS, dtype=torch.int64, device=device),
                    ticket)
            _scratch[key] = have
        return have


def _sums_like(k, No, d, device):
    e = lambda *s: torch.empty(s, dtype=torch.float64, device=device)
    return (e(No, k, d), e(No, k, k), e(No, k, k, d), e(No, k, k),
            torch.empty((), dtype=torch.int64, device=device))


def _check_into(into, k, No, d, device):
    """Running sums K6 adds into: contiguous float64 se, sc, d1, d2 and
    an int64 count of this group's shapes, on the chunk's device."""
    shapes = ((No, k, d), (No, k, k), (No, k, k, d), (No, k, k), ())
    for q, (t, shape) in enumerate(zip(into, shapes)):
        dtype = torch.int64 if q == 4 else torch.float64
        if (t.device != device or t.dtype != dtype or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError("combine: the running sums must be contiguous "
                             "%s %s on %s, got %s %s on %s"
                             % (dtype, shape, device, t.dtype,
                                tuple(t.shape), t.device))


def combine_sums(outs: torch.Tensor, base: int, N: int,
                 into: Optional[Sequence[torch.Tensor]] = None):
    """The masked float64 sums of the chunk ``outs`` (k, rows, No) or (k,
    rows, No, d) on a CUDA card, whose first row has global sample index
    ``base``, of a call of N samples: ``(se (No, k, d), sc (No, k, k), d1
    (No, k, k, d), d2 (No, k, k), n_failed ())``, float64 and an int64
    count.  One K6 launch, or raise.  Without ``into`` they are new
    tensors; with it they are added into ``into`` itself, which is
    returned: running sums of the same k, No and d that the caller owns."""
    if not isinstance(outs, torch.Tensor) or outs.device.type != "cuda":
        raise ValueError("combine_sums: K6 takes a CUDA tensor")
    if outs.dtype not in (torch.float32, torch.float64):
        outs = outs.to(torch.float64)
    pl, (k, rows, No, d), c_shape, c_strides, c_plan = _launch_args(
        outs.shape, outs.stride())
    device = outs.device
    if into is None:
        sums = _sums_like(k, No, d, device)
    else:
        _check_into(into, k, No, d, device)
        sums = into
    ptrs = (ctypes.c_void_p * 5)(*[t.data_ptr() for t in sums])
    lib = _lib or build_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    part, nf_part, ticket = _scratch_for(device, stream,
                                         MAX_BLOCKS * pl.entries)
    with (torch.cuda.device(device)
          if device.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        rc = lib.bluest_combine_sums(
            outs.data_ptr(), outs.element_size(), c_strides, c_shape,
            int(base), int(N), c_plan, ptrs, int(into is not None),
            part.data_ptr(), nf_part.data_ptr(), ticket.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("combine_sums: K6 launch failed: CUDA error %d "
                           "(k=%d, rows=%d, No=%d, d=%d)"
                           % (rc, k, rows, No, d))
    combine_sums.launches += 1
    return sums


combine_sums.launches = 0
