"""K2: the Hodgkin-Huxley family's time stepping and outputs, its plain
PyTorch version and its loader.

``hh_group_outputs(models, params)`` integrates every model of a group --
``models`` a sequence of ``(kind, dt)``, kind 0 = HH RK4, 1 = HH Euler,
2 = FitzHugh-Nagumo RK4 -- from the ``(n, 3)`` float64 parameters
(applied current, gNa, gK) to ``T_END`` and returns their five outputs,
``(n, 5, L)``: mean V, final V, max V, mean sigmoid(V / 2) and mean
n-gate over the states after each step.  It is the port's counterpart of
the JAX package's ``lax.scan`` (``bluest_tpu/models/hodgkin_huxley.py``,
``_integrate`` and ``_outputs``, under ``vmap`` of ``evaluate_jax``).

* A CUDA tensor launches the hand-written kernel of
  ``bluest_tpu_torch/csrc/hodgkin_huxley.cu``, built with nvcc at first
  use into ``build/bluest_tpu_torch/`` and loaded through ctypes: one
  launch for up to ``MAX_MODELS`` models, whatever their kinds and step
  counts, in the variant (lanes a sample) that :func:`launch_plan` picks
  from n, the models and the card's SM count; each launch is counted in
  ``hh_group_outputs.launches`` and by variant in
  ``hh_group_outputs.launches_by_variant``.  Nothing falls back: a build
  or launch failure raises.
* A CPU tensor runs :func:`hh_group_outputs_plain`: per model a Python
  loop of elementwise PyTorch operations over the batch, in the order of
  the JAX package's expressions (its integer powers written out as the
  products ``integer_pow`` takes), with the five outputs kept as running
  reductions updated step by step in the kernel's order (no trajectory
  is stored).  Every variant of the kernel repeats these operations one
  by one, as eager PyTorch computes them on the card; ``chip_smoke.py``
  holds each against the plain version there.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import threading
from typing import NamedTuple

import torch

from . import _build

__all__ = ["hh_group_outputs", "hh_group_outputs_plain", "launch_plan",
           "Launch", "fill", "variant_for", "n_steps", "build_library",
           "T_END", "N_OUTPUTS", "MAX_MODELS", "STEP_OPS", "VARIANTS",
           "LANES8_MAX_FILL"]

T_END = 10.0
N_OUTPUTS = 5
MAX_MODELS = 32          # models in one launch's table (csrc: HH_MAX_MODELS)
# operations of one step by kind, as chip_smoke.py counts K2's work (each
# add, subtract, multiply, divide, exp and compare one; see the source's
# note): the cost that orders a launch's models
STEP_OPS = {0: 288, 1: 73, 2: 79}
# the kernel's variants: lanes of a warp a (sample, model)
VARIANTS = {"thread": 1, "lanes8": 8}
H100_SMS = 132           # launch_plan's card when none is named


_SOURCE = os.path.join(_build.CSRC_DIR, "hodgkin_huxley.cu")
# the base flags alone: the source keeps its arithmetic from contracting
NVCC_FLAGS = list(_build.BASE_FLAGS)

_lib = None
_lib_lock = threading.Lock()
build_log = ""          # nvcc's output (register / spill report) of the build


def build_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the K2 shared library."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _build.build(_SOURCE, NVCC_FLAGS)
        build_log = _build.build_logs.get(path, "")
        lib = ctypes.CDLL(path)
        lib.bluest_hh_outputs_f64.restype = ctypes.c_int
        lib.bluest_hh_outputs_f64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p]
        lib.bluest_hh_max_models.restype = ctypes.c_int
        lib.bluest_hh_max_models.argtypes = []
        if lib.bluest_hh_max_models() != MAX_MODELS:
            raise RuntimeError("csrc/hodgkin_huxley.cu takes %d models a "
                               "launch, ops.hodgkin_huxley.MAX_MODELS says %d"
                               % (lib.bluest_hh_max_models(), MAX_MODELS))
        _lib = lib
        return _lib


def n_steps(dt: float) -> int:
    """Steps of size dt to T_END, as the JAX package rounds them."""
    return int(round(T_END / dt))


def _models(models):
    """``models`` as a tuple of (int kind, float dt), checked."""
    out = []
    for kind, dt in models:
        kind, dt = int(kind), float(dt)
        if kind not in (0, 1, 2):
            raise ValueError("model kind must be 0 (HH RK4), 1 (HH Euler) "
                             "or 2 (FitzHugh-Nagumo RK4), got %r" % (kind,))
        if not (math.isfinite(dt) and dt > 0 and n_steps(dt) >= 1):
            raise ValueError("dt must be positive with at least one step "
                             "to T_END=%g, got %r" % (T_END, dt))
        out.append((kind, dt))
    if not out:
        raise ValueError("models must name at least one (kind, dt)")
    return tuple(out)


class Launch(NamedTuple):
    """One launch: its variant (a key of :data:`VARIANTS`) and its table of
    entries ``(col, kind, n_steps, dt)``, longest model first."""
    variant: str
    entries: tuple


def launch_plan(models, n, sm_count=H100_SMS):
    """The launches of a group at n samples on a card of ``sm_count`` SMs:
    tables of at most MAX_MODELS entries, every column once, the longest
    models (steps times :data:`STEP_OPS`) first, ties in column order,
    each with the variant :func:`variant_for` picks for it."""
    n, sm_count = int(n), int(sm_count)
    if n < 0 or sm_count < 1:
        raise ValueError("launch_plan: n >= 0 and sm_count >= 1, got %d, %d"
                         % (n, sm_count))
    return tuple(Launch(variant_for(t, n, sm_count), t)
                 for t in _plan(_models(models)))


@functools.lru_cache(maxsize=64)
def _plan(models):
    cols = sorted(range(len(models)), key=lambda c: -n_steps(models[c][1])
                  * STEP_OPS[models[c][0]])
    entries = [(c, models[c][0], n_steps(models[c][1]), models[c][1])
               for c in cols]
    return tuple(tuple(entries[i:i + MAX_MODELS])
                 for i in range(0, len(entries), MAX_MODELS))


def fill(entries, n, sm_count=H100_SMS):
    """How full a one-lane launch of ``entries`` at n samples keeps the
    card while its longest model runs: its warps per SM sub-partition (4
    an SM), each entry's weighted by its cost over the longest's."""
    cost = [steps * STEP_OPS[kind] for _, kind, steps, _ in entries]
    return -(-n // 32) * sum(cost) / max(cost) / (4 * sm_count)


# the largest fill at which a launch takes eight lanes a sample: on an
# H100 (132 SMs) "lanes8" was the faster variant at a fill of 0.606 for
# model 0 alone and 0.694 for the 12-model group, "thread" at 0.727 and
# 1.042 (chip_smoke.py's K2 sweep)
LANES8_MAX_FILL = 0.7


def variant_for(entries, n, sm_count=H100_SMS):
    """The variant for one launch table at n samples: "lanes8" while the
    launch leaves the card emptier than :data:`LANES8_MAX_FILL` (one
    sample's dependent chain then sets the time), else "thread"."""
    return ("lanes8" if fill(entries, n, sm_count) <= LANES8_MAX_FILL
            else "thread")


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(params):
    if not isinstance(params, torch.Tensor):
        raise TypeError("params must be a torch.Tensor")
    if params.dtype != torch.float64:
        raise TypeError("params must be float64, got %s" % params.dtype)
    if params.dim() != 2 or params.shape[1] != 3:
        raise ValueError("params must be (n, 3): applied current, gNa, gK; "
                         "got %s" % (tuple(params.shape),))
    if not params.is_contiguous():
        raise ValueError("params must be contiguous")


def _cube(x):
    """x ** 3 as the JAX package's ``integer_pow`` takes it: x * (x * x),
    which is x * x * x."""
    return x * x * x


def _pow4(x):
    """x ** 4 as the JAX package's ``integer_pow`` takes it: (x*x)*(x*x)."""
    x2 = x * x
    return x2 * x2


def _hh_rhs(V, m, h, n, I_app, gNa, gK):
    gL, ENa, EK, EL, Cm = 0.3, 50.0, -77.0, -54.387, 1.0

    a_m = 0.1 * (V + 40.0) / (1.0 - torch.exp(-(V + 40.0) / 10.0) + 1e-12)
    b_m = 4.0 * torch.exp(-(V + 65.0) / 18.0)
    a_h = 0.07 * torch.exp(-(V + 65.0) / 20.0)
    b_h = 1.0 / (1.0 + torch.exp(-(V + 35.0) / 10.0))
    a_n = 0.01 * (V + 55.0) / (1.0 - torch.exp(-(V + 55.0) / 10.0) + 1e-12)
    b_n = 0.125 * torch.exp(-(V + 65.0) / 80.0)

    INa = gNa * _cube(m) * h * (V - ENa)
    IK = gK * _pow4(n) * (V - EK)
    IL = gL * (V - EL)
    dV = (I_app - INa - IK - IL) / Cm
    dm = a_m * (1 - m) - b_m * m
    dh = a_h * (1 - h) - b_h * h
    dn = a_n * (1 - n) - b_n * n
    return dV, dm, dh, dn


def _fhn_rhs(v, w, I_app):
    a, b, tau = 0.7, 0.8, 12.5
    dv = v - _cube(v) / 3 - w + I_app / 10.0
    dw = (v + a - b * w) / tau
    return dv, dw


def _model_plain(kind, dt, params):
    """One model's (n, 5) outputs: the kernel's integration and running
    reductions, one elementwise operation at a time on the stacked state
    (n, 4), or (n, 2) for FitzHugh-Nagumo, whose last two states stay 0."""
    steps = n_steps(dt)
    I_app, gNa, gK = params.unbind(1)
    if kind == 2:
        state0 = (-1.0, 1.0)
        rhs = lambda s: torch.stack(_fhn_rhs(s[:, 0], s[:, 1], I_app), dim=1)
    else:
        state0 = (-65.0, 0.0529, 0.5961, 0.3177)
        rhs = lambda s: torch.stack(_hh_rhs(*s.unbind(1), I_app, gNa, gK),
                                    dim=1)
    s = torch.tensor(state0, dtype=params.dtype,
                     device=params.device).expand(params.shape[0], -1)
    sum_v = sum_sig = sum_n = params.new_zeros(params.shape[0])
    v_max = torch.full_like(sum_v, -math.inf)
    for _ in range(steps):
        if kind == 1:
            s = s + dt * rhs(s)
        else:
            k1 = rhs(s)
            k2 = rhs(s + 0.5 * dt * k1)
            k3 = rhs(s + 0.5 * dt * k2)
            k4 = rhs(s + dt * k3)
            s = s + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        if kind == 2:
            # rescale FHN to HH-like voltage units so outputs correlate
            v = -65.0 + 40.0 * (s[:, 0] + 1.0)
            n_gate = 0.3177 + 0.1 * s[:, 1]
        else:
            v, n_gate = s[:, 0], s[:, 3]
        sum_v = sum_v + v
        v_max = torch.maximum(v_max, v)            # NaN propagates
        sum_sig = sum_sig + torch.sigmoid((v - 0.0) / 2.0)
        sum_n = sum_n + n_gate
    return torch.stack([sum_v / steps, v, v_max, sum_sig / steps,
                        sum_n / steps], dim=1)


def hh_group_outputs_plain(models, params: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 on any device: (n, 5, L) float64."""
    models = _models(models)
    _check(params)
    return torch.stack([_model_plain(kind, dt, params)
                        for kind, dt in models], dim=2)


def _table_args(entries):
    """A launch table as the C entry point takes it: (kind, n_steps, col)
    and (dt, 0.5*dt, dt/6.0, 1.0/n_steps) per entry, as ctypes arrays."""
    ints = (ctypes.c_int * (3 * len(entries)))(
        *[v for col, kind, steps, _ in entries for v in (kind, steps, col)])
    reals = (ctypes.c_double * (4 * len(entries)))(
        *[v for _, _, steps, dt in entries
          for v in (dt, 0.5 * dt, dt / 6.0, 1.0 / steps)])
    return ints, reals


def _launch(lib, params, out, entries, variant, stream):
    """One launch of K2's ``variant`` on ``entries``; raises on failure."""
    n, L = params.shape[0], out.shape[2]
    rc = lib.bluest_hh_outputs_f64(params.data_ptr(), out.data_ptr(), n, L,
                                   len(entries), *_table_args(entries),
                                   VARIANTS[variant], stream)
    if rc != 0:
        raise RuntimeError("hh_group_outputs: K2 launch (%s) failed: CUDA "
                           "error %d (n=%d, L=%d)" % (variant, rc, n, L))


def hh_group_outputs(models, params: torch.Tensor, *,
                     variant=None) -> torch.Tensor:
    """(n, 3) float64 parameters -> (n, 5, L) outputs of the L models
    ``models``.  CUDA tensors launch K2 (once per MAX_MODELS models, in the
    variant :func:`launch_plan` picks) or raise; CPU tensors run
    :func:`hh_group_outputs_plain`.  ``variant`` (tests only) forces one of
    :data:`VARIANTS` on every launch."""
    models = _models(models)
    _check(params)
    if variant is not None and variant not in VARIANTS:
        raise ValueError("hh_group_outputs: variant must be one of %s, got %r"
                         % (sorted(VARIANTS), variant))
    if params.device.type == "cpu":
        return hh_group_outputs_plain(models, params)
    if params.device.type != "cuda":
        raise ValueError("hh_group_outputs: unsupported device %s"
                         % params.device)
    n, L = params.shape[0], len(models)
    if n * N_OUTPUTS * L >= 2 ** 31 or n * 8 + 64 >= 2 ** 31:
        raise ValueError("hh_group_outputs: n * 5 * L = %d or n * 8 lanes "
                         "exceeds the kernel's int index"
                         % (n * N_OUTPUTS * L))
    out = torch.empty((n, N_OUTPUTS, L), dtype=torch.float64,
                      device=params.device)
    if n == 0:
        return out
    lib = build_library()
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in launch_plan(models, n, _sm_count(params.device.index)):
            v = variant or launch.variant
            _launch(lib, params, out, launch.entries, v, stream)
            hh_group_outputs.launches += 1
            hh_group_outputs.launches_by_variant[v] += 1
    return out


hh_group_outputs.launches = 0
hh_group_outputs.launches_by_variant = dict.fromkeys(VARIANTS, 0)
