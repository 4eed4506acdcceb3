"""Numerical and device policy for bluest_tpu_torch.

The allocation optimization (cone solver, corner search, estimator
assembly) runs in float64 to reach the ~1e-8 agreement targets of the
reference; the Monte Carlo model evaluations run in the model's own dtype
and the sample sums always accumulate in float64.

A problem samples on the card (``device="cuda"``, the default of
``BLUEProblem``) unless the caller passes ``device="cpu"``, and it
allocates on the same device (:func:`allocation_device`, under
``allocation_device_scope(problem.device)``); nothing falls back from
one to the other.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading

import numpy as np
import torch

REAL = np.float64
INDEX = np.int32

# Threshold below which a correlation is treated as "uncorrelated"
# (reference: blue_models.py:344, blue_models.py:413).
UNCORRELATED_RHO_TOL = 1.0e-7

# Eigenvalue clip used when projecting covariances onto the SPD cone
# (reference: spg_default_params["spd_threshold"], blue_models.py:13).
SPD_THRESHOLD = 5.0e-14


def allocation_device(device=None) -> torch.device:
    """Device the allocation optimization runs on.

    The rule, read at each call:

    * ``BLUEST_TPU_ALLOC_DEVICE=cpu``: the host, whatever the scope or
      ``device`` (the caller asks for the CPU);
    * ``device`` (a ``torch.device`` or its name) when given: the device
      an allocation object (``MOSAP``, ``SAP``, ``solve_cone_lp``) was
      asked to run on;
    * inside :func:`allocation_device_scope`: the innermost scope's
      device (``BLUEProblem`` enters one with its own ``device`` around
      everything that allocates, so a problem allocates where it samples);
    * else the card, ``cuda``, as a ``BLUEProblem``'s default device.

    Nothing falls back: a card that the rule names and the process does
    not have raises ``RuntimeError``."""
    if os.environ.get("BLUEST_TPU_ALLOC_DEVICE", "") == "cpu":
        return torch.device("cpu")
    if device is None:
        device = _SCOPES.stack[-1] if _SCOPES.stack else "cuda"
    return _checked(torch.device(device))


def _checked(device: torch.device) -> torch.device:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "allocation device %s: no CUDA card is available; construct the "
            "problem with device=\"cpu\" or set BLUEST_TPU_ALLOC_DEVICE=cpu "
            "to allocate on the host CPU" % device)
    return device


class _ScopeStack(threading.local):
    def __init__(self):
        self.stack = []


_SCOPES = _ScopeStack()     # per thread: a scope never leaks across threads


# The JAX package probes, pins and compiles for its accelerator here; a
# CUDA card is local and eager torch compiles nothing, so
# ``ensure_responsive_device`` has nothing to do.

def ensure_responsive_device(timeout: float = 240.0, retries: int = 0,
                             fallback: str = "cpu"):
    """The JAX package probes a remote accelerator's backend here and
    moves the process to ``fallback`` when it hangs.  A CUDA card is
    local, and the port never replaces a missing card by the CPU
    (``sampling.engine.check_device`` raises at the first sampling call),
    so this returns None -- the healthy answer -- at once."""
    del timeout, retries, fallback
    return None


@contextlib.contextmanager
def allocation_device_scope(device=None):
    """Run the allocation inside on ``device`` (a ``torch.device`` or its
    name; None keeps the device :func:`allocation_device` gives now).
    Scopes nest, the innermost wins, and ``BLUEST_TPU_ALLOC_DEVICE=cpu``
    makes every scope the host's.  Entering a scope for a card the
    process does not have raises."""
    device = allocation_device(device)
    _SCOPES.stack.append(device)
    try:
        yield device
    finally:
        _SCOPES.stack.pop()


def on_allocation_device(fn):
    """Decorator form of :func:`allocation_device_scope`: each call of
    ``fn`` runs in a scope of its ``device`` keyword argument, or without
    one of the device :func:`allocation_device` gives when the call
    starts, so the whole call allocates on one device."""
    @functools.wraps(fn)
    def pinned(*args, **kwargs):
        with allocation_device_scope(kwargs.get("device")):
            return fn(*args, **kwargs)
    return pinned


def on_own_device(method):
    """Method form of :func:`allocation_device_scope`: each call runs in
    a scope of ``self.device``, so an object that owns a device (a
    ``BLUEProblem``, a ``MOSAP``) allocates there."""
    @functools.wraps(method)
    def scoped(self, *args, **kwargs):
        with allocation_device_scope(self.device):
            return method(self, *args, **kwargs)
    return scoped
