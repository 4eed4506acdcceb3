"""Numerical and device policy for bluest_tpu_torch.

The allocation optimization (cone solver, corner search, estimator
assembly) runs in float64 to reach the ~1e-8 agreement targets of the
reference; the Monte Carlo model evaluations run in the model's own dtype
and the sample sums always accumulate in float64.

A problem samples on the card (``device="cuda"``, the default of
``BLUEProblem``) unless the caller passes ``device="cpu"``; nothing falls
back from one to the other.  The allocation runs on
:func:`allocation_device`.
"""

from __future__ import annotations

import contextlib

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


def allocation_device() -> torch.device:
    """Device the allocation optimization runs on.

    The MLBLUE allocation problems are tiny (a few hundred variables,
    PSD blocks of size M+1) and their interior-point iterations are a
    Python loop of small f64 factorizations, so they run on the host
    CPU, as in the JAX package.  Whether the card's hardware f64 beats
    the host here is an open measurement, not a decided one."""
    return torch.device("cpu")


# Names of the JAX package's device policy that callers' scripts use.  The
# port's allocation is eager f64 numpy/torch on the host, so nothing has
# to be pinned, probed or compiled: they are kept and do nothing.

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
def allocation_device_scope():
    """Context form of :func:`on_allocation_device`: a null context."""
    yield


def on_allocation_device(fn):
    """Decorator that pins a function's work to ``allocation_device()``
    in the JAX package; here the identity."""
    return fn
