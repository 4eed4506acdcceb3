"""``torch.profiler`` around the sampling of a solve.

``BLUEProblem(profile_dir=...)`` wraps the sampling phase of ``solve`` in
:func:`device_trace` (the JAX package's ``jax.profiler.trace`` hook) and
the on-card smoke run reads the device's busy share of a solve from the
same trace with :func:`device_busy`.
"""

from __future__ import annotations

import contextlib
import os
from time import time_ns
from typing import Optional

import torch


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None):
    """Profile the block on the host and, where there is a card, on the
    card; yields the ``torch.profiler.profile`` object.  With
    ``trace_dir`` the Chrome trace of the block is written there as
    ``solve_<pid>_<time>.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, "solve_%d_%d.json" % (os.getpid(), time_ns())))


def device_busy(prof, kernel_name: Optional[str] = None) -> dict:
    """Device activity of a finished trace, in microseconds: ``busy_us``
    (the union of all device items), ``by_name`` (summed per item name)
    and, for the items whose name holds ``kernel_name``, ``kernel_us`` and
    ``kernel_n``."""
    spans, by_name, k_us, k_n = [], {}, 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0)
        if kernel_name is not None and kernel_name in e.name:
            k_us += t1 - t0
            k_n += 1
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"busy_us": busy, "by_name": by_name, "kernel_us": k_us,
            "kernel_n": k_n}
