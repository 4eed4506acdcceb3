"""Shared sampling progress / ETA reporting (SURVEY 5.1).

Copy of ``bluest_tpu/progress.py`` (standard library only).

One rate/ETA computation for both progress surfaces: the host engine's
single-line in-place bar (reference UX: blue_fn.py:91-95) and the BLUE
solve loop's one-line-per-group stream (problem.py).
"""

from __future__ import annotations

import sys
from time import time
from typing import Optional, Tuple


def rate_eta(done: int, total: int, t0: float,
             now: Optional[float] = None) -> Tuple[float, float]:
    """(items/second, seconds remaining) since ``t0``."""
    elapsed = max((time() if now is None else now) - t0, 1e-9)
    rate = done / elapsed
    return rate, (total - done) / max(rate, 1e-9)


class Progress:
    """Single-line sampling progress (reference UX: blue_fn.py:91-95)."""

    def __init__(self, label: str, total: int, enabled: bool):
        self.label = label
        self.total = total
        self.enabled = enabled and total > 1
        self.t0 = time()
        self.last = 0.0

    def update(self, done: int, force: bool = False):
        if not self.enabled:
            return
        now = time()
        if not force and now - self.last < 1.0:
            return
        self.last = now
        rate, eta = rate_eta(done, self.total, self.t0, now)
        sys.stdout.write("\r  sampling %s: %d/%d (%.0f/s, ETA %.0fs)   "
                         % (self.label, done, self.total, rate, eta))
        if force:
            sys.stdout.write("\n")
        sys.stdout.flush()
