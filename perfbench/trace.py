"""Reading a ``torch.profiler`` trace of the card's activity over the
traced part of the window.

Every device item (kernel, copy, memset) is an event on the CUDA side of
the trace; the host's ops are not recorded.  :func:`union` is the busy
arithmetic of ``bluest_tpu_torch/profiling.py``'s ``device_busy``
(copied: the benchmark reads nothing of the program but its trace).
"""

from __future__ import annotations

import re


def union(intervals):
    """Sorted, merged intervals and their total length."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged, sum(b - a for a, b in merged)


def short(name: str) -> str:
    """A kernel's name without its templates, arguments and return type;
    copies and memsets as they are named."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)", "{anonymous}")
    for pattern in (r"<[^<>]*>", r"\([^()]*\)"):     # innermost first
        while True:
            stripped = re.sub(pattern, "", name)
            if stripped == name:
                break
            name = stripped
    name = name.strip()
    return name.split()[-1] if name else name


def read(prof, window_s: float, top: int = 10) -> dict:
    """The trace's device busy time, item count and breakdown, in
    seconds: the device items that took most time, and the longest idle
    gaps between items, each named by the items on either side."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    items = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == cuda)
    merged, busy = union([(a, b) for a, b, _ in items])
    by_name = {}
    for a, b, name in items:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    # the item that ends last before each gap, and the first after it
    gaps, last_end, last_name = [], None, None
    for a, b, name in items:
        if last_end is not None and a > last_end:
            gaps.append((a - last_end, "%s -> %s" % (short(last_name),
                                                     short(name))))
        if last_end is None or b >= last_end:
            last_end, last_name = b, name
    gaps.sort(key=lambda g: -g[0])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy * 1e-6, "items": len(items), "window_s": window_s,
            "breakdown": {"device_ops": [[k, v] for k, v in ops],
                          "idle_gaps": [[label, g * 1e-6]
                                        for g, label in gaps[:top]]}}


def traced_requests(run, kind: str) -> int:
    """The number of the run's requests that ran under the profiler (0
    without a trace or in a cell of another kind)."""
    if run.get("trace") is None or run["cell"]["kind"] != kind:
        return 0
    return sum(r["traced"] for r in run["requests"])

