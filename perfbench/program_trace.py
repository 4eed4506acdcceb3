"""The program's own spans beside a ``torch.profiler`` trace of the card.

The port records spans and counters in memory while its recorder is on
(``bluest_tpu_torch.profiling``: ``enable_spans``, ``spans``,
``span_anchor``): each span a name, a request id (its root's id), its
parent, a start and an end on ``time.perf_counter_ns()``, and the
request's counters on its root.  :func:`requests` groups them by
request; :func:`summary` reduces the requests to the numbers a per-layer
metric reads.  :func:`busy_on_clock` puts the card's merged busy
intervals on the spans' clock through the recorder's anchor pair (the
profiler's items are ``trace_start_ns()`` plus their relative start,
Unix-epoch nanoseconds, :func:`device_items`), and :func:`idle_report`
charges each stretch of the card's idle time in the traced window to
the innermost span open across it.

The harness turns the recorder on in a traced run, from before set-up
until the profiler stops, and keeps :func:`program` of the recording as
``run["program"]``, which per-layer metrics read.  A traced run of a
cell with the card's idle time charged to the spans:

    python3 perfbench/program_trace.py --workload <cell> --seed <n> \
        --seconds <s>

prints the harness's result line with a ``"program"`` entry added:
:func:`program` and :func:`idle_report`.
"""

from __future__ import annotations

import bisect
import math
import os
import statistics
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from perfbench.trace import union  # noqa: E402

OUTSIDE = "(no span)"


def device_items(prof):
    """[(start, end)] of the card's items in a finished profile, in
    Unix-epoch nanoseconds."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    t0 = prof.profiler.kineto_results.trace_start_ns()
    return [(t0 + int(e.time_range.start * 1e3),
             t0 + int(e.time_range.end * 1e3))
            for e in prof.events() if e.device_type == cuda]


def busy_on_clock(items, anchor):
    """The merged intervals of Unix-epoch ``items`` on the spans' clock,
    through the recorder's (perf_counter_ns, Unix ns) ``anchor``."""
    perf0, unix0 = anchor
    return union([(a - unix0 + perf0, b - unix0 + perf0)
                  for a, b in items])[0]


def requests(spans):
    """The requests of a recording in the order they began: each its
    root's ``name``, ``id``, ``start_ns``, ``end_ns`` and ``counters``, and
    its ``spans`` in the order they began."""
    out = {}
    for s in sorted(spans, key=lambda s: (s.start_ns, s.id)):
        out.setdefault(s.request, []).append(s)
    reqs = []
    for group in out.values():
        root = next((s for s in group if s.parent is None), None)
        if root is not None:
            reqs.append({"id": root.id, "name": root.name,
                         "start_ns": root.start_ns, "end_ns": root.end_ns,
                         "counters": root.attrs.get("counters", {}),
                         "spans": group})
    return sorted(reqs, key=lambda r: r["start_ns"])


def _innermost(spans):
    """[(t0, t1, span or None)]: the stretches between the spans'
    boundaries, each with the innermost span open across it (the one
    opened last; spans of one thread nest)."""
    edges = []
    for s in spans:
        edges.append((s.start_ns, 1, s.id, s))
        edges.append((s.end_ns, 0, s.id, s))
    edges.sort(key=lambda e: e[:3])           # closes before opens
    out, stack, last = [], [], None
    for t, kind, _sid, s in edges:
        if last is not None and t > last:
            out.append((last, t, stack[-1] if stack else None))
        last = t
        if kind:
            stack.append(s)
        elif stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)
    return out


def charge_idle(spans, busy, lo, hi):
    """[(t0, t1, span or None)]: the idle stretches of [lo, hi] (the
    complement of the merged ``busy`` intervals), each cut at the spans'
    boundaries and charged to the innermost span open across it.  All
    times on one clock."""
    idle, t = [], lo
    for a, b in busy:
        if b <= t:
            continue
        if a >= hi:
            break
        if a > t:
            idle.append((t, a))
        t = b
    if t < hi:
        idle.append((t, hi))
    stretches = _innermost(spans)
    first = stretches[0][0] if stretches else hi
    last = stretches[-1][1] if stretches else hi
    stretches = [(lo, first, None)] + stretches + [(last, hi, None)]
    out, j = [], 0
    for a, b in idle:
        while a < b:
            s0, s1, s = stretches[j]
            if s1 <= a and j + 1 < len(stretches):
                j += 1
                continue
            c = min(b, s1) if j + 1 < len(stretches) else b
            out.append((a, c, s))
            a = c
    return [p for p in out if p[1] > p[0]]


def idle_report(spans, busy, window, top: int = 10) -> dict:
    """The card's idle time in the traced ``window`` (lo, hi), given its
    merged ``busy`` intervals, all on the spans' clock, charged to spans:
    ``idle_by_span`` (innermost span names and the idle ms they hold, top
    ``top``), ``own_idle`` (the idle ms in spans' own time, outside their
    children, by the child that closed before), ``idle_gaps`` (the
    longest idle stretches between device items, each with the span that
    holds most of it) and ``idle`` (the window's idle ns, the part inside
    ``solve`` requests and the part of that charged to leaf spans)."""
    lo, hi = window
    kids = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.end_ns, s.name))
    for v in kids.values():
        v.sort()
    root_name = {s.request: s.name for s in spans if s.parent is None}
    pieces = charge_idle(spans, busy, lo, hi)
    by_name, own, total, in_solve, leaf = {}, {}, 0, 0, 0
    for a, b, s in pieces:
        d = b - a
        total += d
        name = OUTSIDE if s is None else s.name
        by_name[name] = by_name.get(name, 0) + d
        if s is not None and root_name.get(s.request) == "solve":
            in_solve += d
            if s.id not in kids:
                leaf += d
        if s is not None and s.id in kids:
            # a span's own time: named by the child that closed last
            i = bisect.bisect_right(kids[s.id], (a, "\uffff"))
            where = "%s after %s" % (name, kids[s.id][i - 1][1]) if i \
                else "%s at its start" % name
            own[where] = own.get(where, 0) + d
    # the longest idle stretches between device items, and their holders
    gaps, cur = [], None
    for a, b, s in sorted(pieces, key=lambda p: p[0]):
        if cur is not None and a == cur["end"]:
            cur["end"] = b
        else:
            cur = {"start": a, "end": b, "by": {}}
            gaps.append(cur)
        name = OUTSIDE if s is None else s.name
        cur["by"][name] = cur["by"].get(name, 0) + (b - a)
    gaps.sort(key=lambda g: g["start"] - g["end"])
    return {
        "idle_by_span": [[k, v * 1e-6] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "own_idle": [[k, v * 1e-6] for k, v in sorted(
            own.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[(g["end"] - g["start"]) * 1e-6,
                       max(g["by"].items(), key=lambda kv: kv[1])[0]]
                      for g in gaps[:top]],
        "idle": {"window_ns": hi - lo, "idle_ns": total,
                 "in_solve_ns": in_solve, "leaf_ns": leaf}}


def window_requests(reqs, start_ns=None):
    """The ``solve`` requests of the window: those that began at or after
    ``start_ns``, or, without it, every one but the first (the harness's
    warm request)."""
    solves = [r for r in reqs if r["name"] == "solve"]
    if start_ns is None:
        return solves[1:]
    return [r for r in solves if r["start_ns"] >= start_ns]


def _ms(spans, name):
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) * 1e-6


def summary(reqs, start_ns=None) -> dict:
    """The per-layer numbers of the window's requests (None where there
    is nothing to read): ``estimator.host_ms`` (median of a request's
    ``estimate`` span), ``sample.host_syncs_per_estimate`` (``host.sync``
    spans a request), ``sample.sync_wait_ms`` (median of a request's
    summed ``host.sync`` spans), ``sample.draw_yield`` (rows kept over
    rows drawn, %), ``setup.alloc_s`` (the set-up's ``setup_solver``
    root spans, s)."""
    window = window_requests(reqs, start_ns)
    out = dict.fromkeys(("estimator.host_ms",
                         "sample.host_syncs_per_estimate",
                         "sample.sync_wait_ms", "sample.draw_yield",
                         "setup.alloc_s"))
    if not window:
        return out
    first = window[0]["start_ns"]
    setup = [r for r in reqs
             if r["name"] == "setup_solver" and r["start_ns"] < first]
    if setup:
        out["setup.alloc_s"] = sum(r["end_ns"] - r["start_ns"]
                                   for r in setup) * 1e-9
    est = [_ms(r["spans"], "estimate") for r in window
           if any(s.name == "estimate" for s in r["spans"])]
    if est:
        out["estimator.host_ms"] = statistics.median(est)
    out["sample.host_syncs_per_estimate"] = sum(
        sum(s.name == "host.sync" for s in r["spans"]) for r in window) \
        / len(window)
    out["sample.sync_wait_ms"] = statistics.median(
        _ms(r["spans"], "host.sync") for r in window)
    drawn = sum(r["counters"].get("rows.drawn", 0) for r in window)
    kept = sum(r["counters"].get("rows.kept", 0) for r in window)
    if drawn:
        out["sample.draw_yield"] = 100.0 * kept / drawn
    return out


def _add(table, name, count, seconds):
    c, t = table.get(name, (0, 0.0))
    table[name] = [c + count, t + seconds]


def program(spans) -> dict:
    """What a traced run keeps of the program's recording, by name, as
    ``run["program"]``: ``requests``, the number of the window's
    ``solve`` requests (:func:`window_requests`); ``summary``,
    :func:`summary` of them; ``spans``, their spans' [number, seconds]
    by name, and ``counters``, their counters, each summed over those
    requests; ``setup``, the [number, seconds] by name of the spans of
    the set-up's ``setup_solver`` requests (its root among them)."""
    reqs = requests(spans)
    window = window_requests(reqs)
    out = {"requests": len(window), "summary": summary(reqs), "spans": {},
           "counters": {}, "setup": {}}
    for r in window:
        for s in r["spans"]:
            _add(out["spans"], s.name, 1, (s.end_ns - s.start_ns) * 1e-9)
        for k, v in r["counters"].items():
            out["counters"][k] = out["counters"].get(k, 0) + v
    first = window[0]["start_ns"] if window else math.inf
    for r in reqs:
        if r["name"] == "setup_solver" and r["start_ns"] < first:
            for s in r["spans"]:
                _add(out["setup"], s.name, 1, (s.end_ns - s.start_ns) * 1e-9)
    return out


def traced_run(name: str, seed: int, seconds: float, device: str = "cuda",
               t_start=None, overrides=None) -> dict:
    """A traced run of the cell (the harness turns the program's recorder
    on): the harness's result with ``"program"``: :func:`program` of the
    recording and the idle attribution of :func:`idle_report`
    (``overrides`` as ``harness.run_cell`` takes them)."""
    from bluest_tpu_torch import profiling
    from perfbench import harness, trace

    seen = {}
    plain_read = trace.read

    def read_and_keep(prof, window_s, top=10):
        # the harness drops its profile after this call: keep the card's
        # items and the profile's start here
        seen["items"] = device_items(prof)
        seen["start"] = prof.profiler.kineto_results.trace_start_ns()
        seen["window_s"] = window_s
        return plain_read(prof, window_s, top)

    trace.read = read_and_keep
    try:
        result = harness.run_cell(name, seed, seconds, True, device=device,
                                  t_start=t_start, overrides=overrides)
    finally:
        trace.read = plain_read
    anchor = profiling.span_anchor()
    spans = profiling.spans()
    lo = seen["start"] - anchor[1] + anchor[0]
    idle = idle_report(spans, busy_on_clock(seen["items"], anchor),
                       (lo, lo + int(seen["window_s"] * 1e9)))
    result["program"] = dict(program(spans), **idle)
    return result


def main(argv=None):
    import argparse
    import json
    import time

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(
        description="a traced run of a cell with the program's spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    print(json.dumps(traced_run(args.workload, args.seed, args.seconds,
                                t_start=t_start)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
