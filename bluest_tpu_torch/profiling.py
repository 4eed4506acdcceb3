"""The port's tracing: ``torch.profiler`` around a solve, and an in-memory
recorder of the program's own spans and counters.

``BLUEProblem(profile_dir=...)`` wraps the sampling and the estimate of
``solve`` in :func:`device_trace` (the JAX package's
``jax.profiler.trace`` hook) and records the solve's spans into the same
Chrome trace file.

The recorder is off until :func:`enable_spans`.  The program opens a span
at each layer boundary of ``solve`` and ``setup_solver``, written

    with profiling.span("sample.chunk", chunk=c, rows=n) as sp:

and this module alone decides whether it records: with the recorder off
:func:`span` and :func:`host_sync` return the shared no-op context
:data:`OFF` (``sp`` is then None) and :func:`count` returns at once, so a
site costs one Python call and touches no tensor.  A site's attributes
are host values (shapes, lengths); one that needs the device is set in
``sp.attrs`` behind ``if sp is not None``.  With the recorder on, a span
appends one :class:`Span` to a list in memory when it closes.  The
recorder never launches device work, records a CUDA event or
synchronises, so the card runs the same items with it on or off.

A span with no open span above it (in its thread) is a request's root:
its id is the request id of every span opened inside it, and its
``attrs["counters"]`` holds the request's counters (:func:`count`,
:func:`host_sync`, and the kernels' launches across the root:
``k2.launches``, the change of
``ops.hodgkin_huxley.hh_group_outputs.launches``, and ``k6.launches``, of
``ops.combine.combine_sums.launches``).
Times are ``time.perf_counter_ns()``; :func:`unix_ns` moves one onto the
clock of ``torch.profiler``'s events (Unix-epoch nanoseconds: the
profiler's ``kineto_results.trace_start_ns()`` plus an event's relative
start) through the anchor pair that :func:`enable_spans` takes.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import sys
import threading
from time import perf_counter_ns, time_ns
from typing import List, NamedTuple, Optional, Tuple

import torch

recording = False               # whether span(), host_sync() and count() record
OFF = contextlib.nullcontext()  # what a site enters with the recorder off

# the Chrome trace track of the program's spans (pid: the process)
SPAN_TRACK = 0


class Span(NamedTuple):
    name: str
    request: int            # id of the request's root span
    id: int
    parent: Optional[int]   # None for a root
    start_ns: int           # time.perf_counter_ns()
    end_ns: int
    attrs: dict             # a root's also holds "counters"


_ids = itertools.count(1)       # next() is atomic: threads may record
_done: list = []                # closed spans, as tuples of Span fields
_local = threading.local()      # each thread's stack of open spans
_anchor = (0, 0)                # (perf_counter_ns, Unix ns) at one instant


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


# a request's launch counters: (counter, the kernel's module, its wrapper)
_KERNELS = (("k2.launches", "bluest_tpu_torch.ops.hodgkin_huxley",
             "hh_group_outputs"),
            ("k6.launches", "bluest_tpu_torch.ops.combine", "combine_sums"))


def _launches() -> Tuple[int, ...]:
    """The kernels' launch counters, in :data:`_KERNELS`' order; 0 for a
    kernel whose module is not loaded (then it has not launched)."""
    out = []
    for _, module, wrapper in _KERNELS:
        mod = sys.modules.get(module)
        out.append(0 if mod is None else getattr(mod, wrapper).launches)
    return tuple(out)


def _clock_pair() -> Tuple[int, int]:
    """(perf_counter_ns, time_ns) read at one instant: the midpoint of the
    tightest of a few bracketing reads."""
    best = None
    for _ in range(5):
        a = perf_counter_ns()
        u = time_ns()
        b = perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


def enable_spans() -> None:
    """Start a recording: forget the spans recorded so far, take the clock
    anchor, and record every span opened from now on."""
    global recording, _anchor
    _done.clear()
    _anchor = _clock_pair()
    recording = True


def disable_spans() -> None:
    """Stop recording.  Spans already open still record when they close;
    :func:`spans` keeps the recording until the next :func:`enable_spans`."""
    global recording
    recording = False


def spans() -> List[Span]:
    """The closed spans of the current (or last) recording, in the order
    they closed."""
    return [Span._make(t) for t in _done]


def span_anchor() -> Tuple[int, int]:
    """The recording's (perf_counter_ns, Unix ns) pair of one instant."""
    return _anchor


def unix_ns(t_ns: int) -> int:
    """A span time on the clock of ``torch.profiler``'s events."""
    return t_ns - _anchor[0] + _anchor[1]


def span(name: str, **attrs):
    """``with span(name, **attrs) as s``: one span of the program; ``s``
    is the open span (``s.attrs`` may take attributes known only at its
    end), or :data:`OFF`'s None while the recorder is off."""
    if not recording:
        return OFF
    return _Span(name, attrs)


def host_sync(site: str):
    """``span("host.sync", site=site)`` around one blocking device-to-host
    read, counted on the request as ``host.sync.<site>``; :data:`OFF`
    while the recorder is off."""
    if not recording:
        return OFF
    return _HostSync("host.sync", {"site": site})


class _Span:
    """An open span of :func:`span`: it records itself when it closes."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns",
                 "launches")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.root = top.id, top.root
        else:
            self.parent, self.root = None, self
            self.attrs["counters"] = {}
            self.launches = _launches()
        stack.append(self)
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = perf_counter_ns()
        stack = _local.stack
        if stack[-1] is self:
            stack.pop()
        else:                               # closed out of order
            stack.remove(self)
        root = self.root
        if root is self:
            counters = self.attrs["counters"]
            for (name, _, _), now, then in zip(_KERNELS, _launches(),
                                               self.launches):
                counters[name] = now - then
        _done.append((self.name, root.id, self.id, self.parent,
                      self.start_ns, end, self.attrs))
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the current request (nothing
    outside a span, nothing while the recorder is off)."""
    if not recording:
        return
    stack = _stack()
    if stack:
        counters = stack[-1].root.attrs["counters"]
        counters[name] = counters.get(name, 0) + n


class _HostSync(_Span):
    """An open :func:`host_sync`: it counts itself on its request."""

    __slots__ = ()

    def __enter__(self):
        _Span.__enter__(self)
        counters = self.root.attrs["counters"]
        key = "host.sync." + self.attrs["site"]
        counters[key] = counters.get(key, 0) + 1
        return self


def traced(name: str, after=None, **attrs):
    """Decorator: while recording, run the function inside ``span(name,
    **attrs)``; ``after(result, *args, **kwargs)``, if given, returns more
    attributes for the span when the function returns."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not recording:
                return fn(*args, **kwargs)
            with _Span(name, dict(attrs)) as s:
                out = fn(*args, **kwargs)
                if after is not None:
                    s.attrs.update(after(out, *args, **kwargs))
                return out
        return run
    return wrap


def _jsonable(v):
    return v.tolist() if hasattr(v, "tolist") else str(v)


def _add_spans_to_trace(path: str, since_ns: int) -> None:
    """Append the spans that closed after ``since_ns`` (and those still
    open, cut at now) to the Chrome trace at ``path``, as complete events
    on a track of this process, on the trace's clock."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    now = perf_counter_ns()
    chosen = [s for s in spans() if s.end_ns >= since_ns]
    chosen += [Span(s.name, s.root.id, s.id, s.parent, s.start_ns, now,
                    dict(s.attrs, open=True)) for s in _stack()]
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid,
                   "tid": SPAN_TRACK,
                   "args": {"name": "bluest_tpu_torch spans"}})
    for s in chosen:
        events.append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
            "tid": SPAN_TRACK, "ts": (unix_ns(s.start_ns) - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": dict(s.attrs, request=s.request, id=s.id,
                         parent=s.parent)})
    with open(path, "w") as f:
        json.dump(trace, f, default=_jsonable)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None):
    """Profile the block on the host and, where there is a card, on the
    card; yields the ``torch.profiler.profile`` object.  With
    ``trace_dir`` the Chrome trace of the block is written there as
    ``solve_<pid>_<time>.json`` when the block ends, with the recorder's
    spans of the block (while it records) on a track of their own."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    since = perf_counter_ns()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "solve_%d_%d.json"
                            % (os.getpid(), time_ns()))
        prof.export_chrome_trace(path)
        if recording:
            _add_spans_to_trace(path, since)
