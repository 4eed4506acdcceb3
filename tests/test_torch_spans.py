"""The span and counter recorder (``bluest_tpu_torch.profiling``) on the
host: what ``solve`` and ``setup_solver`` record for a small
Hodgkin-Huxley problem on the CPU, that recording changes no number,
that nothing is recorded while the recorder is off, ``profile_dir``'s
trace file with the program's spans, ``kernels.load``, threads, and the
clock anchor against the profiler's."""

import json
import math
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bluest_tpu_torch import BLUEProblem, profiling
from bluest_tpu_torch.models import hodgkin_huxley as hh
from bluest_tpu_torch.ops import _build
from bluest_tpu_torch.solvers import sdp

torch.set_num_threads(1)
F64 = torch.float64

# RK4 and Euler at dt 0.04 and Euler at 0.08, which blows up on most
# draws: the group engine redraws
MODELS = ((0, 0.04), (1, 0.04), (1, 0.08))
CORR = np.array([[1.0, 0.9, 0.8], [0.9, 1.0, 0.85], [0.8, 0.85, 1.0]])
BUDGET = 1e3
BATCH = 64


@pytest.fixture(autouse=True)
def _fresh():
    sdp._WARM_CACHE.clear()
    yield
    profiling.disable_spans()


def _hh(**kw):
    return hh.HodgkinHuxleyProblem(models=MODELS, C=[CORR] * 5,
                                   verbose=False, device="cpu",
                                   device_batch_size=BATCH, seed=3, **kw)


class _Counted:
    """Wraps a problem's ``evaluate_group`` to count the rows evaluated
    and the rows that came out non-finite."""

    def __init__(self, problem):
        self.rows = self.bad = 0
        inner = problem.evaluate_group

        def evaluate_group(ls, x):
            out = inner(ls, x)
            self.rows += out.shape[0]
            self.bad += int((~torch.isfinite(out).flatten(1).all(1)).sum())
            return out
        problem.evaluate_group = evaluate_group


@pytest.fixture(scope="module")
def recorded():
    """One set-up and one solve of the small HH problem, recorded."""
    sdp._WARM_CACHE.clear()
    p = _hh()
    counted = _Counted(p)
    profiling.enable_spans()
    try:
        p.setup_solver(K=3, budget=BUDGET)
        mus, errs, _ = p.solve(K=3, budget=BUDGET)
    finally:
        profiling.disable_spans()
    return {"problem": p, "spans": profiling.spans(), "mus": mus,
            "errs": errs, "counted": counted}


def _by_request(spans):
    out = {}
    for s in spans:
        out.setdefault(s.request, []).append(s)
    return out


def _root(spans, name):
    roots = [s for s in spans if s.parent is None and s.name == name]
    assert len(roots) == 1
    return roots[0]


def test_one_root_a_solve_and_the_spans_nest(recorded):
    spans = recorded["spans"]
    ids = {s.id: s for s in spans}
    assert len(ids) == len(spans)
    assert [s.name for s in spans if s.parent is None] == ["setup_solver",
                                                          "solve"]
    solve = _root(spans, "solve")
    assert solve.request == solve.id
    for s in spans:
        if s.parent is None:
            assert s.request == s.id
            continue
        parent = ids[s.parent]
        assert parent.request == s.request
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    inside = {s.name for s in _by_request(spans)[solve.id]}
    assert {"sample", "sample.group", "sample.seed", "sample.chunk",
            "sample.inputs", "model.evaluate", "sample.redraw",
            "sample.splice", "sample.combine", "host.sync", "sample.fetch",
            "sample.pack", "sample.unpack", "estimate.sums",
            "estimate"} <= inside
    assert solve.attrs["groups"] == int(np.sum(
        recorded["problem"].MOSAP_output["samples"] > 0))
    # siblings of one parent do not overlap
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    for group in kids.values():
        group.sort(key=lambda s: s.start_ns)
        for a, b in zip(group, group[1:]):
            assert a.end_ns <= b.start_ns


def test_chunks_are_the_allocations(recorded):
    spans = recorded["spans"]
    solve = _root(spans, "solve")
    mine = _by_request(spans)[solve.id]
    groups = [s for s in mine if s.name == "sample.group"]
    chunks = [s for s in mine if s.name == "sample.chunk"]
    assert len(chunks) == sum(math.ceil(g.attrs["N"] / BATCH)
                              for g in groups)
    samples = recorded["problem"].MOSAP_output["samples"]
    first = [g for g in groups if g.attrs["first_chunk"] == 0]
    assert sum(math.ceil(g.attrs["N"] / BATCH) for g in first) == sum(
        math.ceil(int(n) / BATCH) for n in samples if n > 0)
    assert sorted(g.attrs["N"] for g in first) == sorted(
        int(n) for n in samples if n > 0)
    assert sum(s.attrs["rows"] for s in chunks) == sum(g.attrs["N"]
                                                      for g in groups)


def test_rows_drawn_less_rows_kept_are_the_rejected_draws(recorded):
    spans = recorded["spans"]
    counters = _root(spans, "solve").attrs["counters"]
    counted = recorded["counted"]
    total_n = int(np.sum(recorded["problem"].MOSAP_output["samples"]))
    # the set-up draws nothing: every row the model evaluated is the solve's
    assert counters["rows.drawn"] == counted.rows
    assert counters["rows.kept"] == total_n
    rejected = counted.rows - total_n
    assert counters["rows.drawn"] - counters["rows.kept"] == rejected
    assert 0 < counted.bad <= rejected
    redraws = [s for s in spans if s.name == "sample.redraw"]
    chunks = [s for s in spans if s.name == "sample.chunk"]
    assert redraws and sum(s.attrs["rows"] for s in redraws) + sum(
        s.attrs["rows"] for s in chunks) == counted.rows


def test_host_syncs_are_counted_by_site(recorded):
    spans = recorded["spans"]
    solve = _root(spans, "solve")
    counters = solve.attrs["counters"]
    mine = _by_request(spans)[solve.id]
    syncs = [s for s in mine if s.name == "host.sync"]
    sites = {}
    for s in syncs:
        sites[s.attrs["site"]] = sites.get(s.attrs["site"], 0) + 1
    assert {k: v for k, v in counters.items()
            if k.startswith("host.sync.")} == {
        "host.sync." + k: v for k, v in sites.items()}
    chunks = sum(s.name == "sample.chunk" for s in mine)
    redraws = sum(s.name == "sample.redraw" for s in mine)
    fetches = sum(s.name == "sample.fetch" for s in mine)
    # one count a chunk; which rows failed is read once in each chunk
    # whose first draw had failing rows, the chunks that redraw
    ids = {s.id: s for s in mine}
    failing = {s.parent for s in mine if s.name == "sample.redraw"}
    assert all(ids[c].name == "sample.chunk" for c in failing)
    assert sites == {"draw.count": chunks, "draw.bad": len(failing),
                     "draw.good": redraws, "fetch": fetches}
    # every chunk but the first of each fetch round's sequence is drawn
    # ahead of the read before it
    assert counters["draw.ahead"] == chunks - fetches
    assert counters["k2.launches"] == 0          # the plain model on the host
    assert counters["k6.launches"] == 0          # and the plain combiner
    assert all(not any(c.parent == s.id for c in spans) for s in syncs)


def test_setup_solver_spans(recorded):
    spans = recorded["spans"]
    root = _root(spans, "setup_solver")
    assert root.attrs["K"] == 3 and root.attrs["budget"] == BUDGET
    kids = [s for s in spans if s.parent == root.id]
    names = [s.name for s in kids]
    assert names[0] == "alloc.structure" and "alloc.integer" in names
    sdp_span = [s for s in spans if s.name == "alloc.sdp"]
    assert sdp_span and sdp_span[0].request == root.id
    assert sdp_span[0].attrs["L"] == recorded["problem"].MOSAP.L
    assert sdp_span[0].attrs["iterations"] > 0
    assert next(s for s in kids if s.name == "alloc.structure").attrs[
        "L"] == recorded["problem"].MOSAP.L


def test_recording_changes_no_number(recorded):
    """The same problem solved with the recorder off: means and error bars
    bit-equal."""
    p = _hh()
    p.setup_solver(K=3, budget=BUDGET)
    mus, errs, _ = p.solve(K=3, budget=BUDGET)
    assert profiling.spans() == recorded["spans"]      # nothing added
    for a, b in zip(mus, recorded["mus"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(errs), np.asarray(recorded["errs"]))


def test_nothing_recorded_while_off():
    profiling.enable_spans()
    profiling.disable_spans()
    p = _Series(M=3, C=np.eye(3) * 0.5 + 0.5, costs=np.array([4., 2., 1.]),
                verbose=False, device="cpu", device_batch_size=256)
    p.solve(K=2, budget=400.0)
    assert profiling.spans() == []
    assert not profiling.recording


def test_off_sites_record_nothing():
    """With the recorder off every site gets the shared no-op, ``count``
    adds nothing to an open request, and a solve records no span."""
    assert profiling.span("sample.chunk", chunk=0, rows=8) is profiling.OFF
    assert profiling.host_sync("fetch") is profiling.OFF
    profiling.enable_spans()
    with profiling.span("request") as root:
        profiling.disable_spans()
        profiling.count("rows.drawn", 5)
        with profiling.host_sync("fetch") as sp:
            assert sp is None
    assert set(root.attrs["counters"]) == {"k2.launches", "k6.launches"}
    profiling.enable_spans()
    profiling.disable_spans()
    p = _Series(M=3, C=np.eye(3) * 0.5 + 0.5, costs=np.array([4., 2., 1.]),
                verbose=False, device="cpu", device_batch_size=256)
    p.solve(K=2, budget=400.0)
    assert profiling.spans() == []


class _Series(BLUEProblem):
    """A fast coupled-group model: partial exponential series of one
    normal draw; rows with z > 1.5 give NaN."""

    def sample_group(self, generator, ls, n):
        return torch.randn(n, generator=generator, dtype=F64,
                           device=self.device)

    def evaluate_group(self, ls, z):
        ii = torch.arange(6, dtype=F64)
        cols = [(z[:, None] ** ii[:6 - l] / torch.exp(torch.lgamma(
            ii[:6 - l] + 1.0))).sum(1) for l in ls]
        out = torch.stack(cols, dim=1)[:, None, :]
        return torch.where(z[:, None, None] > 1.5,
                           torch.full_like(out, float("nan")), out)


def test_profile_dir_trace_holds_the_spans(tmp_path):
    p = _Series(M=3, C=np.eye(3) * 0.5 + 0.5, costs=np.array([4., 2., 1.]),
                verbose=False, device="cpu", device_batch_size=256,
                profile_dir=str(tmp_path))
    p.setup_solver(K=2, budget=400.0)
    p.solve(K=2, budget=400.0)
    assert not profiling.recording              # on for the call only
    files = list(tmp_path.glob("solve_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    mine = [e for e in trace["traceEvents"]
            if e.get("cat") == "program_span"]
    names = {e["name"] for e in mine}
    assert {"solve", "sample", "sample.chunk", "sample.fetch",
            "host.sync", "estimate"} <= names
    solve = next(e for e in mine if e["name"] == "solve")
    assert solve["args"]["open"] and solve["args"]["parent"] is None
    assert all(e["args"]["request"] == solve["args"]["id"] for e in mine)
    # the spans sit on the profiler's clock: the solve's torch ops lie
    # inside the solve span
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    assert ops
    lo, hi = solve["ts"], solve["ts"] + solve["dur"]
    assert all(lo - 1e3 <= e["ts"] <= hi + 1e3 for e in ops)


def test_profiler_clock_anchor():
    """A host op recorded by ``torch.profiler`` inside a span lies inside
    the span once the span is moved onto the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(256, 256, dtype=F64)
    profiling.enable_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("matmul") as s:
            for _ in range(20):
                x = x @ x / 256.0
    profiling.disable_spans()
    span = profiling.spans()[0]
    assert span.id == s.id
    start = prof.profiler.kineto_results.trace_start_ns()
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(mm) == 20
    lo, hi = profiling.unix_ns(span.start_ns), profiling.unix_ns(span.end_ns)
    for e in mm:
        assert lo - 200_000 <= start + e.time_range.start * 1e3
        assert start + e.time_range.end * 1e3 <= hi + 200_000


def test_kernels_load_span(tmp_path, monkeypatch):
    """``kernels.load`` around ``ops._build.build``: whether nvcc ran."""
    src = tmp_path / "k.cu"
    src.write_text("// a kernel source\n")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    calls = []

    def fake_nvcc(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return type("Proc", (), {"returncode": 0, "stdout": "",
                                 "stderr": ""})()
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    profiling.enable_spans()
    path = _build.build(str(src), ["-O3"])
    assert _build.build(str(src), ["-O3"]) == path
    profiling.disable_spans()
    loads = profiling.spans()
    assert len(calls) == 1
    assert [(s.name, s.attrs["nvcc"], s.parent) for s in loads] == [
        ("kernels.load", True, None), ("kernels.load", False, None)]
    assert loads[0].attrs["library"] == path.rsplit("/", 1)[1]


def test_threads_record_their_own_requests():
    """Threads record at once: ids stay unique, each thread's spans nest
    under its own roots, and each root counts only its own thread."""
    profiling.enable_spans()
    start = threading.Barrier(8)
    errors = []

    def work(k):
        try:
            start.wait(timeout=30)
            for i in range(50):
                with profiling.span("root", thread=k):
                    with profiling.span("child", thread=k):
                        profiling.count("n", k)
                        time.sleep(0)
                    with profiling.host_sync("x"):
                        pass
        except Exception as exc:         # reported below, in the test
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        profiling.disable_spans()
    assert not errors
    spans = profiling.spans()
    assert len(spans) == 8 * 50 * 3
    assert len({s.id for s in spans}) == len(spans)
    ids = {s.id: s for s in spans}
    for s in spans:
        if s.parent is None:
            assert s.attrs["counters"] == {"n": s.attrs["thread"],
                                           "host.sync.x": 1,
                                           "k2.launches": 0,
                                           "k6.launches": 0}
        else:
            root = ids[s.request]
            assert s.name != "child" or s.attrs["thread"] == \
                root.attrs["thread"]
