"""The reduction of the program's spans (``program_trace.py``): planted
idle stretches charged to the right spans, the card's items moved onto
the spans' clock, the per-request numbers, nothing read where the
program recorded nothing, and a traced run on the host."""

from types import SimpleNamespace

import pytest
import torch

from bluest_tpu_torch.profiling import Span
from perfbench import program_trace as pt


def _span(name, sid, parent, t0, t1, request=1, **attrs):
    return Span(name, request, sid, parent, t0, t1, attrs)


def _request():
    """solve [0, 100]: sample [0, 60] (host.sync [10, 20], model.evaluate
    [20, 30]), estimate [70, 90]."""
    return [_span("host.sync", 3, 2, 10, 20, site="fetch"),
            _span("model.evaluate", 4, 2, 20, 30),
            _span("sample", 2, 1, 0, 60),
            _span("estimate", 5, 1, 70, 90),
            _span("solve", 1, None, 0, 100, counters={})]


def test_idle_is_charged_to_the_innermost_span():
    pieces = pt.charge_idle(_request(), [(0, 10), (20, 25), (95, 100)],
                            0, 120)
    got = {}
    for a, b, s in pieces:
        key = None if s is None else s.name
        got[key] = got.get(key, 0) + b - a
    assert got == {"host.sync": 10, "model.evaluate": 5, "sample": 30,
                   "solve": 15, "estimate": 20, None: 20}
    assert sum(b - a for a, b, _ in pieces) == 100


def test_idle_report():
    rep = pt.idle_report(_request(), [(0, 10), (20, 25), (95, 100)],
                         (0, 120))
    assert rep["idle"] == {"window_ns": 120, "idle_ns": 100,
                           "in_solve_ns": 80, "leaf_ns": 35}
    assert rep["idle_by_span"][0] == ["sample", pytest.approx(30e-6)]
    assert dict(rep["idle_by_span"])[pt.OUTSIDE] == pytest.approx(20e-6)
    # the longest stretch between device items, [25, 95], and its holder
    assert rep["idle_gaps"][0] == [pytest.approx(70e-6), "sample"]
    assert dict(rep["own_idle"]) == {
        "sample after model.evaluate": pytest.approx(30e-6),
        "solve after sample": pytest.approx(10e-6),
        "solve after estimate": pytest.approx(5e-6)}


def test_a_planted_gap_goes_to_its_leaf():
    """An idle stretch planted inside one leaf of one request among
    several is charged to that leaf alone."""
    spans = []
    for k in range(3):
        base = 1000 * k
        spans += [_span("sample.chunk", 10 * k + 2, 10 * k + 1, base,
                        base + 500, request=10 * k + 1),
                  _span("estimate", 10 * k + 3, 10 * k + 1, base + 600,
                        base + 900, request=10 * k + 1),
                  _span("solve", 10 * k + 1, None, base, base + 950,
                        request=10 * k + 1, counters={})]
    busy = [(0, 1600), (1900, 3000)]        # idle [1600, 1900]
    rep = pt.idle_report(spans, busy, (0, 3000))
    assert rep["idle_by_span"] == [["estimate", pytest.approx(300e-6)]]
    assert rep["idle"]["leaf_ns"] == rep["idle"]["in_solve_ns"] == 300


def test_read_moves_the_card_onto_the_spans_clock():
    """A device item at Unix 5,000,010 us lies at perf 1,010 us when the
    anchor pairs perf 1,000 us with Unix 5,000,000 us."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ev = [SimpleNamespace(time_range=SimpleNamespace(start=10.0, end=20.0),
                          device_type=cuda),
          SimpleNamespace(time_range=SimpleNamespace(start=0.0, end=90.0),
                          device_type=cpu)]
    prof = SimpleNamespace(events=lambda: ev, profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(trace_start_ns=lambda: 5_000_000_000)))
    items = pt.device_items(prof)
    assert items == [(5_000_010_000, 5_000_020_000)]
    busy = pt.busy_on_clock(items, (1_000_000, 5_000_000_000))
    assert busy == [[1_010_000, 1_020_000]]
    spans = [_span("host.sync", 2, 1, 1_000_000, 1_030_000),
             _span("solve", 1, None, 1_000_000, 1_030_000, counters={})]
    out = pt.idle_report(spans, busy, (1_000_000, 1_030_000))
    assert out["idle"]["idle_ns"] == 20_000
    assert out["idle_by_span"] == [["host.sync", pytest.approx(0.02)]]
    assert [r["name"] for r in pt.requests(spans)] == ["solve"]


def _program():
    spans = [_span("setup_solver", 1, None, 0, 2_000_000_000, request=1,
                   counters={})]
    t = 3_000_000_000
    for k, (est, sync, drawn, kept) in enumerate(
            [(9e6, 1e6, 100, 100), (8e6, 4e6, 110, 100),
             (10e6, 6e6, 120, 100), (12e6, 5e6, 130, 100)]):
        rid = 10 * (k + 1)
        spans += [_span("host.sync", rid + 1, rid, t, t + int(sync / 2),
                        request=rid),
                  _span("host.sync", rid + 2, rid, t + int(sync / 2),
                        t + int(sync), request=rid),
                  _span("estimate", rid + 3, rid, t + 20_000_000,
                        t + 20_000_000 + int(est), request=rid),
                  _span("solve", rid, None, t, t + 50_000_000, request=rid,
                        counters={"rows.drawn": drawn, "rows.kept": kept})]
        t += 100_000_000
    return pt.requests(spans)


def test_summary_of_the_window():
    s = pt.summary(_program())          # the first solve is the warm one
    assert s["estimator.host_ms"] == pytest.approx(10.0)
    assert s["sample.host_syncs_per_estimate"] == 2
    assert s["sample.sync_wait_ms"] == pytest.approx(5.0)
    assert s["sample.draw_yield"] == pytest.approx(100 * 300 / 360)
    assert s["setup.alloc_s"] == pytest.approx(2.0)
    later = pt.summary(_program(), start_ns=3_150_000_000)
    assert later["sample.draw_yield"] == pytest.approx(100 * 200 / 250)


def test_program_of_a_recording():
    """``run["program"]``: the window's requests (the warm one left
    out), their summary, spans and counters summed, and the set-up's
    spans."""
    spans = [s for r in _program() for s in r["spans"]]
    prog = pt.program(spans)
    assert prog["requests"] == 3
    assert prog["summary"] == pt.summary(pt.requests(spans))
    assert prog["spans"]["host.sync"] == [6, pytest.approx(0.015)]
    assert prog["spans"]["solve"] == [3, pytest.approx(0.15)]
    assert prog["counters"] == {"rows.drawn": 360, "rows.kept": 300}
    assert prog["setup"] == {"setup_solver": [1, pytest.approx(2.0)]}


def test_nothing_to_read():
    """A run whose program recorded no span (a program without the
    recorder) reads None for every number."""
    assert pt.requests([]) == []
    assert set(pt.summary([]).values()) == {None}
    prog = pt.program([])
    assert prog["requests"] == 0 and not prog["spans"] and \
        not prog["setup"]


def test_a_traced_run_on_the_host_reports_every_number():
    res = pt.traced_run("hh12.estimate_k3", 2 ** 32 + 7, 0.0, device="cpu",
                        overrides=dict(budget=2e4))
    prog = res["program"]
    assert res["correct"]
    for name in ("estimator.host_ms", "sample.host_syncs_per_estimate",
                 "sample.sync_wait_ms", "sample.draw_yield",
                 "setup.alloc_s"):
        v = prog["summary"][name]
        assert v is not None and v > 0, name
    assert prog["requests"] == 1
    assert {"setup_solver", "alloc.structure", "alloc.sdp"} <= set(
        prog["setup"])
    assert prog["spans"]["solve"][0] == 1
    assert prog["spans"]["host.sync"][0] == \
        prog["summary"]["sample.host_syncs_per_estimate"]
    assert prog["counters"]["rows.drawn"] >= prog["counters"]["rows.kept"]
    assert prog["idle"]["in_solve_ns"] > 0
