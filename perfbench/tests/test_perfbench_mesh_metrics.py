"""The readers of the mesh layer's metrics, ``mesh.chunk_imbalance`` and
``mesh.fetch_wait_ms``, on synthetic runs of four ranks: rank 0's
``run["program"]`` and each other rank's ``run["ranks"][i]["program"]``
as ``program_trace.program`` leaves them, and nothing read where a rank
recorded nothing (one card, an untraced run, a program without the
counter or the span)."""

import pytest

from bluest_tpu_torch.profiling import Span
from perfbench import harness
from perfbench import program_trace as pt

IMBALANCE = harness.metric_reader("mesh.chunk_imbalance")
FETCH_WAIT = harness.metric_reader("mesh.fetch_wait_ms")


def _program(chunks, fetch_ms, requests=3):
    """``program_trace.program`` of a warm request and ``requests``
    window requests, each counting ``chunks`` on ``mesh.chunks`` (None:
    no such counter) with two ``mesh.fetch`` spans of ``fetch_ms`` / 2
    each (None: no such span)."""
    spans, sid, t = [], 1, 0
    for _ in range(requests + 1):
        root = sid
        counters = {} if chunks is None else {"mesh.chunks": chunks}
        kids = []
        if fetch_ms is not None:
            for k in range(2):
                a = t + 1_000 + k * 10_000_000
                kids.append(Span("mesh.fetch", root, sid + 1 + k, root, a,
                                 a + int(fetch_ms * 5e5), {}))
        end = t + 50_000_000
        spans += kids + [Span("solve", root, root, None, t, end,
                              {"counters": counters})]
        sid += 3
        t = end + 1_000
    return pt.program(spans)


def _run(chunks, fetch_ms):
    """A traced run on len(chunks) ranks: rank r counts chunks[r] a
    request and waits fetch_ms[r] a request in ``mesh.fetch``."""
    progs = [_program(c, f) for c, f in zip(chunks, fetch_ms)]
    return {"program": progs[0],
            "ranks": [{"rank": r, "program": p}
                      for r, p in enumerate(progs[1:], 1)]}


@pytest.mark.parametrize("chunks,want", [
    ([32, 31, 31, 31], 32 / 31.25),     # one dispatch of 125 chunks, even
    ([41, 29, 28, 28], 41 / 31.5),      # each call dealt on its own
    ([30, 30, 30, 30], 1.0)])
def test_chunk_imbalance_is_the_largest_rank_over_the_mean(chunks, want):
    run = _run(chunks, [1.0] * 4)
    assert run["program"]["requests"] == 3
    assert run["program"]["counters"]["mesh.chunks"] == 3 * chunks[0]
    assert IMBALANCE(run) == pytest.approx(want)


def test_fetch_wait_is_the_largest_rank_mean_per_request():
    run = _run([31] * 4, [2.0, 7.5, 3.0, 0.5])
    assert run["program"]["spans"]["mesh.fetch"][0] == 6
    assert FETCH_WAIT(run) == pytest.approx(7.5, rel=1e-6)


@pytest.mark.parametrize("read", [IMBALANCE, FETCH_WAIT],
                         ids=["chunk_imbalance", "fetch_wait_ms"])
def test_nothing_to_read_is_none(read):
    # one card: no other rank
    one = _run([31], [1.0])
    assert one["ranks"] == [] and read(one) is None
    # untraced: no program on any rank
    assert read({"program": None, "ranks": [{"rank": 1}]}) is None
    assert read({"program": None, "ranks": None}) is None
    # a program that lacks the counter and the span on one rank (the
    # parent of this metric's program)
    assert read(_run([31, 31, None, 31], [1.0, 1.0, None, 1.0])) is None
    # a rank whose window held no request
    run = _run([31] * 4, [1.0] * 4)
    run["ranks"][0]["program"] = _program(31, 1.0, requests=0)
    assert read(run) is None
