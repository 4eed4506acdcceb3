"""The interior-point iteration over static buffers, on the CPU.

On a card ``solvers/sdp.py`` captures each iteration once a solve attempt
into a CUDA graph (``_IterationGraph``) and replays it: the iterate lives
in static buffers and taking a step is a copy into them.  Here the same
step function runs eagerly on those buffers (``loop="static"``) and is
held against the eager host loop (``loop="eager"``, the default on the
host): the same iterations, done codes, status, best x and final iterate,
bit for bit, on the seeded cone programs of ``tests/test_torch_cuda.py``
(the dense normal matrix), on structured programs forced onto the
Woodbury path, and through the 0.85 step-fraction retry (a second
attempt, on a card a second capture).  No jax.
"""

import numpy as np
import pytest
import torch

from bluest_tpu_torch.config import allocation_device_scope
from bluest_tpu_torch.solvers import sdp
from test_torch_cuda import ALLOC_PROGRAMS, _alloc_programs

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cold(monkeypatch):
    monkeypatch.setenv("BLUEST_TPU_IPM_WARM", "0")
    monkeypatch.delenv("BLUEST_TPU_ALLOC_DEVICE", raising=False)
    sdp._WARM_CACHE.clear()


def _solve(prog, loop, fail_first=False, **kw):
    """The cone program on the host through ``loop``: the result and each
    interior-point solve's (iterations, done, best x, final iterate).
    ``fail_first`` replaces the 0.99 attempt by a failed one, so the
    solve retries at 0.85."""
    real = sdp._ipm_solve
    rec = []

    def ipm(*a, **k):
        if fail_first and a[11] > 0.92:
            return dict(merit=np.inf), 0, 2, None, None
        out = real(*a, **k, loop=loop)
        rec.append((out[1], out[2], out[0]["x"].numpy(),
                    tuple(t.numpy() for t in out[4])))
        return out

    sdp._ipm_solve = ipm
    try:
        with allocation_device_scope("cpu"):
            res = sdp.solve_cone_lp(*prog, **kw)
    finally:
        sdp._ipm_solve = real
    return res, rec


def _static_equals_eager(prog, **kw):
    (rs, recs), (re_, rece) = (_solve(prog, loop, **kw)
                               for loop in ("static", "eager"))
    assert rs.status == re_.status and rs.iterations == re_.iterations
    assert np.array_equal(rs.x, re_.x, equal_nan=True)
    assert (rs.gap, rs.pres, rs.dres, rs.pobj) == (re_.gap, re_.pres,
                                                   re_.dres, re_.pobj)
    assert len(recs) == len(rece) >= 1
    for a, b in zip(recs, rece):
        assert a[:2] == b[:2]
        assert np.array_equal(a[2], b[2])
        assert all(np.array_equal(u, v) for u, v in zip(a[3], b[3]))
    return rs


@pytest.mark.parametrize("case", ALLOC_PROGRAMS)
def test_static_iteration_matches_eager_loop(case):
    res = _static_equals_eager(_alloc_programs()[case]())
    assert res.status in ("optimal", "inaccurate")


@pytest.mark.parametrize("case", ["lmi-21", "budget-3"])
def test_static_iteration_matches_eager_loop_woodbury(case):
    res = _static_equals_eager(_alloc_programs()[case](), woodbury=True)
    assert res.dims["woodbury"]


@pytest.mark.parametrize("case", ["lmi-7", "eps-1"])
def test_static_iteration_matches_eager_loop_retry(case):
    res = _static_equals_eager(_alloc_programs()[case](), fail_first=True)
    assert res.dims["retried"]


def test_static_iteration_holds_its_buffers():
    """The iterate's buffers stay the same tensors through the solve:
    each step is copied into them, which a graph's replays rely on."""
    seen = []
    real = sdp._IterationGraph.adopt

    def adopt(self, step):
        seen.append(tuple(t.data_ptr() for t in self.iterate))
        real(self, step)
        assert all(torch.equal(d, s) for d, s in zip(self.iterate, step[:7]))

    sdp._IterationGraph.adopt = adopt
    try:
        res, _ = _solve(_alloc_programs()["budget-1"](), "static")
    finally:
        sdp._IterationGraph.adopt = real
    assert len(seen) >= res.iterations - 1 >= 1
    assert len(set(seen)) == 1


def test_loop_names_are_checked():
    """A graph needs a card, and an unknown loop is refused."""
    prog = _alloc_programs()["lp"]()
    with pytest.raises(ValueError, match="needs a card"):
        _solve(prog, "graph")
    with pytest.raises(ValueError, match="loop must be"):
        _solve(prog, "fused")
