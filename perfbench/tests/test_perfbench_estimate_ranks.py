"""An estimate cell on two ranks, run through the launcher as the
benchmark's command runs it: the port's sample mesh over the job, every
rank's kept rows gathered to rank 0 and paired with the chunks that the
check follows.  The sound run is correct and reports ``estimate_s``,
which names no cells; each fault of a cell on several ranks, planted on
rank 1, is not correct: a chunk that no rank ran, a chunk that two ranks
ran, a rank's rows left out of the gather, a rank's sums left out of
the ``all_reduce``.

Each case copies the harness into ``tmp_path`` with a manifest whose
only cell is a small Hodgkin-Huxley estimate on two ``gloo`` ranks
(chunks of 1,024 rows, so that both ranks hold chunks of the largest
group), and runs ``perfbench/run.py --device cpu`` there.
"""

import json
import shutil

import pytest

from perfbench import harness
from perfbench.tests.test_perfbench_ranks import (assert_no_rank_left, line,
                                                  run_tree)

SEED = 2 ** 32 + 31
CELL = "hh12.estimate_small"

# the estimate request kind with one fault planted on rank 1
FAULTY = '''
from bluest_tpu_torch.parallel import mesh as _mesh
from bluest_tpu_torch.sampling import group_engine as _engine
import torch

from perfbench.requests import estimate as _estimate
from perfbench.requests.estimate import *  # noqa: F401,F403

_deal = _engine.rank_chunks
_reduce = _mesh.Mesh.all_reduce_samples


def _one_short(n, mesh=None):       # its last chunk of a call: no rank
    return _deal(n, mesh)[:-1]


def _one_more(n, mesh=None):        # also rank 0's last chunk of a call
    r = _deal(n, mesh)
    return range(r.start - 1, r.stop) if len(r) and r.start else r


def _without_mine(self, x, op="sum"):
    return _reduce(self, torch.zeros_like(x) if op == "sum" else x, op)


def setup(ctx):
    fault = ctx.cell["fault"] if ctx.rank == 1 else None
    if fault == "chunk_unrun":
        _engine.rank_chunks = _one_short
    elif fault == "chunk_twice":
        _engine.rank_chunks = _one_more
    elif fault == "sums_left_out":
        _mesh.Mesh.all_reduce_samples = _without_mine
    return dict(_estimate.setup(ctx), fault=fault)


def gather(state):
    out = _estimate.gather(state)
    if state["fault"] == "rows_left_out":
        out = [(counter, []) for counter, _blocks in out]
    return out
'''


def hh_tree(tmp_path, fault=None):
    """A copy of the harness under ``tmp_path`` whose manifest has one
    small HH estimate cell on two ranks; returns its root."""
    root = tmp_path / "tree"
    shutil.copytree(harness.HERE, root / "perfbench", ignore=(
        shutil.ignore_patterns("__pycache__", "tests")))
    pb = root / "perfbench"
    (pb / "requests" / "estimate_faulty.py").write_text(FAULTY)
    bench = harness.manifest()
    cell, cfg = harness.cell_files("hh12.estimate_k3")
    cfg = dict(cfg, name="hh12_small", device_batch_size=1024)
    why = "a small HH estimate on two ranks"
    cell = dict(cell, config=cfg["name"], chips=2, budget=2e4, why=why,
                kind="estimate_faulty" if fault else "estimate",
                fault=fault)
    (pb / "configs" / "hh12_small.json").write_text(json.dumps(cfg))
    (pb / "workloads" / (CELL + ".json")).write_text(json.dumps(cell))
    bench["configs"] = [{"name": cfg["name"], "source": cfg["source"],
                         "file": "perfbench/configs/hh12_small.json",
                         "reduced": [], "why": why}]
    bench["workloads"] = [{"name": CELL, "config": cfg["name"],
                           "traffic": "estimate_small", "chips": 2,
                           "why": why}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(tmp_path, fault=None):
    rc, out, err, _took, pid = run_tree(hh_tree(tmp_path, fault),
                                        workload=CELL, seed=SEED,
                                        seconds=0.0, limit=300)
    assert_no_rank_left(pid)
    return line(rc, out, err), err


@pytest.mark.distributed
def test_two_ranks_estimate_is_correct(tmp_path):
    res, err = _run(tmp_path)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["device"]["count"] == 2
    assert res["metrics"]["estimate_s"]["value"] > 0
    assert "gather: " in err and "check: " in err


@pytest.mark.distributed
@pytest.mark.parametrize("fault", ["chunk_unrun", "chunk_twice",
                                   "rows_left_out", "sums_left_out"])
def test_two_ranks_fault_is_not_correct(tmp_path, fault):
    res, _err = _run(tmp_path, fault)
    assert not res["correct"], res["checks"]
