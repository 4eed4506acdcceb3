"""A cell on several cards, run through the launcher as the benchmark's
command runs it: rank 0 starts the other ranks, every rank runs the same
requests, the request kind's ``gather`` reaches rank 0's check, and a
rank that fails ends the run with no process left behind.  A cell on one
card starts no process group and prints the keys it always did.

Each case copies the harness into ``tmp_path`` with a manifest of its
own, a configuration, a cell and a toy request kind, and runs
``perfbench/run.py`` there in a process of its own, under a time limit
of its own.  The host's cases run over ``gloo`` (``--device cpu``); the
cards' cases over ``nccl``, on two cards and on four.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, ranks

SEED = 2 ** 32 + 29

TOY = '''
"""A toy request kind: a small product and, on several ranks, one
all_reduce over the cell's process group a request."""
import os
import signal
import sys

import torch
import torch.distributed as dist


def _fault(ctx, where, i=None):
    f = ctx.cell.get("fault") or {}
    if f.get("rank") == ctx.rank and f.get("where") == where \\
            and f.get("i") == i:
        if f["how"] == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise RuntimeError("planted on rank %d" % ctx.rank)


def setup(ctx):
    _fault(ctx, "setup")
    return {"ctx": ctx, "n": 0, "initialized": dist.is_initialized(),
            "x": torch.ones(64, 64, device=ctx.device)}


def request(state, i):
    ctx = state["ctx"]
    _fault(ctx, "request", i)
    y = state["x"] @ state["x"]
    if ctx.world > 1:
        s = y.sum().reshape(1)
        dist.all_reduce(s, group=ctx.group)
        assert float(s) == ctx.world * 64.0 ** 3
    if i >= 0:
        state["n"] += 1
    return {"i": i}


def gather(state):
    ctx = state["ctx"]
    return {"rank": ctx.rank, "world": ctx.world, "n": state["n"],
            "group": ctx.group is not None}


def release(state):
    state.pop("x")


def check(state, records, rng):
    ctx = state["ctx"]
    got = state.get("gathered")
    if ctx.world == 1:
        return [("gathered", float(got is not None)),
                ("initialized", float(state["initialized"])),
                ("ranks_module", float("perfbench.ranks" in sys.modules))]
    wrong = sum(g["rank"] != r or g["world"] != ctx.world or not g["group"]
                for r, g in enumerate(got))
    counts = [g["n"] for g in got] + [len(records)]
    return [("gathered", float(ctx.world - len(got) + wrong)),
            ("initialized", float(not state["initialized"])),
            ("request_gap", float(max(counts) - min(counts)))]
'''


def toy_tree(tmp_path, chips, fault=None):
    """A copy of the harness under ``tmp_path`` whose manifest has one
    toy cell on ``chips`` cards; returns its root."""
    root = tmp_path / "tree"
    shutil.copytree(harness.HERE, root / "perfbench", ignore=(
        shutil.ignore_patterns("__pycache__", "tests", "inputs")))
    (root / "perfbench" / "requests" / "toy.py").write_text(TOY)
    (root / "perfbench" / "metrics" / "ranks_with_program.py").write_text(
        "def read(run):\n"
        "    return sum('program' in r for r in run['ranks'] or [])\n")
    why = "a toy request kind on %d rank(s)" % chips
    limits = dict(gathered=0, initialized=0, **(
        {"request_gap": 0} if chips > 1 else {"ranks_module": 0}))
    (root / "perfbench" / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "inputs": "none", "reduced": [], "assumed": []}))
    (root / "perfbench" / "workloads" / "toy.run.json").write_text(
        json.dumps({"config": "toy", "kind": "toy", "chips": chips,
                    "why": why, "fault": fault, "limits": limits}))
    bench = harness.manifest()
    bench["configs"] = [{"name": "toy", "source": "none",
                         "file": "perfbench/configs/toy.json",
                         "reduced": [], "why": why}]
    bench["workloads"] = [{"name": "toy.run", "config": "toy",
                           "traffic": "run", "chips": chips, "why": why}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["per_layer"].append({
        "name": "ranks_with_program", "unit": "ranks", "better": "higher",
        "source": "program_span", "layer": "ranks", "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tree(root, device="cpu", trace=0, seconds=1.0, limit=120,
             workload="toy.run", seed=SEED):
    """The benchmark's command for ``workload`` in ``root`` under the time
    limit ``limit``, the port found beside the real harness; returns
    (return code, standard output, standard error, seconds, rank 0's
    process id)."""
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace), "--device", device], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=harness.ROOT))
    try:
        out, err = proc.communicate(timeout=limit)
    finally:
        proc.kill()
        proc.wait()
    return proc.returncode, out, err, time.monotonic() - t0, proc.pid


def ranks_of(pid):
    """Process ids of the live ranks that rank 0 ``pid`` started."""
    mark = ("%s=%d" % (ranks.PARENT, pid)).encode() + b"\0"
    found = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open("/proc/%s/environ" % d, "rb") as f:
                    if mark in f.read():
                        found.append(int(d))
            except OSError:         # ended, or another user's
                pass
    return found


def assert_no_rank_left(pid, limit=10.0):
    t_end = time.monotonic() + limit
    while ranks_of(pid) and time.monotonic() < t_end:
        time.sleep(0.1)
    assert not ranks_of(pid)


def line(rc, out, err):
    assert rc == 0, err[-4000:]
    out = out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


@pytest.mark.distributed
@pytest.mark.parametrize("trace", [0, 1])
def test_two_ranks_over_gloo(tmp_path, trace):
    rc, out, err, _, pid = run_tree(toy_tree(tmp_path, 2), trace=trace)
    res = line(rc, out, err)
    assert res["correct"], res["checks"]
    assert res["checks"]["request_gap"]["value"] == 0
    assert res["attempted"] > 0 and res["failed"] == 0
    dev = res["device"]
    assert dev["count"] == 2 and dev["platform"] == "cpu"
    assert len(dev["memory_peak_bytes_by_rank"]) == 2
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_by_rank"])
    assert ("busy_s" in dev and "breakdown" in res) == bool(trace)
    # a traced run's other ranks send their program's recording too
    assert res["metrics"].get("ranks_with_program", {}).get("value") == \
        (1 if trace else None)
    assert_no_rank_left(pid)


@pytest.mark.distributed
@pytest.mark.parametrize("fault", [
    {"rank": 1, "where": "setup", "how": "raise"},
    {"rank": 0, "where": "setup", "how": "raise"},
    {"rank": 1, "where": "request", "i": 3, "how": "kill"},
    {"rank": 0, "where": "request", "i": 3, "how": "kill"},
], ids=["rank1-raises", "rank0-raises", "rank1-killed", "rank0-killed"])
def test_a_failed_rank_ends_the_run(tmp_path, fault):
    rc, out, err, took, pid = run_tree(toy_tree(tmp_path, 2, fault),
                                       seconds=30.0)
    assert rc != 0 and out.strip() == "", err[-4000:]
    assert took < 30.0, err[-4000:]     # long before the window's end
    assert_no_rank_left(pid)


def test_one_card_starts_no_process_group(tmp_path):
    res = line(*run_tree(toy_tree(tmp_path, 1))[:3])
    assert res["correct"], res["checks"]
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["device"]["count"] == 1


KILL_RANK1 = {"rank": 1, "where": "request", "i": 3, "how": "kill"}


@pytest.mark.gpu
@pytest.mark.distributed
@pytest.mark.parametrize("world, trace, fault", [
    (2, 0, None), (2, 1, None), (4, 1, None), (2, 0, KILL_RANK1),
], ids=["2", "2-traced", "4-traced", "2-rank1-killed"])
def test_ranks_over_nccl(tmp_path, world, trace, fault):
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        pytest.skip("needs %d CUDA cards" % world)
    rc, out, err, took, pid = run_tree(toy_tree(tmp_path, world, fault),
                                       device="cuda", trace=trace,
                                       seconds=5.0, limit=300)
    assert_no_rank_left(pid)
    if fault:
        assert rc != 0 and out.strip() == "", err[-4000:]
        assert took < 60.0, err[-4000:]
        return
    res = line(rc, out, err)
    assert res["correct"], res["checks"]
    dev = res["device"]
    assert dev["count"] == world and dev["platform"] == "gpu"
    assert len(dev["memory_peak_bytes_by_rank"]) == world
    assert min(dev["memory_peak_bytes_by_rank"]) > 0
    if trace:
        assert dev["busy_s"] > 0
