"""One run of one cell of the benchmark.

Everything that belongs to one configuration, one cell, one request kind
or one metric is a file of its own, found by the name that
``BENCHMARK.json`` gives:

    configs/<config>.json      sizes, the frozen input file, the pilot
    workloads/<cell>.json      request kind, traffic, check limits
    requests/<kind>.py         setup, request, release, check
    programs/<family>.py       the program's problem for a configuration
    reference/<family>.py      the family's plain reference
    work/<family>.py           least time of a list of evaluations
    metrics/<metric>.py        read(run) -> value or None

A run loads and warms up (``setup_s``), sends requests in a closed loop
of one client for ``seconds``, reads the device's peak memory, drops the
program's objects and checks a sample of the requests against the plain
reference.  It prints one JSON line last on standard output.  A traced
run also records the program's spans and counters, from before set-up
until the profiler stops, into ``run["program"]``.

A cell whose ``chips`` is R > 1 runs as R processes, one a card
(``ranks.py``): every rank sets up, warms up and runs the same
requests, rank 0 deciding when the window ends, and rank 0 alone checks
and prints.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bluest_tpu")


def forbidden_modules(modules=None):
    """Top-level names in ``sys.modules`` (or ``modules``) that name JAX
    or the JAX package, compared whole: ``bluest_tpu_torch`` is not
    ``bluest_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest():
    return load_json(ROOT, "BENCHMARK.json")


def cell_files(name: str):
    """(cell, config) of the cell ``name``, from their files."""
    cell = load_json(HERE, "workloads", name + ".json")
    cfg = load_json(HERE, "configs", cell["config"] + ".json")
    return cell, cfg


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, trace: bool):
    """The manifest's metrics that a run of the cell reports: its
    end-to-end metrics without a trace, its per-layer ones with."""
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" not in m or cell_name in m["workloads"]:
            out.append(m)
    return out


def request_kind(kind: str):
    return importlib.import_module("perfbench.requests." + kind)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None, bench=None,
             overrides=None, log=sys.stderr, ranks=None):
    """Run the cell; returns the result dict (the line the command
    prints), or None on a rank other than 0.  ``ranks`` (a
    ``ranks.Ranks``) runs it as one rank of a cell on several cards;
    ``overrides`` replace keys of the cell (tests only)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    bench = manifest() if bench is None else bench
    cell, cfg = cell_files(name)
    cell = dict(cell, **(overrides or {}))
    ctx = SimpleNamespace(cfg=cfg, cell=cell, seed=int(seed), device=device,
                          inputs=os.path.join(ROOT, cfg["inputs"]),
                          rank=0, world=1, group=None)
    if ranks is not None:
        ctx.rank, ctx.world, ctx.group = ranks.join_group(device)
    kind = request_kind(cell["kind"])
    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # with a trace, the program's recorder of spans and counters is on
    # from before set-up until the profiler stops; untraced runs, which
    # give the end-to-end metrics, leave it off
    recorder = None
    if trace:
        from bluest_tpu_torch import profiling as recorder
        recorder.enable_spans()
    state = kind.setup(ctx)
    kind.request(state, -1)             # warm: never kept for the check
    sync()
    if ranks is not None:
        ranks.barrier()
    setup_s = time.perf_counter() - t_start

    # with a trace, the profiler records the card's activity alone (no
    # host ops: they would slow the host-bound requests several times)
    # over the window's first ``trace_seconds``; the parse of a longer
    # trace outlasts a run's allowance.  Per-layer metrics read device
    # time, which the profiler does not stretch.
    from torch.profiler import ProfilerActivity, profile
    prof = done_prof = None
    traced_s = 0.0
    if trace:
        prof = profile(activities=[ProfilerActivity.CUDA] if cuda
                       else [ProfilerActivity.CPU])
        prof.__enter__()
    trace_for = float(cell.get("trace_seconds", seconds))
    requests = []
    w0 = time.perf_counter()
    i = 0
    while True:
        if ranks is None:
            if requests and time.perf_counter() - w0 >= seconds:
                break
            t0 = time.perf_counter()
            stop = prof is not None and t0 - w0 >= trace_for
        else:           # rank 0 decides for every rank, outside [t0, t1]
            el = time.perf_counter() - w0
            go, stop = ranks.step(not requests or el < seconds,
                                  prof is not None and el >= trace_for)
            if not go:
                break
            t0 = time.perf_counter()
        if stop:
            sync()
            traced_s = time.perf_counter() - w0
            prof.__exit__(None, None, None)
            recorder.disable_spans()
            done_prof, prof = prof, None
        traced = prof is not None
        try:
            rec = kind.request(state, i)
            ok = True
        except Exception as exc:            # a failed request is counted
            rec, ok = {"error": repr(exc)}, False
            print("request %d failed: %r" % (i, exc), file=log)
        t1 = time.perf_counter()
        requests.append({"t0": t0 - w0, "t1": t1 - w0, "ok": ok, "rec": rec,
                         "traced": traced})
        i += 1
    sync()
    window_s = time.perf_counter() - w0
    if prof is not None:
        traced_s = window_s
        prof.__exit__(None, None, None)
        recorder.disable_spans()
        done_prof = prof
    program = None
    if trace:
        from perfbench import program_trace
        program = program_trace.program(recorder.spans())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if ranks is not None and hasattr(kind, "gather"):
        t0 = time.perf_counter()
        gathered = ranks.gather(kind.gather(state))
        if ranks.rank == 0:
            state["gathered"] = gathered
            print("gather: %r s" % (time.perf_counter() - t0), file=log)

    kind.release(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    others = None
    if ranks is not None:
        others = _other_ranks(ranks, peak, window_s, requests, done_prof,
                              traced_s, program)
        if others is None:
            return None
        peak = [peak] + [o["memory_peak_bytes"] for o in others]
        for j, r in enumerate(requests):    # failed on any rank: failed
            r["ok"] = r["ok"] and all(o["requests"][j][2] for o in others)
    done = [r["rec"] for r in requests if r["ok"]]
    rng = np.random.default_rng([int(seed), 7])
    t0 = time.perf_counter()
    checks = kind.check(state, done, rng) if done else []
    print("check: %r s" % (time.perf_counter() - t0), file=log)
    limits = cell["limits"]           # the numbers this cell compares
    checks = [(k, v, float(limits[k])) for k, v in checks if k in limits]
    missing = set(limits) - {k for k, _, _ in checks}
    checks += [(k, math.inf, float(limits[k])) for k in sorted(missing)]
    correct = bool(done) and all(math.isfinite(v) and v <= lim
                                 for _, v, lim in checks)

    tr = None
    if trace:
        from perfbench import trace as trmod
        tr = trmod.read(done_prof, traced_s)
        del done_prof
        for label, part in (("traced", [r for r in requests
                                        if r["traced"]]),
                            ("untraced", [r for r in requests
                                          if not r["traced"]])):
            if part:
                print("%s requests: %d, mean wall %r s" % (
                    label, len(part),
                    sum(r["t1"] - r["t0"] for r in part) / len(part)),
                    file=log)
    run = {"cell": cell, "cell_name": name, "config": cfg,
           "setup_s": setup_s, "window_s": window_s, "requests": requests,
           "state": state, "trace": tr, "program": program,
           "ranks": others}
    metrics = {}
    for m in metrics_of(bench, name, trace):
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell.get("chips", 1))}
    if others is None:
        dev["memory_peak_bytes"] = int(peak)
    else:       # the size of a run is that of its fullest card
        dev["memory_peak_bytes"] = int(max(peak))
        dev["memory_peak_bytes_by_rank"] = [int(p) for p in peak]
    result = {"correct": correct, "attempted": len(requests),
              "failed": sum(not r["ok"] for r in requests),
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = tr["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    return result


def _other_ranks(ranks, peak, window_s, requests, prof, traced_s,
                 program):
    """Rank 0: the other ranks' numbers, in the order of their ranks from
    1: each its peak memory, window, requests' host-clock spans ``[t0,
    t1, ok, traced]`` and, with a trace, its card's busy time and items
    and its ``program`` (``program_trace.program``).  Other ranks: send
    their own and return None.  Ends the process group."""
    mine = {"rank": ranks.rank, "memory_peak_bytes": int(peak),
            "window_s": window_s,
            "requests": [[r["t0"], r["t1"], r["ok"], r["traced"]]
                         for r in requests]}
    if ranks.rank and prof is not None:
        from perfbench import trace
        tr = trace.read(prof, traced_s)
        mine.update(busy_s=tr["busy_s"], items=tr["items"],
                    traced_s=tr["window_s"], program=program)
    got = ranks.gather(mine)
    ranks.close()
    return got[1:] if ranks.rank == 0 else None


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the host instead of the card: the tests' runs, never the benchmark's
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    bench = manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print("no workload %r in BENCHMARK.json" % args.workload,
              file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)            # one process with few threads
    chips = int(cells[args.workload]["chips"])
    cuda = args.device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < chips):
        print("this cell needs %d CUDA card(s); %s" % (
            chips, "found %d" % torch.cuda.device_count()
            if torch.cuda.is_available() else "CUDA is not available"),
            file=sys.stderr)
        return 3
    ranks = None
    if chips > 1:
        from perfbench.ranks import Ranks
        ranks = Ranks(chips)
    try:
        if ranks is not None:
            ranks.launch(sys.argv[1:] if argv is None else argv)
            if cuda:
                torch.cuda.set_device(ranks.local_rank)
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), device=args.device,
                          t_start=t_start, bench=bench, ranks=ranks)
        bad = forbidden_modules()
        if bad:
            print("the run loaded %s; nothing it runs may import JAX or the "
                  "JAX package" % ", ".join(bad), file=sys.stderr)
            return 4
        if ranks is not None and not ranks.wait():
            print("a rank did not end cleanly", file=sys.stderr)
            return 5
    finally:
        if ranks is not None:
            ranks.stop()
    if result is None:                  # a rank other than 0
        return 0
    for k, c in result["checks"].items():
        print("check %s = %r (limit %r)" % (k, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
