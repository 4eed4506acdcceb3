"""Estimate requests: ``problem.solve(K, budget)`` at the allocation made
in set-up, one after another.  Each request draws fresh samples: its
sampling calls take the problem's next call counters, one an active
group, in the allocation's group order.

The program's problem keeps a reference to every block of model outputs
that the sampling engine computed (``programs/<family>.py``); a sample
of the requests, drawn from the seed as the window runs (a reservoir of
``check_requests``), keeps them until the check.  The check follows each
kept request's sampling calls from their streams (``reference/streams``):
it draws the same inputs, evaluates the reference model on them in
float64, and compares

  * ``row_gap``: the largest gap, over every row that the request
    evaluated (redraws included) and every model and output, between
    the program's outputs and the reference's, each relative to the
    larger of the reference's value and that output's median magnitude:
    the worst row, so a fault in one chunk, one lane or one redraw shows;
  * ``est_gap``: the largest gap between the request's estimate and the
    BLUE that the reference assembles (``reference/blue``) from the
    program's own rows with the frozen covariances, and between their
    error bars, in units of the reference's error bar.

The first judges the model evaluation (K2 for the Hodgkin-Huxley
family), the second the
combiner's sums and the estimator; between them they cover what a
request computes.

On R > 1 cards the problem is the port's sample mesh over the job
(``mesh="auto"``): each rank evaluates its own chunks of every call, and
the fetch's ``all_reduce`` adds the ranks' sums.  Each kept block then
carries the stream of its chunk; ``gather`` brings every rank's kept
blocks to rank 0 as host arrays, and the check pairs each chunk that it
follows with the blocks evaluated from that chunk's stream, on whichever
rank ran them.  So the check does not depend on how the program deals
chunks to ranks, and a chunk that no rank ran, that two ranks ran, or
whose rank's blocks are missing reads ``inf``; a rank's sums missing
from the ``all_reduce`` show in ``est_gap``.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from perfbench.reference import blue, streams

# the numbers of a request whose rows could not be followed
UNREAD = (("est_gap", math.inf), ("row_gap", math.inf))


def setup(ctx):
    prog = importlib.import_module("perfbench.programs." + ctx.cfg["family"])
    problem = prog.build(ctx.cfg, ctx.inputs, ctx.seed, ctx.device,
                         mesh="auto" if ctx.world > 1 else None)
    cell = ctx.cell
    problem.setup_solver(K=cell["K"], budget=cell["budget"])
    out = problem.MOSAP_output
    groups = [tuple(int(i) for i in g) for g in out["flattened_groups"]]
    samples = np.asarray(out["samples"]).astype(np.int64)
    active = [(g, int(n)) for g, n in zip(groups, samples) if n > 0]
    return {"problem": problem, "groups": groups, "samples": samples,
            "active": active, "calls": 0, "seen": 0, "kept": [],
            "rng": np.random.default_rng([int(ctx.seed), 11]), "ctx": ctx}


def request(state, i):
    """One estimate; returns its record (raises on failure)."""
    cell = state["ctx"].cell
    problem = state["problem"]
    base = state["calls"]
    state["calls"] += len(state["active"])
    problem.rows = []
    try:
        mus, errs, _cost = problem.solve(K=cell["K"], budget=cell["budget"])
    finally:
        rows, problem.rows = problem.rows, None
    mus = np.asarray(mus, dtype=float).ravel()
    errs = np.asarray(errs, dtype=float).ravel()
    if not (np.all(np.isfinite(mus)) and np.all(np.isfinite(errs))):
        raise FloatingPointError("non-finite estimate")
    rec = {"counter": base, "mus": mus, "errs": errs}
    if i >= 0:                      # the warm request is not checked
        _reservoir(state, dict(rec, rows=rows))
    return rec


def _reservoir(state, rec):
    """Keep a uniform sample of ``check_requests`` of the requests seen,
    drawn from the seed."""
    k = int(state["ctx"].cell.get("check_requests", 1))
    state["seen"] += 1
    if len(state["kept"]) < k:
        state["kept"].append(rec)
        return
    j = int(state["rng"].integers(0, state["seen"]))
    if j < k:
        state["kept"][j] = rec


def gather(state):
    """This rank's kept requests, in the reservoir's order, each (its
    first call counter, its blocks as (stream, models, outputs) with the
    outputs a host array); the blocks leave the card."""
    return [(rec["counter"], [(stream, key, out.cpu().numpy())
                              for key, out, stream in rec.pop("rows")])
            for rec in state["kept"]]


def release(state):
    """Drop the program's objects; keep what the check reads."""
    state.pop("problem", None)


def family(cfg):
    return importlib.import_module("perfbench.reference." + cfg["family"])


def replay(rows):
    """produce(ls, x) that hands out the program's kept rows in the order
    the engine computed them: one (n, No, len(ls)) block a group
    evaluation, as a coupled-group model computes them."""
    it = iter(rows)

    def produce(ls, x):
        key, out = next(it)
        if key != tuple(ls) or out.shape[0] != x.shape[0]:
            raise RuntimeError("the program's rows do not follow its "
                               "sampling contract")
        return out
    produce.left = lambda: sum(1 for _ in it)
    return produce


def paired(blocks):
    """produce(ls, x) that hands out the blocks, given by rank as
    ``gather`` returns them, that were evaluated from the stream of the
    chunk that ``follow`` draws from, in the order they were evaluated;
    ``produce.seen(draw)`` wraps ``draw`` so that it notes the stream."""
    by_stream = {}
    for rank_blocks in blocks:
        for stream, key, out in rank_blocks:
            by_stream.setdefault(stream, []).append((key, out))
    queues = {s: iter(v) for s, v in by_stream.items()}
    now = [None]

    def seen(draw):
        def noted(gen, n):
            now[0] = gen.initial_seed()
            return draw(gen, n)
        return noted

    def produce(ls, x):
        if now[0] not in queues:
            raise RuntimeError("no rank evaluated the chunk of stream %r"
                               % now[0])
        key, out = next(queues[now[0]])
        if key != tuple(ls) or out.shape[0] != x.shape[0]:
            raise RuntimeError("the program's rows do not follow its "
                               "sampling contract")
        return torch.from_numpy(out).to(x.device)
    produce.seen = seen
    # blocks that no followed chunk took: a chunk that two ranks ran, or
    # one that the request did not ask for
    produce.left = lambda: sum(1 for q in queues.values() for _ in q)
    return produce


def follow(state, counter, produce, batched=False):
    """[(group, calls, sums)] of the request whose first sampling call was
    ``counter``, its outputs given by ``produce`` (``batched``: see
    ``streams.follow``)."""
    ctx = state["ctx"]
    cfg = ctx.cfg
    fam = family(cfg)
    draw = fam.sampler(cfg, ctx.device)
    if hasattr(produce, "seen"):
        draw = produce.seen(draw)
    out = []
    for j, (g, n) in enumerate(state["active"]):
        calls, sums = streams.follow(g, n, ctx.seed, counter + j,
                                     cfg["device_batch_size"], ctx.device,
                                     draw, produce, fam.MAX_RESAMPLE,
                                     batched)
        out.append((g, calls, sums))
    return out


def row_gap(cfg, followed):
    """The largest gap of any followed row from the reference model's
    outputs (float64) on the same inputs, each output relative to the
    larger of its own magnitude in the reference and the median
    magnitude of that output over the group's rows; inf where one side is
    finite and the other not."""
    if cfg["model_dtype"] != "float64":
        raise ValueError("row_gap judges a float64 model; a model in less "
                         "needs a comparison of its own")
    fam = family(cfg)
    gap = 0.0
    for g, calls, _sums in followed:
        x = torch.cat([c[0] for c in calls])
        got = torch.cat([c[1] for c in calls]).to(torch.float64)
        ref = fam.group_outputs(cfg, g, x)
        fin = torch.isfinite(ref)
        if not torch.equal(torch.isfinite(got), fin):
            return math.inf
        fin = fin.flatten(1).all(dim=1)
        got, ref = got[fin], ref[fin]
        scale = torch.maximum(ref.abs(), ref.abs().median(dim=0).values
                              ).clamp_min(1e-300)
        gap = max(gap, float(((got - ref).abs() / scale).max()))
    return gap


def estimate_of(state, followed, dtype=np.float64):
    """(mus, errs) that the reference assembles from the followed sums,
    in ``dtype`` (float64 but for a control)."""
    ctx = state["ctx"]
    ref = state.setdefault("ref", {}).get(dtype)
    if ref is None:
        data = np.load(ctx.inputs)
        C = [data["C%d" % k] for k in range(ctx.cfg["n_outputs"])]
        ref = state["ref"][dtype] = blue.Groups(C, state["groups"], dtype)
    m = np.zeros(len(ref.groups))
    for g, n in zip(state["groups"], state["samples"]):
        m[ref.index[g]] = n
    sums = [[np.zeros(len(g)) for g in ref.groups]
            for _ in range(ctx.cfg["n_outputs"])]
    for g, _calls, s in followed:
        s = s.cpu().numpy()
        for o in range(len(sums)):
            sums[o][ref.index[g]] = s[o]
    mus, var = ref.estimate(m, sums)
    return mus, np.sqrt(var)


def compare(state, rec, produce):
    """[(name, value)] of one request whose rows ``replay`` gives."""
    try:
        followed = follow(state, rec["counter"], produce)
        left = produce.left()
    except (RuntimeError, StopIteration):
        return list(UNREAD)
    if left:
        return list(UNREAD)
    return judge(state, rec, followed)


def judge(state, rec, followed):
    """[(name, value)] of a request's estimate ``rec`` and its rows as
    ``follow`` gave them."""
    mus, errs = estimate_of(state, followed)
    est = float(np.max(np.maximum(np.abs(rec["mus"] - mus),
                                  np.abs(rec["errs"] - errs)) / errs))
    out = [("est_gap", est), ("row_gap", row_gap(state["ctx"].cfg,
                                                  followed))]
    return [(k, v if math.isfinite(v) else math.inf) for k, v in out]


def producers(state):
    """One produce a kept request: ``replay`` of its rows on one card;
    on R cards ``paired`` over every rank's blocks of that request (None
    where a rank's kept requests are not rank 0's)."""
    gathered = state.get("gathered")
    if gathered is None:
        return [replay(rec["rows"]) for rec in state["kept"]]
    out = []
    for j, rec in enumerate(state["kept"]):
        mine = [g[j] if j < len(g) else None for g in gathered]
        same = all(m is not None and m[0] == rec["counter"] for m in mine)
        out.append(paired([m[1] for m in mine]) if same else None)
    return out


def check(state, records, rng):
    """[(name, value)]: the worst of each number over the kept requests
    (``records`` and ``rng`` are unused: the reservoir drew them from the
    seed as the window ran)."""
    del records, rng
    worst = {}
    for rec, produce in zip(state["kept"], producers(state)):
        nums = UNREAD if produce is None else compare(state, rec, produce)
        for name, v in nums:
            worst[name] = max(worst.get(name, 0.0), v)
    if not worst:
        return list(UNREAD)
    return sorted(worst.items())
