"""Host-side sampling engine for black-box (non-torch) models.

Copy of ``bluest_tpu/sampling/host_engine.py`` (numpy only), importing
the port's ``progress`` and ``snapshots``.  It keeps the reference
blue_fn return contract (blue_fn.py:36-227) without MPI: batching
support probed from the sampler's signature, bounded resample-on-NaN/Inf,
wall-clock cost accumulation, and npz sample snapshots.  Models whose
sampler and evaluation are torch functions use the device engines
(``sampling/engine.py``, ``sampling/group_engine.py``); this path exists
so that any Python simulator keeps working unchanged, on the host.

Unlike the reference's per-sample accumulation loop, samples are staged
into windows and contracted with vectorized einsums (per-pair Python
inner products only when a user-supplied inner product is not the
standard dot)."""

from __future__ import annotations

import os
import sys
from inspect import signature
from time import time
from typing import Callable, List, Optional

import numpy as np

from . import snapshots


def is_output_finite(Ps):
    """(ok, model_index, output_index) -- reference blue_fn.py:15-29."""
    for i in range(len(Ps[0])):
        for n in range(len(Ps)):
            if not bool(np.all(np.isfinite(Ps[n][i]))):
                return False, i, n
    return True, None, None


def _is_standard_inner(fn) -> bool:
    """True when ``fn`` computes the scalar/dot inner product, enabling
    the einsum fast path (vector probe first: scalar `a*b` inners raise
    or return arrays on vectors, so they only pass the scalar probe)."""
    try:
        v = np.array([1.0, 2.0, -3.0])
        w = np.array([0.5, -1.0, 2.0])
        if np.ndim(fn(v, w)) == 0 and np.isclose(float(fn(v, w)), v @ w):
            return True
    except Exception:
        pass
    try:
        return np.isclose(float(fn(2.0, 3.0)), 6.0)
    except Exception:
        return False


from ..progress import Progress as _Progress  # shared ETA implementation


def _window_sums(vals, No, L, inners, fast, compute_diffs):
    """Contract one window of samples into (se, gram, d1, d2) increments.

    ``vals``: list of per-sample (No, L) nested values (entries scalar or
    array).  Vectorized einsums on the standard inner; per-pair calls on
    user-supplied inner products."""
    W = len(vals)
    se = [[0.0] * L for _ in range(No)]
    gram = [np.zeros((L, L)) for _ in range(No)]
    d1 = [[[0.0] * L for _ in range(L)] for _ in range(No)] \
        if compute_diffs else None
    d2 = [np.zeros((L, L)) for _ in range(No)] if compute_diffs else None

    for n in range(No):
        X = np.asarray([[vals[w][n][i] for i in range(L)]
                        for w in range(W)], dtype=float)
        if X.ndim == 2:
            X = X[..., None]                       # (W, L, d)
        sums = X.sum(axis=0)                       # (L, d)
        for i in range(L):
            se[n][i] = sums[i, 0] if sums.shape[1] == 1 else sums[i]
        if fast[n]:
            gram[n] += np.einsum('wid,wjd->ij', X, X)
        else:
            for w in range(W):
                row = [vals[w][n][i] for i in range(L)]
                gram[n] += np.array([[inners[n](row[i], row[j])
                                      for j in range(L)] for i in range(L)])
        if compute_diffs:
            D = X[:, :, None, :] - X[:, None, :, :]    # (W, L, L, d)
            Dsum = D.sum(axis=0)
            for i in range(L):
                for j in range(L):
                    d1[n][i][j] = (Dsum[i, j, 0] if Dsum.shape[-1] == 1
                                   else Dsum[i, j])
            if fast[n]:
                d2[n] += np.einsum('wijd,wijd->ij', D, D)
            else:
                for w in range(W):
                    row = [vals[w][n][i] for i in range(L)]
                    for i in range(L):
                        for j in range(L):
                            dd = row[i] - row[j]
                            d2[n][i, j] += inners[n](dd, dd)
    return se, gram, d1, d2


def blue_fn(ls, N, problem, sampler=None, inners=None, comm=None,
            N1: int = 1, No: int = 1, verbose: bool = True,
            compute_mlmc_differences: bool = False,
            filename: Optional[str] = None, outputs_to_save=None):
    """Sample the coupled models ``ls`` N times and return sums.

    ``comm`` is accepted for reference API compatibility and ignored.

    Returns (sumse, sumsc, cost[, sumsd1, sumsd2]):
        sumse[n][i]   = sum of outputs of model ls[i], output n
        sumsc[n][i,j] = sum of inner products
        cost          = problem.cost * N if defined, else wall time
    (return contract of reference blue_fn.py:36-227)."""
    L = len(ls)
    N = int(N)
    if inners is None:
        inners = [lambda a, b: a * b for _ in range(No)]
    fast = [_is_standard_inner(f) for f in inners]

    if sampler is None:
        rng = np.random.RandomState(1)
        # reference convention (blue_fn.py:85-89): under a batched loop
        # (N1 > 1) EVERY chunk must return length-N sequences -- the
        # accumulation indexes Ps[n][i][w] even on an N % N1 == 1
        # remainder chunk, where a bare float would crash it
        want_batch = int(N1) > 1

        def sampler(ls, N=1):
            draw = (rng.randn(N) if (N > 1 or want_batch)
                    else float(rng.randn()))
            return [draw for _ in ls]

    batched = len(signature(sampler).parameters) > 1
    B = max(int(N1), 1) if batched else 1

    snap = filename is not None
    snap_vals: List = []
    snap_inputs: List[List] = [[] for _ in range(L)]

    se_acc = [[0.0] * L for _ in range(No)]
    gram_acc = [np.zeros((L, L)) for _ in range(No)]
    d1_acc = [[[0.0] * L for _ in range(L)] for _ in range(No)]
    d2_acc = [np.zeros((L, L)) for _ in range(No)]
    wall = 0.0
    window: List = []
    window_cap = max(B, 256)
    prog = _Progress(str(list(ls)), N, verbose)

    def flush():
        if not window:
            return
        se, gram, d1, d2 = _window_sums(window, No, L, inners, fast,
                                        compute_mlmc_differences)
        for n in range(No):
            for i in range(L):
                se_acc[n][i] = se_acc[n][i] + se[n][i]
            gram_acc[n] += gram[n]
            if compute_mlmc_differences:
                d2_acc[n] += d2[n]
                for i in range(L):
                    for j in range(L):
                        d1_acc[n][i][j] = d1_acc[n][i][j] + d1[n][i][j]
        window.clear()

    # bounded resampling (reference blue_fn.py:118-129 loops forever --
    # a model that always fails would hang the run; see README
    # divergences).  The host contract still delivers N finite samples,
    # so exhausting the retry budget on ONE draw is a loud error, not a
    # silent drop.
    max_retry = max(int(getattr(problem, "params", {})
                        .get("max_resample", 64) or 64), 1)
    accepted = 0
    while accepted < N:
        n2 = min(B, N - accepted) if batched else 1
        for attempt in range(max_retry + 1):
            inp = sampler(ls, n2) if batched else sampler(ls)
            t0 = time()
            Ps = problem.evaluate(ls, inp)
            wall += time() - t0
            ok, bad_model, bad_output = is_output_finite(Ps)
            if ok:
                break
            if verbose:
                print("Warning! evaluation returned non-finite value for "
                      "model %s output %s; resampling."
                      % (bad_model, bad_output), flush=True)
        else:
            raise RuntimeError(
                "evaluation of models %s returned non-finite output for "
                "%d consecutive attempts (last failure: model index %s, "
                "output %s); raise params['max_resample'] if the model "
                "legitimately fails this often" %
                (list(ls), max_retry + 1, bad_model, bad_output))

        if batched and B > 1:
            # batch convention: Ps[n][i] is a length-n2 sequence
            for w in range(n2):
                window.append([[Ps[n][i][w] for i in range(L)]
                               for n in range(No)])
            if snap:
                for w in range(n2):
                    snap_vals.append([[Ps[n][i][w] for i in range(L)]
                                      for n in range(No)])
                    for i in range(L):
                        snap_inputs[i].append(inp[i][w])
        else:
            window.append([[Ps[n][i] for i in range(L)]
                           for n in range(No)])
            if snap:
                snap_vals.append([[Ps[n][i] for i in range(L)]
                                  for n in range(No)])
                for i in range(L):
                    snap_inputs[i].append(inp[i])
        accepted += n2
        if len(window) >= window_cap:
            flush()
        prog.update(accepted)
    flush()
    prog.update(accepted, force=True)

    cost = N * problem.cost if hasattr(problem, "cost") else wall

    if snap:
        snapshots.append_snapshots(
            filename, ls, No, np.asarray(snap_vals, dtype=object),
            None, outputs_to_save=outputs_to_save,
            per_model_inputs=[np.asarray(x) for x in snap_inputs])

    sumse = se_acc
    sumsc = gram_acc
    if compute_mlmc_differences:
        return sumse, sumsc, cost, d1_acc, d2_acc
    return sumse, sumsc, cost


# --------------------------------------------------------------------- #
# Parallel host sampling: restores the reference's `mpiexec -n P` sampling
# throughput for black-box models on a single node with a process pool
# (static split of N plus remainder, exactly blue_fn.py:106-110; partial
# sums merged like the allreduce at blue_fn.py:179-187).
# --------------------------------------------------------------------- #

def _worker_chunk(args):
    (problem, ls, n, worker_id, No, compute_diffs,
     filename, outputs_to_save) = args
    problem.set_worker_id(worker_id)  # per-rank RNG hook
    # honor sample_batch_size in the workers too: a vectorized black-box
    # evaluate amortizing setup over the batch would otherwise silently
    # degrade to one call per sample (the serial path plumbs N1 already)
    n1 = int(getattr(problem, "params", {}).get("sample_batch_size", 1) or 1)
    return blue_fn(ls, n, problem, sampler=problem.sampler,
                   inners=problem.get_models_inner_products(),
                   No=No, N1=n1, verbose=False,
                   compute_mlmc_differences=compute_diffs,
                   filename=filename, outputs_to_save=outputs_to_save)


def _worker_snapfile(filename, wid):
    # split only the basename's extension: 'run.v2/snap.npz' must become
    # 'run.v2/snap.w0.npz', and an extensionless 'snap' must not turn
    # into the hidden file '.w0.snap'
    head, tail = os.path.split(filename)
    base, ext = os.path.splitext(tail)
    return os.path.join(head, base + (".w%d" % wid) + ext)


def _clear_stale_worker_snapshots(filename, ls, n_workers):
    """Remove worker snapshot files left behind by a crashed prior run.

    A stale ``.wN.`` file would be appended to by the new run's worker and
    then merged, double-counting the aborted run's samples."""
    for wid in range(n_workers):
        wname = snapshots.snapshot_filename(_worker_snapfile(filename, wid),
                                            ls)
        if os.path.isfile(wname):
            os.remove(wname)


def _group_member(problem, ls, n, group_id, comm, out_queue, No,
                  compute_diffs, filename, outputs_to_save):
    """One rank of a model group: every rank runs the same sampling loop
    on the same (group-seeded) sample stream; the user's evaluate
    coordinates its ranks through problem.get_comm().  Only rank 0's sums
    are reported (the others' are duplicates by construction), and only
    rank 0 writes snapshots."""
    problem._host_comm = comm
    try:
        res = _worker_chunk((problem, ls, n, group_id, No, compute_diffs,
                             filename if comm.rank == 0 else None,
                             outputs_to_save))
        if comm.rank == 0:
            out_queue.put((group_id, res))
    except BaseException as exc:                    # pragma: no cover
        if comm.rank == 0:
            out_queue.put((group_id, exc))
        raise


def blue_fn_parallel(ls, N, problem, n_workers: int, No: int = 1,
                     compute_mlmc_differences: bool = False,
                     model_workers: int = 1,
                     filename: Optional[str] = None,
                     outputs_to_save=None):
    """Process-pool variant of blue_fn for picklable black-box problems.

    The user's sampler MUST be reseeded per worker by overriding
    ``set_worker_id(self, wid)`` (the reference's per-rank RNG discipline,
    tutorials/01_tutorial.py:154-167): every worker unpickles the same RNG
    state, so without reseeding all workers draw identical samples and the
    estimator silently runs on N/n_workers effective samples.

    ``filename`` streams sample snapshots: each sample-stream leader
    writes its own npz and the parent merges them into the target file,
    exactly the reference's per-rank write + rank-0 merge
    (blue_fn.py:189-222).

    ``model_workers > 1`` restores the reference's *nested* parallelism
    for internally-parallel black-box models (blue_models.py:121-130,
    restrictions_matern.py:19-37): samples are split over ``n_workers``
    groups of ``model_workers`` processes each; within a group every rank
    runs the same sample stream (``set_worker_id`` receives the group id)
    and the user's ``evaluate`` coordinates its ranks through the
    ``HostComm`` returned by ``problem.get_comm()``.
    """
    import multiprocessing as mp

    if not hasattr(problem, "set_worker_id"):
        raise ValueError(
            "host_workers > 1 requires the problem to implement "
            "set_worker_id(worker_id) to reseed its RNG per worker; "
            "without it all workers would draw identical sample streams "
            "and the estimate would be statistically invalid.")

    NN = [N // n_workers] * n_workers
    for i in range(N % n_workers):
        NN[i] += 1
    ctx = mp.get_context("spawn")
    if filename is not None:
        _clear_stale_worker_snapshots(filename, ls, n_workers)

    if model_workers > 1:
        from ..parallel.hostcomm import (make_group_comms,
                                         drain_stranded_shm)
        import queue as _queue
        out_queue = ctx.Queue()   # Queue (not SimpleQueue): get(timeout)
        # lets the parent poll child liveness -- a crash on a non-rank-0
        # group member would otherwise deadlock rank 0 in a collective
        # and the parent in a blocking get forever
        procs = []
        all_comms = []   # keep queue/barrier handles alive until join:
        # spawned children attach to the named semaphores lazily (torch/numpy
        # imports take seconds), and the parent dropping its references
        # first unlinks them out from under the unpickler
        active = [(gid, n) for gid, n in enumerate(NN) if n > 0]
        group_procs = {}
        for gid, n in active:
            comms = make_group_comms(model_workers, ctx)
            all_comms.append(comms)
            wf = (_worker_snapfile(filename, gid)
                  if filename is not None else None)
            group_procs[gid] = []
            for r in range(model_workers):
                p = ctx.Process(target=_group_member,
                                args=(problem, ls, n, gid, comms[r],
                                      out_queue, No,
                                      compute_mlmc_differences,
                                      wf, outputs_to_save))
                p.start()
                procs.append(p)
                group_procs[gid].append(p)
        def _abort():
            # terminate+join BEFORE draining: drain_stranded_shm needs
            # no concurrent producers on the group queues
            for p in procs:
                p.terminate()
            for p in procs:
                p.join()
            drain_stranded_shm(all_comms)

        results = []
        done_gids = set()
        while len(results) < len(active):
            try:
                gid, res = out_queue.get(timeout=5.0)
            except _queue.Empty:
                # fatal only when a *pending* group lost a member --
                # a worker dying after its group already reported must
                # not abort the remaining healthy groups
                dead = [(g, p) for g, ps in group_procs.items()
                        if g not in done_gids for p in ps
                        if not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    # prefer the real exception if rank 0 managed to
                    # report it before dying
                    try:
                        gid, res = out_queue.get(timeout=1.0)
                        if isinstance(res, BaseException):
                            _abort()
                            raise res
                        done_gids.add(gid)
                        results.append(res)
                        continue
                    except _queue.Empty:
                        pass
                    _abort()
                    raise RuntimeError(
                        "model-group %d worker died with exit code %s; "
                        "sampling aborted (an exception on a non-rank-0 "
                        "group member, or an OOM kill, deadlocks its "
                        "group's collectives)"
                        % (dead[0][0], dead[0][1].exitcode))
                continue
            if isinstance(res, BaseException):
                _abort()
                raise res
            done_gids.add(gid)
            results.append(res)
        for p in procs:
            p.join()
        drain_stranded_shm(all_comms)   # belt-and-braces on clean exit
    else:
        jobs = [(problem, ls, n, wid, No, compute_mlmc_differences,
                 _worker_snapfile(filename, wid)
                 if filename is not None else None, outputs_to_save)
                for wid, n in enumerate(NN) if n > 0]
        with ctx.Pool(processes=len(jobs)) as pool:
            results = pool.map(_worker_chunk, jobs)

    if filename is not None:
        snapshots.merge_snapshot_files(
            filename, ls,
            [_worker_snapfile(filename, wid)
             for wid, n in enumerate(NN) if n > 0])

    out = list(results[0])
    for r in results[1:]:
        for n in range(No):
            for i in range(len(ls)):
                out[0][n][i] += r[0][n][i]
            out[1][n] = out[1][n] + r[1][n]
            if compute_mlmc_differences:
                # FULL matrices: the serial path fills both triangles, so
                # an upper-only merge would leave the lower triangle and
                # diagonal holding one worker's partial sums
                for i in range(len(ls)):
                    for j in range(len(ls)):
                        out[3][n][i][j] += r[3][n][i][j]
                        out[4][n][i][j] += r[4][n][i][j]
        out[2] += r[2]
    return tuple(out)
