"""Sample snapshot persistence in the reference npz format.

Copy of ``bluest_tpu/sampling/snapshots.py`` (numpy only): a file written
by either package reads the same in both.

Reference blue_fn streams every model output and input sample to npz files
named ``basename + ''.join(models) + ext`` and appends across runs with
consistency checks (blue_fn.py:97-104, 189-222).  The host engine writes
these inline; the device engine collects outputs on device and hands them
here in bulk.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import threading
from typing import List, Optional, Sequence

import numpy as np


def snapshot_filename(filename: str, ls: Sequence[int]) -> str:
    """Reference naming: basename + ''.join(models) + ext
    (blue_fn.py:98-101).  Split only the BASENAME's extension: a dotted
    parent directory ('run.v2/samples') or an extensionless name
    ('samples' -> 'samples01', not '01.samples') must survive."""
    head, tail = os.path.split(filename)
    base, ext = os.path.splitext(tail)
    return os.path.join(head, base + "".join(str(l) for l in ls) + ext)


def append_snapshots(filename: str, ls: Sequence[int], No: int,
                     values: np.ndarray, inputs,
                     outputs_to_save: Optional[Sequence[int]] = None,
                     per_model_inputs: Optional[List] = None) -> str:
    """Append a block of samples to the snapshot file for group ``ls``.

    values: (N, No, L) model outputs; inputs: (N, ...) raw random inputs
    shared by all models of the group (device engines), OR
    ``per_model_inputs``: per-model list of length-N input arrays (host
    engine, where each model receives its own sample representation).
    Returns the resolved filename."""
    fname = snapshot_filename(filename, ls)
    L = len(ls)
    N = values.shape[0]
    if N == 0:
        # every attempted row was non-finite: nothing to persist (and
        # reshape(0, -1) below would raise on the ambiguous -1)
        return fname
    if outputs_to_save is None:
        outputs_to_save = list(range(No))

    out = {}
    for n in range(No):
        if n in outputs_to_save:
            for i in range(L):
                # array slice, NOT a per-row list: boxing every row as a
                # Python object multiplies peak memory several-fold on
                # runs just under the spill threshold (_cat and
                # _savez_streaming handle ndarrays natively)
                out["values_%d_%d" % (n, i)] = values[:, n, i]
    if per_model_inputs is not None:
        for i in range(L):
            out["inputs_%d" % i] = per_model_inputs[i]
    else:
        flat_inputs = np.asarray(inputs).reshape(N, -1)
        for i in range(L):
            out["inputs_%d" % i] = flat_inputs
    _merge_and_write(fname, ls, No, out, N)
    return fname


def _cat(a, b):
    """Append new column data ``b`` to an existing column ``a``.  Regular
    arrays concatenate without per-row Python objects (the XL path);
    object/ragged data falls back to the historical list semantics."""
    if b is None or len(b) == 0:
        return np.asanyarray(a)
    a_arr = np.asanyarray(a)
    try:
        b_arr = np.asanyarray(b)
        if (a_arr.dtype != object and b_arr.dtype != object
                and a_arr.ndim >= 1 and b_arr.ndim >= 1
                and a_arr.shape[1:] == b_arr.shape[1:]):
            return np.concatenate([a_arr, b_arr])
    except ValueError:
        pass
    return [item for item in a_arr] + [item for item in b]


def _savez_streaming(fname: str, mapping: dict) -> None:
    """``np.savez_compressed`` with two memory-bounding twists: dict
    values may be callables materialized one at a time (so an append
    only ever holds ONE merged column in memory), and the write goes to
    a temp file + atomic replace (a crash mid-write must not destroy
    prior runs' data).  Output is a standard npz."""
    import zipfile

    from numpy.lib import format as npformat

    tmp = fname + ".tmp.npz"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED,
                         allowZip64=True) as zf:
        for key, val in mapping.items():
            v = val() if callable(val) else val
            try:
                arr = np.asanyarray(v)
            except ValueError:
                # ragged list semantics (historical _cat fallback):
                # numpy >= 1.24 refuses the implicit object promotion,
                # so build the object array explicitly
                arr = np.empty(len(v), dtype=object)
                arr[:] = v
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                npformat.write_array(fid, arr, allow_pickle=True)
    os.replace(tmp, fname)


def _merge_and_write(fname: str, ls: Sequence[int], No: int, out: dict,
                     N: int) -> None:
    """Merge a block of new columns with an existing snapshot file (if
    any) and write the compressed npz.  ``out`` holds only the data
    columns (values_*/inputs_*); metadata is stamped here.  Columns are
    merged and written one at a time, so appending an XL spooled run
    peaks at one column of memory, not the whole run."""
    meta = {"models": np.array([list(ls)]),
            "n_samples": np.array([N]),
            "n_outputs": np.array([No])}
    if not os.path.isfile(fname):
        _savez_streaming(fname, {**out, **meta})
        return
    old = np.load(fname, allow_pickle=True)
    try:
        if list(np.asarray(old["models"][0])) != list(ls):
            # e.g. a samplefile reused across studies where two groups'
            # digit strings collide ((1,12) vs (11,2) -> 'samples112');
            # must survive python -O, so no assert
            raise ValueError(
                "snapshot file %s holds models %s, not %s; use a fresh "
                "samplefile" % (fname, list(np.asarray(old["models"][0])),
                                list(ls)))
        old_keys = {k for k in old.files if "values" in k or "inputs" in k}
        if old_keys != set(out):
            # appending with a different outputs_to_save filter would grow
            # only the shared columns, silently misassociating rows across
            # columns on later reads (same guard as merge_snapshot_files)
            raise ValueError(
                "snapshot file %s was written with a different "
                "outputs_to_save filter than this run (%s vs %s); "
                "use a fresh samplefile" %
                (fname, sorted(old_keys), sorted(out)))
        meta["n_samples"] = np.array([int(np.asarray(
            old["n_samples"]).ravel()[0]) + N])
        cols = {k: (lambda k=k: _cat(old[k], out.get(k)))
                for k in old.files if "values" in k or "inputs" in k}
        _savez_streaming(fname, {**cols, **meta})
    finally:
        old.close()


class SnapshotSpool:
    """Asynchronous disk spool for snapshot chunks on XL collection runs.

    The chunked group-engine collector accumulates every chunk's valid
    outputs + inputs on the host before the single npz append; at 1e7+
    samples that is gigabytes of host memory held for the whole run.
    The spool instead streams each chunk to per-column binary files in a
    temp directory from a writer thread (overlapping disk I/O with the
    device sampling of the next chunk), then exposes the columns as
    read-only memmaps so the final compressed-npz write pages data in
    a bounded window instead of materializing the run.

    Reference parity note: the reference streams snapshots inline per
    batch (blue_fn.py:133-145) with O(run) memory in its npz append;
    this is the device engines' memory-bounded analog.
    """

    def __init__(self, No: int, L: int,
                 outputs_to_save: Optional[Sequence[int]] = None,
                 tmpdir: Optional[str] = None, max_pending: int = 4):
        self.No, self.L = int(No), int(L)
        # dedup while keeping order: a duplicate entry would write the
        # column twice per chunk while rows counts it once -- finish()'s
        # memmap would then read misaligned rows (append_snapshots'
        # membership test is naturally dedup'd; match it)
        self.outputs = (list(range(No)) if outputs_to_save is None
                        else list(dict.fromkeys(
                            n for n in outputs_to_save if 0 <= n < No)))
        self.dir = tempfile.mkdtemp(prefix="bluest_snapspool_", dir=tmpdir)
        self.rows = 0
        self._meta = {}            # key -> (dtype, trailing_shape)
        self._err = None
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------ producer -------------------------- #

    def append(self, values: np.ndarray, inputs: np.ndarray) -> None:
        """Queue one chunk: values (n, No, L[, d]), inputs (n, ...)."""
        if self._err is not None:
            raise self._err
        values = np.asarray(values)
        inputs = np.asarray(inputs)
        if values.shape[0] != inputs.shape[0]:
            raise ValueError("values/inputs row mismatch")
        if values.shape[0] == 0:
            # a chunk whose rows were all non-finite: nothing to spool
            # (reshape(0, -1) below would raise on the ambiguous -1)
            return
        self._q.put((values, inputs))
        self.rows += int(values.shape[0])

    # ------------------------------ writer ---------------------------- #

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._err is not None:
                    continue           # drain after failure
                values, inputs = item
                n = values.shape[0]
                for no in self.outputs:
                    for i in range(self.L):
                        self._write("values_%d_%d" % (no, i),
                                    values[:, no, i])
                self._write("inputs", inputs.reshape(n, -1))
            except BaseException as e:   # surfaced on finish()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, key: str, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        meta = (arr.dtype, arr.shape[1:])
        if key not in self._meta:
            self._meta[key] = meta
        elif self._meta[key] != meta:
            raise ValueError("inconsistent chunk layout for %s: %r vs %r"
                             % (key, self._meta[key], meta))
        with open(os.path.join(self.dir, key + ".bin"), "ab") as f:
            arr.tofile(f)

    # ------------------------------ consumer -------------------------- #

    def _shutdown(self):
        """Stop the writer thread (idempotent): drain + sentinel + join."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()

    def finish(self) -> dict:
        """Join the writer and return {key: read-only memmap} with keys
        ``values_<n>_<i>`` plus ``inputs``, each (rows, *trailing)."""
        self._shutdown()
        if self._err is not None:
            raise self._err
        cols = {}
        for key, (dtype, trail) in self._meta.items():
            path = os.path.join(self.dir, key + ".bin")
            if self.rows == 0:
                cols[key] = np.empty((0,) + tuple(trail), dtype=dtype)
            else:
                cols[key] = np.memmap(path, dtype=dtype, mode="r",
                                      shape=(self.rows,) + tuple(trail))
        return cols

    def cleanup(self):
        """Delete the spool directory (after the npz write, or on an
        aborted run).  Joins the writer thread first so no in-flight
        write races the removal or leaks a blocked daemon thread."""
        self._shutdown()
        shutil.rmtree(self.dir, ignore_errors=True)


class CollectSink:
    """Accumulate collected snapshot chunks, spilling to a
    :class:`SnapshotSpool` once the projected run volume crosses a
    threshold.  Fed by ``BLUEProblem._collect_run``'s piece loop for both
    device engines, so every snapshot path is memory-bounded the same
    way.

    ``add`` takes each chunk's valid rows plus the number of rows the
    chunk *attempted* (>= valid), which anchors the projection of the
    total run volume; the spill decision is re-evaluated every chunk and
    already-accumulated chunks migrate into the spool when it trips.
    """

    def __init__(self, No: int, L: int, N_expected: int,
                 spill_bytes,
                 outputs_to_save: Optional[Sequence[int]] = None,
                 tmpdir: Optional[str] = None):
        self.No, self.L = int(No), int(L)
        self.N = max(int(N_expected), 1)
        # float, or a zero-arg callable re-read at every add (lets env
        # overrides take effect mid-run and keeps tests riggable)
        self.spill_bytes = spill_bytes
        self.outputs_to_save = outputs_to_save
        self.tmpdir = tmpdir
        self.rows_attempted = 0
        self.acc_bytes = 0
        self.vals: List[np.ndarray] = []
        self.inputs: List[np.ndarray] = []
        self.spool: Optional[SnapshotSpool] = None

    def add(self, vals: np.ndarray, inputs: np.ndarray,
            attempted_rows: Optional[int] = None) -> None:
        vals = np.asarray(vals)
        inputs = np.asarray(inputs)
        n_att = int(attempted_rows if attempted_rows is not None
                    else vals.shape[0])
        self.rows_attempted += max(n_att, vals.shape[0])
        if self.spool is None:
            chunk_bytes = vals.nbytes + inputs.nbytes
            # projection never shrinks below the bytes actually held:
            # a sink reused past its N_expected (the shared top-up sink
            # spans up to 4 resample rounds) must keep its memory bound
            projected = ((self.acc_bytes + chunk_bytes)
                         * max(self.N / max(self.rows_attempted, 1), 1.0))
            thr = (self.spill_bytes() if callable(self.spill_bytes)
                   else float(self.spill_bytes))
            if projected > thr:
                self.spool = SnapshotSpool(
                    self.No, self.L, outputs_to_save=self.outputs_to_save,
                    tmpdir=self.tmpdir)
                for v, x in zip(self.vals, self.inputs):
                    self.spool.append(v, x)
                self.vals, self.inputs = [], []
            else:
                self.acc_bytes += chunk_bytes
        if self.spool is not None:
            self.spool.append(vals, inputs)
        else:
            self.vals.append(vals)
            self.inputs.append(inputs)

    def write(self, filename: str, ls: Sequence[int]) -> None:
        """Append everything collected to the snapshot file and release
        the spool (if any)."""
        try:
            if self.spool is not None:
                append_spooled_snapshots(filename, ls, self.No, self.spool)
            elif self.vals:
                append_snapshots(filename, ls, self.No,
                                 np.concatenate(self.vals),
                                 np.concatenate(self.inputs),
                                 outputs_to_save=self.outputs_to_save)
        finally:
            self.close()

    def close(self) -> None:
        """Release spool resources (idempotent; safe on aborted runs)."""
        if self.spool is not None:
            self.spool.cleanup()
            self.spool = None
        self.vals, self.inputs = [], []


class NullSink:
    """Sink for non-zero processes in a multi-process run: the engine's
    replicating gather hands every process the full snapshot rows, but
    only process 0 persists them (the reference's rank-0 write,
    blue_fn.py:189-222) -- on a shared filesystem concurrent appends to
    the same npz would race."""

    def add(self, vals, inputs, attempted_rows=None) -> None:
        pass

    def write(self, filename, ls) -> None:
        pass

    def close(self) -> None:
        pass


def append_spooled_snapshots(filename: str, ls: Sequence[int], No: int,
                             spool: SnapshotSpool) -> Optional[str]:
    """Append a finished :class:`SnapshotSpool` to the snapshot file for
    group ``ls`` -- the memory-bounded analog of :func:`append_snapshots`
    (the npz write streams from the spool's memmaps)."""
    cols = spool.finish()
    if spool.rows == 0:
        return None
    fname = snapshot_filename(filename, ls)
    out = {k: v for k, v in cols.items() if k.startswith("values_")}
    for i in range(spool.L):
        out["inputs_%d" % i] = cols["inputs"]
    _merge_and_write(fname, ls, No, out, spool.rows)
    return fname


def merge_snapshot_files(filename: str, ls: Sequence[int],
                         worker_files: Sequence[str]) -> Optional[str]:
    """Merge per-worker snapshot files into the target file for group
    ``ls`` and delete them -- the parallel host engine's analog of the
    reference's per-rank npz merge on rank 0 (blue_fn.py:189-222)."""
    fname = snapshot_filename(filename, ls)
    # open every source lazily (npz decompresses per key access), check
    # consistency up front, then merge COLUMN AT A TIME through the
    # streaming writer -- materializing every worker file as per-row
    # Python lists was O(total run) host memory with object overhead,
    # the one unbounded path left in this module.  Worker files are
    # deleted only after the merged file is written: a mid-merge failure
    # must never lose data.
    sources = []
    if os.path.isfile(fname):
        sources.append((None, np.load(fname, allow_pickle=True)))
    for wf in worker_files:
        wname = snapshot_filename(wf, ls)
        if os.path.isfile(wname):
            sources.append((wname, np.load(wname, allow_pickle=True)))
    if not sources:
        return None

    def data_keys(dd):
        return {k for k in dd.files if "values" in k or "inputs" in k}

    try:
        keys = data_keys(sources[0][1])
        total_n = 0
        for wname, d in sources:
            if list(np.asarray(d["models"][0])) != list(ls):
                # must survive python -O: no assert (digit-string name
                # collisions like (1,12) vs (11,2) land here)
                raise ValueError(
                    "snapshot file %s holds models %s, not %s"
                    % (wname or fname,
                       list(np.asarray(d["models"][0])), list(ls)))
            if data_keys(d) != keys:
                # a different outputs_to_save filter would leave per-key
                # columns of different lengths with no alignment
                # metadata -- silent misassociation of outputs/inputs.
                # The per-worker files are preserved (nothing deleted).
                raise ValueError(
                    "snapshot file %s was written with a different "
                    "outputs_to_save filter than this run (%s vs %s); "
                    "use a fresh samplefile" %
                    (fname, sorted(keys), sorted(data_keys(d))))
            total_n += int(np.asarray(d["n_samples"]).ravel()[0])

        def col(k):
            acc = sources[0][1][k]
            for _, d in sources[1:]:
                acc = _cat(acc, d[k])
            return acc

        cols = {k: (lambda k=k: col(k)) for k in sorted(keys)}
        meta = {"models": np.array([list(ls)]),
                "n_samples": np.array([total_n]),
                "n_outputs": np.asarray(sources[0][1]["n_outputs"])}
        _savez_streaming(fname, {**cols, **meta})
    finally:
        for _, d in sources:
            d.close()
    for wname, _ in sources:
        if wname is not None:
            os.remove(wname)
    return fname
