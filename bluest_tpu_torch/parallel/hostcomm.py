"""Intra-group communicator for internally-parallel black-box models.

Copy of ``bluest_tpu/parallel/hostcomm.py`` (numpy only).

The reference lets a user model be *itself* MPI-parallel: ``get_comm()``
returns the communicator the sampling loop splits samples over, while the
model keeps its intra-group communicator for domain decomposition
(reference blue_models.py:121-130, demonstrated in
examples/paper_examples/restrictions_matern.py:19-37).  This module
gives that capability to *black-box* host models: the process
pool launches workers in groups of ``model_workers`` processes, every
rank of a group runs the same sampling loop on the same sample stream,
and the user's ``evaluate`` coordinates internally through the
``HostComm`` returned by ``problem.get_comm()``.

``HostComm`` implements the MPI subset the reference examples use --
``rank``/``size``, ``barrier``, ``bcast``, ``gather``, ``allgather``,
``allreduce`` -- over multiprocessing queues (one queue per ordered pair,
so SPMD-ordered collectives never cross-talk).  Large ndarray payloads
(>= 256 KiB -- PDE interface fields) bypass queue pickling through POSIX
shared memory: one memcpy per side instead of two pickle copies per hop.
``Split`` is not needed: the engine itself does the splitting into
groups.
"""

from __future__ import annotations

import operator
from functools import reduce
from typing import Any, List, Optional

import numpy as np

# payloads above this size bypass queue pickling via POSIX shared memory
# (a PDE model's interface field is O(MB); SimpleQueue pickles+copies it
# twice per hop, shm moves it with one memcpy each side)
_SHM_THRESHOLD_BYTES = 1 << 18


class _ShmHandle:
    """Pickled in place of a large ndarray; the receiver reconstructs
    and unlinks.  Ownership: exactly one receiver per handle (HostComm
    queues are one-directional point-to-point)."""

    __slots__ = ("name", "shape", "dtype")

    def __init__(self, name, shape, dtype):
        self.name = name
        self.shape = shape
        self.dtype = dtype


def _untrack(shm) -> None:
    """Hand segment ownership to the receiver: the creating process must
    not let its resource_tracker unlink the segment at exit (a sender
    that exits right after its last send would otherwise race the
    receiver's attach; and every send would log a 'leaked shared_memory'
    warning at shutdown).  The receiver unlinks explicitly."""
    try:                                         # pragma: no cover
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def _shm_wrap(obj: Any) -> Any:
    # sequence payloads too: gather/allgather/allreduce move LISTS of
    # arrays (bcast of the gathered list), which must not fall back to
    # double-pickling exactly on the large-payload collectives the fast
    # path exists for.  Exact-type check: tuple subclasses (namedtuples)
    # cannot be rebuilt from a generator and pickle fine as-is.
    if type(obj) in (list, tuple):
        return type(obj)(_shm_wrap(x) for x in obj)
    if (isinstance(obj, np.ndarray) and obj.nbytes >= _SHM_THRESHOLD_BYTES
            and not obj.dtype.hasobject):
        # hasobject (not just dtype == object): a structured dtype with
        # an object field holds PyObject pointers -- raw memcpy across
        # processes would reconstruct dangling pointers
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
        np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)[...] = obj
        handle = _ShmHandle(shm.name, obj.shape, obj.dtype)
        _untrack(shm)
        shm.close()          # the segment lives until the receiver unlinks
        return handle
    return obj


def _shm_unwrap(obj: Any) -> Any:
    if type(obj) in (list, tuple):
        return type(obj)(_shm_unwrap(x) for x in obj)
    if isinstance(obj, _ShmHandle):
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(name=obj.name)
        try:
            out = np.ndarray(obj.shape, obj.dtype,
                             buffer=shm.buf).copy()
        finally:
            shm.close()
            shm.unlink()
        return out
    return obj


class HostComm:
    """MPI-like communicator over multiprocessing queues.

    All members must call collectives in the same order (SPMD), exactly
    as with MPI.  Construct via :func:`make_group_comms`; instances are
    picklable into spawned children.
    """

    def __init__(self, rank: int, size: int, queues, barrier):
        self.rank = int(rank)
        self.size = int(size)
        self._q = queues           # _q[src][dst] one-directional queue
        self._barrier = barrier

    # mpi4py-style aliases
    def Get_rank(self) -> int:
        return self.rank

    def Get_size(self) -> int:
        return self.size

    def barrier(self) -> None:
        if self.size == 1:      # size-1 comms carry no barrier object
            return
        self._barrier.wait()

    Barrier = barrier

    def _send(self, obj: Any, dst: int) -> None:
        self._q[self.rank][dst].put(_shm_wrap(obj))

    def _recv(self, src: int) -> Any:
        return _shm_unwrap(self._q[src][self.rank].get())

    def bcast(self, obj: Any = None, root: int = 0) -> Any:
        if self.size == 1:
            return obj
        if self.rank == root:
            for dst in range(self.size):
                if dst != root:
                    self._send(obj, dst)
            return obj
        return self._recv(root)

    def gather(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        # the root's own slot is a COPY, matching mpi4py's pickle
        # round-trip: with the reference pattern `snap = comm.gather(u)`
        # followed by in-place updates of u, an aliased slot would make
        # rank root's snapshot silently track the live array while the
        # other ranks hold the old values -- rank-divergent SPMD state
        import copy
        if self.size == 1:
            return [copy.deepcopy(obj)]
        if self.rank != root:
            self._send(obj, root)
            return None
        out = []
        for src in range(self.size):
            out.append(copy.deepcopy(obj) if src == root
                       else self._recv(src))
        return out

    def allgather(self, obj: Any) -> List[Any]:
        return self.bcast(self.gather(obj, root=0), root=0)

    def allreduce(self, val: Any, op=operator.add) -> Any:
        vals = self.allgather(val)
        return reduce(op, vals[1:], vals[0])


def drain_stranded_shm(comm_groups) -> None:
    """Best-effort cleanup after an aborted run: unlink shared-memory
    segments whose handles are stranded in group queues.

    ``_untrack`` hands segment ownership to the receiver, so a payload
    sitting unconsumed in a queue when its receiver is terminated has NO
    automatic unlink path and would leak /dev/shm until reboot.  The
    engine calls this after terminating+joining a run's workers (no
    concurrent producers left)."""
    from multiprocessing import shared_memory

    def unlink(obj):
        if type(obj) in (list, tuple):
            for x in obj:
                unlink(x)
        elif isinstance(obj, _ShmHandle):
            try:
                shm = shared_memory.SharedMemory(name=obj.name)
                shm.close()
                shm.unlink()
            except Exception:
                pass

    def bounded_get(q, timeout=1.0):
        """q.get() with a hard timeout: a sender terminated mid-put
        leaves a TRUNCATED message in the pipe, so empty() is False but
        get() would block forever waiting for the missing bytes.  The
        abandoned daemon thread (and its queue) leak on timeout -- this
        only runs in abort cleanup, where a leaked thread beats a hang."""
        import threading
        box = []
        t = threading.Thread(target=lambda: box.append(q.get()),
                             daemon=True)
        t.start()
        t.join(timeout)
        if box:
            return True, box[0]
        return False, None

    for comms in comm_groups:
        queues = comms[0]._q if comms else None
        if not queues:
            continue
        for row in queues:
            for q in row:
                while q is not None:
                    try:
                        if q.empty():
                            break
                        ok, payload = bounded_get(q)
                        if not ok:
                            break               # truncated frame: abandon
                        unlink(payload)
                    except Exception:
                        break


def make_group_comms(size: int, ctx) -> List[HostComm]:
    """Build the ``size`` per-rank HostComm handles for one group.

    ``ctx`` is a multiprocessing context (spawn); the queue mesh and
    barrier are created in the parent and inherited by the children
    through Process args."""
    if size == 1:
        return [HostComm(0, 1, None, None)]
    queues = [[ctx.SimpleQueue() if src != dst else None
               for dst in range(size)] for src in range(size)]
    barrier = ctx.Barrier(size)
    return [HostComm(r, size, queues, barrier) for r in range(size)]
