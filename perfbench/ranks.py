"""A cell on R > 1 cards: R processes, one a card, as one job.

``python3 perfbench/run.py --workload <cell> ...`` of a cell whose
``chips`` is R > 1 becomes rank 0.  It starts R - 1 children of the same
command, each with ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` in its environment (the port is the
one rank 0's store bound), and watches them: a child that ends with a
code other than 0 before the run is done ends the whole run, its other
children first.  A child dies with rank 0 (``PR_SET_PDEATHSIG``), so a
rank 0 that is killed leaves no child behind.

The harness (``harness.run_cell``) makes every rank join one process
group before the request kind's set-up (``nccl`` on cards, ``gloo`` on
the host), and holds the ranks together through a second group over
``gloo`` on host tensors: the barrier after set-up, rank 0's go or stop
before each request, and the gathers after the window.  That group puts
no item on a card's trace and reads nothing back from a card.

Every collective and the store wait at most ``TIMEOUT`` for the other
ranks: a rank that hangs makes the others raise.  Nothing here is
imported on the path of a cell on one card.
"""

from __future__ import annotations

import datetime
import os
import signal
import subprocess
import sys
import threading

import torch
import torch.distributed as dist

ADDR = "127.0.0.1"
TIMEOUT = datetime.timedelta(seconds=120)
RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "run.py")
PARENT = "PERFBENCH_PARENT"     # set in a child: rank 0's process id


def _die_with_parent(ppid: int):
    """Have the kernel kill this process when its parent ends."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(1, signal.SIGKILL) != 0:          # PR_SET_PDEATHSIG
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != ppid:        # the parent ended before the call
        os._exit(6)


class Ranks:
    """This process's place in a cell on ``world`` cards."""

    def __init__(self, world: int):
        self.world = int(world)
        self.rank = self.local_rank = 0
        self.store = None
        self.ctl = None
        self._procs = []
        self._watchers = []
        self._stopping = False
        if PARENT in os.environ:        # a child that rank 0 started
            _die_with_parent(int(os.environ[PARENT]))
            self.rank = int(os.environ["RANK"])
            self.local_rank = int(os.environ["LOCAL_RANK"])
            if int(os.environ["WORLD_SIZE"]) != self.world:
                raise ValueError("WORLD_SIZE %s, the cell asks for %d" % (
                    os.environ["WORLD_SIZE"], self.world))

    def launch(self, argv):
        """Rank 0: bind the store and start the other ranks with the
        command's own arguments ``argv``."""
        if self.rank:
            return
        self.store = dist.TCPStore(ADDR, 0, self.world, True,
                                   timeout=TIMEOUT, wait_for_workers=False)
        for r in range(1, self.world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(self.world), MASTER_ADDR=ADDR,
                       MASTER_PORT=str(self.store.port),
                       **{PARENT: str(os.getpid())})
            # a child's standard output goes to standard error: the last
            # line of standard output is rank 0's result alone
            proc = subprocess.Popen([sys.executable, RUN] + list(argv),
                                    env=env, stdout=2,
                                    start_new_session=True)
            self._procs.append(proc)
            t = threading.Thread(target=self._watch, args=(r, proc),
                                 daemon=True)
            t.start()
            self._watchers.append(t)

    def _watch(self, r, proc):
        code = proc.wait()
        if code != 0 and not self._stopping:
            print("rank %d ended with code %d: ending the run" % (r, code),
                  file=sys.stderr, flush=True)
            self._stopping = True
            self._kill()
            os._exit(5)

    def _kill(self):
        for proc in self._procs:
            try:        # its session: nvcc or workers that it started too
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        for proc in self._procs:
            proc.wait()

    def join_group(self, device: str):
        """Join the process group; returns (rank, world, group) for the
        request kind."""
        backend = "nccl" if device.startswith("cuda") else "gloo"
        if self.store is None:
            self.store = dist.TCPStore(os.environ["MASTER_ADDR"],
                                       int(os.environ["MASTER_PORT"]),
                                       self.world, False, timeout=TIMEOUT)
        dist.init_process_group(backend, store=self.store, rank=self.rank,
                                world_size=self.world, timeout=TIMEOUT)
        self.ctl = (dist.group.WORLD if backend == "gloo"
                    else dist.new_group(backend="gloo", timeout=TIMEOUT))
        return self.rank, self.world, dist.group.WORLD

    def barrier(self):
        dist.barrier(group=self.ctl)

    def step(self, go: bool, stop_trace: bool):
        """Rank 0's decision before a request, the same on every rank:
        (whether to run it, whether to stop the profiler first)."""
        flag = torch.tensor([(1 + bool(stop_trace)) if go else 0])
        dist.broadcast(flag, 0, group=self.ctl)
        v = int(flag[0])
        return v > 0, v == 2

    def gather(self, obj):
        """Rank 0: every rank's ``obj`` (host objects), by rank; other
        ranks: None."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.ctl)
        return out

    def close(self):
        dist.destroy_process_group()

    def wait(self) -> bool:
        """Rank 0: wait for the other ranks to end; True where each ended
        with code 0."""
        for t in self._watchers:
            t.join(TIMEOUT.total_seconds())
        return all(p.poll() == 0 for p in self._procs)

    def stop(self):
        """Rank 0: end every child still running, and wait for it."""
        self._stopping = True
        self._kill()
