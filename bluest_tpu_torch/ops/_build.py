"""nvcc builds of the port's kernel sources into shared libraries.

Each source under ``bluest_tpu_torch/csrc/`` is compiled at first use for
``sm_90a`` into ``build/bluest_tpu_torch/`` next to the package, once per
hash of its text and its flags, and loaded with ctypes by its wrapper
module (``ops.diffusion``, ``ops.hodgkin_huxley``).  A build holds a
lock on ``<library>.lock`` beside the library (``fcntl.flock``, which the
kernel drops when its process ends), so of the processes that need the
same library at once, as the ranks of a job on a checkout's first run
do, one runs nvcc and the others wait for it and load its library.  The
compile writes a temporary file that is renamed into place, so a reader
never sees half a library.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from .. import profiling

__all__ = ["BUILD_DIR", "BASE_FLAGS", "find_nvcc", "build", "build_logs"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "bluest_tpu_torch")
# the flags every source takes; a source adds its own after them
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

build_logs = {}         # library path -> nvcc's output (registers, spills)
_locks = {}             # library path -> the lock its build holds
_locks_lock = threading.Lock()


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's kernels are built from "
            "bluest_tpu_torch/csrc/ at first use and need the CUDA toolkit "
            "(nvcc on PATH or /usr/local/cuda/bin/nvcc)")
    return nvcc


def build(source: str, flags) -> str:
    """The path of ``source`` built with ``flags`` into a shared library,
    compiled now unless a library of the same text and flags exists.
    Raises ``RuntimeError`` with nvcc's output when the compile fails."""
    flags = list(flags)
    with open(source, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(BUILD_DIR, "libbluest_%s_%s.so" % (stem, tag[:16]))
    with _locks_lock:
        lock = _locks.setdefault(path, threading.Lock())
    with profiling.span("kernels.load", library=os.path.basename(path),
                        nvcc=False) as sp:
        # one build of a library at a time, in this process (threads) and
        # across processes (the lock file), others apart
        with lock:
            if os.path.exists(path):
                return path
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(path + ".lock", "a") as held:
                fcntl.flock(held, fcntl.LOCK_EX)
                if not os.path.exists(path):
                    _compile(source, flags, path, sp)
    return path


def _compile(source: str, flags, path: str, sp) -> None:
    """nvcc ``source`` with ``flags`` into ``path``, through a temporary
    file renamed into place."""
    nvcc = find_nvcc()
    if sp is not None:
        sp.attrs["nvcc"] = True
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc] + flags + ["-o", tmp, source],
                              capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed to build %s:\n%s"
                               % (source, log))
        os.replace(tmp, path)             # atomic: no reader sees half
        build_logs[path] = log
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
