"""``ops._build.build`` across processes: two processes that need the
same library at once run nvcc once, through the lock file beside the
library, and both load the one library.  A fake ``nvcc`` on ``PATH``
sleeps, notes its call and writes its output, so the test needs no CUDA
toolkit."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = """#!/bin/sh
echo "$$" >> "{calls}"
sleep 1.5
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi
  shift
done
"""

# one process: wait until every process is ready, then build
BUILD_ONE = textwrap.dedent("""
    import os, sys, time
    from bluest_tpu_torch.ops import _build
    build_dir, source, ready, n = sys.argv[1:5]
    _build.BUILD_DIR = build_dir
    open(ready + "." + str(os.getpid()), "w").close()
    while len([f for f in os.listdir(os.path.dirname(ready))
               if f.startswith(os.path.basename(ready) + ".")]) < int(n):
        time.sleep(0.01)
    print(_build.build(source, ["-O3"]))
""")


def test_two_processes_build_a_library_once(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(calls=calls))
    nvcc.chmod(0o755)
    source = tmp_path / "k.cu"
    source.write_text("// a kernel source\n")
    (tmp_path / "sync").mkdir()
    ready = str(tmp_path / "sync" / "ready")
    env = dict(os.environ, PATH=str(bin_dir) + os.pathsep + os.environ["PATH"],
               OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_ONE, str(tmp_path / "build"), str(source),
         ready, "2"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _o, e in outs]
    paths = {o.strip().splitlines()[-1] for o, _e in outs}
    assert len(paths) == 1
    path = paths.pop()
    assert open(path).read() == "built\n"
    assert len(calls.read_text().split()) == 1
    # the lock file stays beside the library; no temporary file is left
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        [os.path.basename(path), os.path.basename(path) + ".lock"])
