"""The allocation's interior-point solver of two checkouts of
bluest_tpu_torch on the host CPU, in turns (A, B, B, A): ms an IPM
iteration of one cold set-up of the flagship-width problem (M=10, three
outputs, K=4, budget 2e5, L=385; the seeded covariances of
tests/test_torch_allocation.py) and, with ``--hh-graph``, of a saved
Hodgkin-Huxley graph at K=5, budget 2e5.

    python tools/torch_ipm_host_turns.py ROOT_A ROOT_B [--hh-graph PATH]

Each turn is a fresh process that imports the package of its root,
allocates on the host (``device="cpu"``) with the warm cache off, and
prints one JSON line: the root, the program, the IPM's iterations, its
seconds and ms an iteration, and the statuses of the set-up's cone
solves.  Run it on the machine whose host is to be measured.
"""

import json
import os
import subprocess
import sys

TURN = r"""
import json, sys, time
import numpy as np
import bluest_tpu_torch
from bluest_tpu_torch import BLUEProblem
from bluest_tpu_torch.solvers import sdp
root, which, hh_graph = sys.argv[1:4]
assert bluest_tpu_torch.__file__.startswith(root), bluest_tpu_torch.__file__
if which == "flagship":
    grids = (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2)
    rng = np.random.default_rng(2)
    M = len(grids)
    Cs = []
    for _ in range(3):
        A = rng.standard_normal((M, M)) * 0.05
        base = 0.97 ** np.abs(np.subtract.outer(np.arange(M), np.arange(M)))
        s = np.exp(rng.standard_normal(M) * 0.3)
        Cs.append(base * np.outer(s, s) + A @ A.T)
    p = BLUEProblem(M, C=Cs, costs=np.array([g / 2.0 for g in grids]),
                    n_outputs=3, verbose=False, device="cpu")
    how = dict(K=4, budget=2.0e5)
else:
    from bluest_tpu_torch.models import hodgkin_huxley as hh
    p = hh.HodgkinHuxleyProblem(datafile=hh_graph, verbose=False,
                                device="cpu")
    how = dict(K=5, budget=2.0e5)
rec = {"iterations": 0, "ipm_s": 0.0}
real = sdp._ipm_solve
def timed(*a, **k):
    t0 = time.perf_counter()
    out = real(*a, **k)
    rec["ipm_s"] += time.perf_counter() - t0
    rec["iterations"] += out[1]
    return out
sdp._ipm_solve = timed
p.setup_solver(**how)
rec.update(root=root, program=which, L=p.MOSAP.L,
           ms_per_iteration=1e3 * rec["ipm_s"] / max(rec["iterations"], 1),
           statuses=[c["status"] for c in p.MOSAP.certificates])
print(json.dumps(rec))
"""


def turn(root, which, hh_graph):
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root, BLUEST_TPU_IPM_WARM="0")
    # run from the root: "python -c" puts the working directory first on
    # the import path
    out = subprocess.run([sys.executable, "-c", TURN, root, which,
                          os.path.abspath(hh_graph) if hh_graph else ""],
                         cwd=root, env=env, capture_output=True, text=True,
                         check=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    argv = sys.argv[1:]
    hh_graph = ""
    if "--hh-graph" in argv:
        i = argv.index("--hh-graph")
        hh_graph = argv[i + 1]
        del argv[i:i + 2]
    a, b = argv
    programs = ["flagship"] + (["hh"] if hh_graph else [])
    for which in programs:
        for root in (a, b, b, a):
            print(json.dumps(turn(root, which, hh_graph)), flush=True)


if __name__ == "__main__":
    main()
