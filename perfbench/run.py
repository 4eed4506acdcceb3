"""Run one cell of the benchmark once and print its result line:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See perfbench/README.md."""

import time

T_START = time.perf_counter()       # setup_s counts from here

import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the OpenMP and BLAS pools of numpy and
# PyTorch would otherwise spin on the cores that the request loop needs
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
