"""The controls of the correctness check, run on the card at a cell's own
size: the reference put in the program's place, computed one precision
below what the configuration states, judged by the same comparison as a
run's requests.  The benchmark's own runs do not run this.

    python3 perfbench/controls.py --workload <cell> --seeds 11,12,13

The control of an estimate cell: request 0's rows from the reference's
model in float32, and its estimate and error bars assembled from them by
the reference's BLUE in float32, judged as a request's rows and estimate
are.

Each seed prints one JSON line: the cell, the seed and the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def control_numbers(name: str, seed: int, device: str = "cuda",
                    overrides=None):
    """[(name, value)] of the cell's control; ``overrides`` replace keys
    of the cell (tests, at a size the host holds)."""
    cell, cfg = harness.cell_files(name)
    cell = dict(cell, **(overrides or {}))
    ctx = SimpleNamespace(cfg=cfg, cell=cell, seed=int(seed), device=device,
                          inputs=os.path.join(harness.ROOT, cfg["inputs"]),
                          rank=0, world=1, group=None)
    kind = harness.request_kind(cell["kind"])
    state = kind.setup(ctx)
    kind.release(state)
    fam = kind.family(cfg)

    def produce(ls, x):
        return fam.group_outputs(cfg, ls, x, torch.float32)
    followed = kind.follow(state, 0, produce, batched=True)
    mus, errs = kind.estimate_of(state, followed, np.float32)
    return kind.judge(state, {"mus": mus, "errs": errs}, followed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("controls run on a CUDA card", file=sys.stderr)
        return 3
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        nums = control_numbers(args.workload, int(s), args.device)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "control": dict(nums),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
