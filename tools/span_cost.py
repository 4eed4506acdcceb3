"""The cost of the span recorder when it is on, on a benchmark cell.

    python tools/span_cost.py --workload hh12.estimate_k3 --seed N \
        --seconds 10 --windows 6

One process sets the cell up as ``perfbench/run.py`` does (its request
kind's ``setup`` and one warm request), then runs ``2 x windows``
windows of ``--seconds`` each, a closed loop of one client, with the
recorder (``bluest_tpu_torch.profiling``) on and off in turns (on, off,
off, on, ...).  A window's ``estimate_s`` is its wall over the requests
it completed.  One JSON line gives both sides' windows, their medians,
the median of on over off less one, and the spans a request recorded.
The profiler is not running; ``--device cpu`` rehearses on the host.
"""

import argparse
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def window(kind, state, seconds, first, sync):
    """(estimate_s, requests) of one closed-loop window."""
    n, w0 = 0, time.perf_counter()
    while n == 0 or time.perf_counter() - w0 < seconds:
        kind.request(state, first + n)
        n += 1
    sync()
    return (time.perf_counter() - w0) / n, n


def main(argv=None):
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    from bluest_tpu_torch import profiling
    from perfbench import harness

    cell, cfg = harness.cell_files(args.workload)
    ctx = SimpleNamespace(cfg=cfg, cell=cell, seed=args.seed,
                          device=args.device,
                          inputs=os.path.join(ROOT, cfg["inputs"]),
                          rank=0, world=1, group=None)
    cuda = args.device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kind = harness.request_kind(cell["kind"])
    state = kind.setup(ctx)
    kind.request(state, -1)
    sync()
    out = {"on": [], "off": [], "spans_a_request": []}
    first = 0
    for i in range(2 * args.windows):
        on = (i % 4) in (0, 3)
        if on:
            profiling.enable_spans()
        try:
            t, n = window(kind, state, args.seconds, first, sync)
        finally:
            profiling.disable_spans()
        first += n
        out["on" if on else "off"].append(t)
        if on:
            out["spans_a_request"].append(len(profiling.spans()) / n)
    kind.release(state)
    out["median_on"] = statistics.median(out["on"])
    out["median_off"] = statistics.median(out["off"])
    out["on_over_off"] = out["median_on"] / out["median_off"] - 1.0
    out["device"] = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
