"""sample_roofline (device trace; moves estimate_s): the least time the
card needs for the model evaluations of the traced estimate requests
(``work/<family>.py``: the larger of operations over the peak rate and
bytes over HBM bandwidth, from the allocation's samples times each
group's models) over the device's busy time in the traced part of the
window, in %."""

import importlib

from perfbench.trace import traced_requests


def read(run):
    n = traced_requests(run, "estimate")
    if not n or run["trace"]["busy_s"] <= 0:
        return None
    work = importlib.import_module("perfbench.work."
                                   + run["config"]["family"])
    least, _bound = work.least_seconds(run["config"], run["state"]["active"])
    return 100.0 * least * n / run["trace"]["busy_s"]
