"""sample.device_ops_per_estimate (device trace; moves estimate_s):
device items (kernels, copies, memsets) in the traced part of the
window over the estimate requests that ran in it: the count that host
dispatch pays for."""

from perfbench.trace import traced_requests


def read(run):
    n = traced_requests(run, "estimate")
    return run["trace"]["items"] / n if n else None
