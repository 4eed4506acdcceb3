"""device_busy_ms.estimate (device trace; moves estimate_s): the time in
which some device item (kernel, copy, memset) ran, in the traced part
of the window, over the estimate requests that ran in it, in ms: the
card's share of an estimate, which host dispatch cannot shorten.  Device
time does not stretch under the profiler, as the host's walls do."""

from perfbench.trace import traced_requests


def read(run):
    n = traced_requests(run, "estimate")
    return 1e3 * run["trace"]["busy_s"] / n if n else None
