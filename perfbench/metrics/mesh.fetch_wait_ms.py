"""mesh.fetch_wait_ms (program spans; moves estimate_s): the time a
rank spends in the fetch's ``mesh.fetch`` span, the ``all_reduce`` of
the sums over the sample ranks and the copy that waits for it, hence
for the slowest rank, summed over a traced request's fetch rounds: the
largest over the ranks of its mean per traced request, in ms.  Read from
rank 0's ``run["program"]`` and each other rank's
``run["ranks"][i]["program"]``; None where a rank recorded no such span
or no request."""


def per_request_ms(prog):
    """A rank's ``mesh.fetch`` seconds per traced request, in ms, or
    None."""
    if not prog or not prog.get("requests"):
        return None
    span = prog["spans"].get("mesh.fetch")
    return None if span is None else 1e3 * span[1] / prog["requests"]


def read(run):
    progs = [run.get("program")] + [r.get("program")
                                    for r in run.get("ranks") or []]
    if len(progs) < 2:
        return None
    each = [per_request_ms(p) for p in progs]
    if any(v is None for v in each):
        return None
    return max(each)
