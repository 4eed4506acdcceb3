"""mesh.chunk_imbalance (program counters; moves estimate_s): how far
the program's deal of chunks to sample ranks leaves one rank with more
work than the others: the largest over the ranks of the ``mesh.chunks``
counter (the chunks a rank evaluated, top-up rounds included) per traced
request, over the ranks' mean of it.  1 is an even deal; a fast rank
waits for the slowest at the fetch's ``all_reduce``.  Read from rank 0's
``run["program"]`` and each other rank's ``run["ranks"][i]["program"]``;
None where a rank recorded no chunk or no request."""


def per_request(prog):
    """A rank's ``mesh.chunks`` per traced request, or None."""
    if not prog or not prog.get("requests"):
        return None
    n = prog["counters"].get("mesh.chunks")
    return None if n is None else n / prog["requests"]


def read(run):
    progs = [run.get("program")] + [r.get("program")
                                    for r in run.get("ranks") or []]
    if len(progs) < 2:
        return None
    each = [per_request(p) for p in progs]
    if any(v is None for v in each):
        return None
    mean = sum(each) / len(each)
    return max(each) / mean if mean > 0 else None
