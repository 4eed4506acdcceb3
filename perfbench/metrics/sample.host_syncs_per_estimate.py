"""sample.host_syncs_per_estimate (program spans; moves estimate_s): the
program's blocking device-to-host reads (``host.sync`` spans) a traced
estimate request, each of which empties the card's queue; from the
recorder that a traced run turns on (``program_trace.summary``)."""


def read(run):
    prog = run.get("program")
    return None if prog is None else prog["summary"][
        "sample.host_syncs_per_estimate"]
