"""estimator.host_ms (program spans; moves estimate_s): the median over
the traced estimate requests of the wall of their ``estimate`` span, the
BLUE that the host assembles from the fetched sums while the card waits;
from the recorder that a traced run turns on
(``program_trace.summary``)."""


def read(run):
    prog = run.get("program")
    return None if prog is None else prog["summary"]["estimator.host_ms"]
