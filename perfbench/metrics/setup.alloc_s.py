"""setup.alloc_s (program spans; moves setup_s): the wall of the
set-up's ``setup_solver`` root spans, the allocation that set-up makes
before the window; from the recorder that a traced run turns on
(``program_trace.summary``)."""


def read(run):
    prog = run.get("program")
    return None if prog is None else prog["summary"]["setup.alloc_s"]
