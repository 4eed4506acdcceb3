"""setup_s (host clock): from the start of the command to the first
timed request: imports, the CUDA context, the kernels' libraries (built
on a checkout's first run), the frozen graph, the set-up allocation and
one warm request of the cell's kind."""


def read(run):
    return run["setup_s"]
