"""setup_s: seconds from the process's start until the measured window
opens: imports, the kernel library (built on a checkout's first run),
weights, the scheduler's warm-up captures and, in the backlog mixes, the
first full dispatch."""


def read(run):
    return run.setup_s
