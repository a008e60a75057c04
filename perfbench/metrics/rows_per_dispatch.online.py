"""rows_per_dispatch.online: rows dispatched over dispatches in the window,
from the scheduler's counters."""
from perfbench.stats import delta


def read(run):
    n = delta(run, "dispatches")
    return delta(run, "dispatched_rows") / n if n else None
