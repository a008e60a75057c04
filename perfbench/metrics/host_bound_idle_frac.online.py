"""host_bound_idle_frac.online: the share of the window's wall in which the
device ran nothing while the dispatch thread was inside a
``sched.dispatch`` span and outside ``session.sync`` (the host's own
work); nothing from a program without spans."""
from perfbench.span_report import host_bound_idle_frac


def read(run):
    return host_bound_idle_frac(run)
