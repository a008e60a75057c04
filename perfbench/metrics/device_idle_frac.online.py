"""device_idle_frac.online: the share of the window's wall in which no
device activity ran."""
from perfbench.stats import idle_frac


def read(run):
    return idle_frac(run)
