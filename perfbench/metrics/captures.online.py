"""captures.online: CUDA graphs captured in the window (runner keys whose
Defo modes differ from the warm-up probe's), from the scheduler's
``captures_after_warmup``."""
from perfbench.stats import delta


def read(run):
    return float(delta(run, "captures_after_warmup"))
