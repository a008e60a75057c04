"""eager_s_per_dispatch.offline: host seconds of the eager calibration steps
(the program's ``ditto.eager_step`` spans, clipped to the window) over the
window's dispatches; nothing from a program without spans."""
from perfbench.span_report import eager_s_per_dispatch


def read(run):
    return eager_s_per_dispatch(run)
