"""queue_wait_p50_s.online: the median over the window's requests of their
``ticket.queue`` span, from submit to the take of their first rows; nothing
when a request was never taken or the program records no spans."""
from perfbench.span_report import queue_wait_p50_s


def read(run):
    return queue_wait_p50_s(run)
