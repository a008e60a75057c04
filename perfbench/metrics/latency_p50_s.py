"""latency_p50_s: the median of the window's requests' latencies, each from
its due time until its rows are in hand."""
import math

from perfbench.stats import latencies, percentile


def read(run):
    v = percentile(latencies(run), 50)
    return None if math.isinf(v) else v
