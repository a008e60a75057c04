"""Small statistics shared by the metric readers."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks, as ``numpy.percentile``'s default; ``inf`` where it
    reaches an infinite value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(xs[hi]) or math.isinf(xs[lo]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latencies(run) -> list[float]:
    """Seconds from each window request's due time until its rows were in
    hand; a request that failed or never came is infinitely late."""
    return [r.in_hand - r.due if r.sample is not None else math.inf for r in run.measured]


def delta(run, key: str):
    """A scheduler counter's growth over the window."""
    return run.close_snap["stats"][key] - run.open_snap["stats"][key]


def idle_frac(run) -> float | None:
    """1 - the device's busy time (the union of its activities) over the
    window's wall; nothing without a trace."""
    if run.trace is None:
        return None
    return 1.0 - run.trace.busy_s(run.t_open, run.t_close) / run.window_s
