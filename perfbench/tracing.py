"""The traced run's reduction: ``torch.profiler`` over the window's CUDA
activity, its device events mapped onto the host's monotonic clock, and
what the per-layer readers and the breakdown take from them.

The profiler's clock is the wall clock in ns: a ``time.time_ns()`` read
beside ``time.monotonic()`` right after the profiler starts ties the two
together. Only CUDA activity is recorded: host events would double what a
traced run reads and slow the host-bound program under test.
"""
from __future__ import annotations

import dataclasses
import time

from . import roofline


@dataclasses.dataclass
class TraceData:
    """Device events of one traced window, in monotonic seconds."""
    device: list[tuple[str, float, float]]  # (name, start, end), every device activity

    def device_in(self, t0: float, t1: float, part: str | None = None) -> list[tuple]:
        """Device activities clipped to [t0, t1], those whose name holds
        ``part`` only when it is given."""
        out = []
        for name, lo, hi in self.device:
            if hi <= t0 or lo >= t1 or (part is not None and part not in name):
                continue
            out.append((name, max(lo, t0), min(hi, t1)))
        return out

    def busy_s(self, t0: float, t1: float) -> float:
        return roofline.union_s((lo, hi) for _, lo, hi in self.device_in(t0, t1))

    def kernel_s(self, t0: float, t1: float, part: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels named with ``part``."""
        ev = self.device_in(t0, t1, part)
        return sum(hi - lo for _, lo, hi in ev), len(ev)


class Tracer:
    """``torch.profiler`` over CUDA activities, started and stopped around
    the traffic."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._clock = None

    def start(self) -> None:
        self._prof.__enter__()
        self._clock = (time.time_ns(), time.monotonic())

    def stop(self) -> TraceData:
        import sys

        from torch.autograd import DeviceType

        t0 = time.monotonic()
        self._prof.__exit__(None, None, None)
        wall, mono = self._clock
        device = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                lo = mono + (e.start_ns() - wall) / 1e9
                device.append((e.name(), lo, lo + e.duration_ns() / 1e9))
        print(f"perfbench: trace of {len(device)} device events read in "
              f"{time.monotonic() - t0:.1f} s", file=sys.stderr)
        return TraceData(device)


def top_device_ops(trace: TraceData, t0: float, t1: float, n: int = 10) -> list[list]:
    """The ``n`` device operations that took most time in [t0, t1]."""
    by: dict[str, float] = {}
    for name, lo, hi in trace.device_in(t0, t1):
        key = name[:120]
        by[key] = by.get(key, 0.0) + (hi - lo)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: TraceData, t0: float, t1: float, n: int = 10) -> list[list]:
    """The device's idle time in [t0, t1], summed by the device operation
    each gap follows ("window open" before the first), the ``n`` largest."""
    spans = sorted((lo, hi, name) for name, lo, hi in trace.device_in(t0, t1))
    by: dict[str, float] = {}
    cur, last = t0, "window open"
    for lo, hi, name in spans:
        if lo > cur:
            by[last] = by.get(last, 0.0) + (lo - cur)
        if hi >= cur:
            cur, last = hi, f"after {name[:110]}"
    if t1 > cur:
        by[last] = by.get(last, 0.0) + (t1 - cur)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
