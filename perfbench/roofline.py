"""The yardstick's card-wide arithmetic: the card's peaks, a kernel
launch's work and bound, and the union of device intervals. What knows a
model (its dense operations, its launches a step) is its family's
(``families/<family>.py``).

Frozen copies, so that a change to the program cannot move them:
``int8_matmul_work`` is ``chip_smoke.py:work()``'s int8_matmul branch and
``launch_bound`` its bound; ``union_s`` is
``benchmarks/torch_step_profile.py:union_ms`` over (start, end) pairs.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def int8_matmul_work(batch: int, m: int, k: int, n: int, w_batch: int) -> tuple[float, float]:
    """(operations, bytes) of one int8 x int8 -> int32 product at its
    unpadded (M, K, N): each input read once, the output written once."""
    return 2.0 * batch * m * n * k, float(batch * m * k + w_batch * k * n + 4 * batch * m * n)


def launch_bound(ops: float, nbytes: float) -> float:
    """The least seconds a launch can take on the card."""
    return max(ops / PEAK_INT8_OPS, nbytes / HBM_BYTES_PER_S)


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in seconds, so
    activities that ran at once count once."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total
