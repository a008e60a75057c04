"""The knee of a Poisson cell: the highest offered rate at which, over a
window, the queue does not grow and the 95th percentile of latency meets
the limit. Run once, when the cell is defined; the cell then runs at a
fixed rate below it (its traffic file keeps the rate, the knee and the
limit).

    python3 perfbench/sweep.py --workload dit-xl2-256.online --seed 1 \\
        --rates 2 2.25 2.5 2.75 3 3.25 3.5 --seconds 50

In one process: the program is built and warmed once, the limit is twice
the median wall of :data:`DISPATCHES` full ``max_batch``-row dispatches,
and then each rate's window runs the cell's traffic at that rate, after
its own ``warm_s`` of it.
A rate holds when its p95 is within the limit and its later requests wait
no longer than its earlier ones (the mean latency of the last third of the
window within 1.5x of the first third's). The rates run in ascending order
until the first that fails: the knee is the highest rate below it, and the
last line says whether a failing rate bracketed it. Prints one JSON line a
rate. Exits with a non-zero code, timing nothing, without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:1] = [ROOT, os.path.join(ROOT, "src")]

from perfbench import harness  # noqa: E402
from perfbench.stats import percentile  # noqa: E402

#: Full dispatches whose median wall sets the latency limit.
DISPATCHES = 5


def dispatch_wall(prog: harness.Program, cell: harness.Cell, seed: int, n: int,
                  device) -> float:
    """Median wall of ``n`` full dispatches, one after another."""
    mb = prog.plan.max_batch
    walls = []
    for i in range(n):
        x, cond = cell.family.make_request(cell.config["model"], seed, 10_000 + i, mb, device)
        t0 = time.monotonic()
        prog.submit(x, cond).result()
        walls.append(time.monotonic() - t0)
    return statistics.median(walls)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=25.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("perfbench: the sweep times the card; no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels.common import build_library

    cell = harness.load_cell(args.workload)
    device = "cuda"
    build_library()
    prog = harness.Program(cell, cell.family.make_weights(cell.config["model"], args.seed,
                                                          device), device)
    try:
        wall = dispatch_wall(prog, cell, args.seed, DISPATCHES, device)
        limit = 2 * wall
        print(json.dumps({"full_dispatch_wall_s": wall, "limit_s": limit}), flush=True)
        knee = failing = None
        for rate in sorted(args.rates):
            cell.traffic = dict(cell.traffic, rate_per_s=rate, deadline_ms=1e3 * limit)
            _, t0, t1, measured, o, c, _ = harness.drive_poisson(
                prog, cell, args.seed, args.seconds, device, None, time.monotonic())
            lat = [r.in_hand - r.due if r.sample is not None else float("inf")
                   for r in measured]
            third = max(len(lat) // 3, 1)
            first, last = statistics.fmean(lat[:third]), statistics.fmean(lat[-third:])
            p95 = percentile(lat, 95)
            holds = p95 <= limit and last <= 1.5 * first
            disp = c["stats"]["dispatches"] - o["stats"]["dispatches"]
            rows = c["stats"]["dispatched_rows"] - o["stats"]["dispatched_rows"]
            print(json.dumps({"rate_per_s": rate, "requests": len(lat),
                              "p50_s": percentile(lat, 50), "p95_s": p95,
                              "first_third_mean_s": first, "last_third_mean_s": last,
                              "rows_per_dispatch": rows / disp if disp else None,
                              "queued_rows_at_close": c["stats"]["queued_rows"],
                              "captures": (c["stats"]["captures_after_warmup"]
                                           - o["stats"]["captures_after_warmup"]),
                              "holds": holds}), flush=True)
            if not holds:
                failing = rate
                break
            knee = rate
            prog.sched.flush()  # the unmeasured tail drains before the next rate
        print(json.dumps({"knee_rate_per_s": knee, "first_failing_rate_per_s": failing,
                          "bracketed": failing is not None, "limit_s": limit}), flush=True)
    finally:
        prog.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
