"""Cluster-size sweep of the two encodes of the PyTorch/CUDA port.

    python3 benchmarks/torch_encode_sweep.py

At every DiT-XL/2 main-path encode shape for a batch of two requests (the
x operands of the GEMMs' shapes; wq, wi and final.out share one), it times
``diff_encode`` and ``diff_encode_fused`` with each 128 x 128 class tile
forced over a thread-block cluster of 1, 2, 4 and 8 blocks, and names the
size the rule takes (``common.encode_cluster``). Three times a launch, in
microseconds:

- ``cold``: CUDA events, median of 30 runs with the L2 cache cleared
  before each, as chip_smoke.py times a kernel alone;
- ``warm``: the kernel's device time per launch from ``torch.profiler``
  over 100 back-to-back launches with no flush, so both operands sit in
  L2;
- ``step``: the kernel's device time per launch from ``torch.profiler``
  over 50 launches, each after the L2 cache is cleared and x_t read back
  into it: how the main path finds its operands (x_t just written by the
  quantize step, x_prev last touched a denoising step ago).

It also prints ``floor``: the device time of a one-element fill, the
shortest a launch takes on the card. Δ is uniform in [-254, 254] (class
2: the fused encode writes both planes) with one class-0 tile. Every
forced size is held bit for bit against the plain version before it is
timed. To compare two versions, run each checkout's own sweep in one call.

Prints one JSON line per (kernel, shape), then the card's name and power
limit. It is the source of PERF.md's encode sweep. Needs a CUDA card.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.kernels import common, ref  # noqa: E402
from repro_torch.kernels import diff_encode as k_encode  # noqa: E402
from repro_torch.kernels import fused_step as k_fused  # noqa: E402

TOKENS, D, HEADS, HEAD_DIM = 256, 1152, 16, 72  # DiT-XL/2
BATCH = 2  # requests
COLD_REPS, WARM_LAUNCHES = 30, 100
# kernel -> the __global__ function it runs (csrc/), as the profiler names it
FUNCTION = {"diff_encode": "diff_encode_kernel", "diff_encode_fused": "diff_encode_fused_kernel"}


def encode_shapes() -> dict:
    """name -> (batch dims, M, K) of the path's encodes for BATCH requests,
    after the ops wrappers' 128-padding (the x operands of
    torch_diff_gemm_sweep.py's shapes)."""
    m, bh, hd = BATCH * TOKENS, (BATCH * HEADS,), 128 * -(-HEAD_DIM // 128)
    return {"wq/wi/final.out": ((), m, D), "wd": ((), m, 4 * D),
            "mod": ((), 128 * -(-BATCH // 128), D), "attn-qk": (bh, TOKENS, hd),
            "attn-pv": (bh, TOKENS, TOKENS), "attn-dk": (bh, hd, TOKENS)}


def operands(g, shape):
    """x_t, x_prev on the card with Δ uniform in [-254, 254] and one
    class-0 tile."""
    x_t = torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)
    d = torch.randint(-254, 255, shape, generator=g, device="cuda", dtype=torch.int32)
    d[..., :128, :128] = 0
    return x_t, (x_t.to(torch.int32) - d).clamp(-127, 127).to(torch.int8)


def hold(kname, got, x_t, x_p):
    """A forced launch against the plain version: classes in full, the
    Δ-cache on the tiles whose class gates it in."""
    if kname == "diff_encode":
        ok = torch.equal(got, ref.diff_encode_ref(x_t, x_p, (128, 128)))
    else:
        (cls, dc, dh), (want_c, want_dc, want_dh) = got, ref.diff_encode_fused_ref(
            x_t, x_p, (128, 128))
        live = ref.tile_mask(want_c, (128, 64), lambda c: c >= 1)
        full = ref.tile_mask(want_c, (128, 128), lambda c: c == 2)
        ok = (torch.equal(cls, want_c) and torch.equal(dc[live], want_dc[live])
              and torch.equal(dh[full], want_dh[full]))
    if not ok:
        raise AssertionError(f"{kname} disagrees with its plain version")


def events_us(fn, flush, warm=3) -> float:
    """CUDA events around one launch after the L2 flush, median, us."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(COLD_REPS):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) * 1e3)
    return statistics.median(times)


def device_us(fn, name: str, n: int, before=None) -> float:
    """Mean device time, us, of the launches of the kernel whose name holds
    ``name`` over ``n`` calls of ``fn``, each after ``before`` if given.
    A profile whose trace came back without them (seen once in a few
    hundred on the H100) is run again, twice at most."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if us:
            return sum(us) / len(us)
    raise RuntimeError(f"the profiler saw no launch of {name}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_encode_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    common.build_library()
    g = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    one = torch.empty(1, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(json.dumps(dict(floor_us=device_us(one.zero_, "", WARM_LAUNCHES))), flush=True)
    for name, (lead, m, k) in encode_shapes().items():
        x_t, x_p = operands(g, lead + (m, k))
        tiles = math.prod(lead) * (m // 128) * (k // 128)

        def refill():  # the step's operands: L2 cleared, x_t read back into it
            flush.zero_()
            x_t.max()

        for kname in FUNCTION:
            launch = k_encode.launch if kname == "diff_encode" else k_fused.launch_encode
            times: dict = {"cold": {}, "warm": {}, "step": {}}
            for c in common.ENCODE_CLUSTERS:
                run = lambda c=c: launch(x_t, x_p, c)  # noqa: E731
                hold(kname, run(), x_t, x_p)
                times["cold"][c] = events_us(run, flush)
                times["warm"][c] = device_us(run, FUNCTION[kname], WARM_LAUNCHES)
                times["step"][c] = device_us(run, FUNCTION[kname], WARM_LAUNCHES // 2, refill)
            warm, rule = times["warm"], common.encode_cluster(tiles, sms)
            best = min(warm, key=warm.get)
            print(json.dumps(dict(
                b=BATCH, kernel=kname, shape=name, x=list(lead + (m, k)), tiles=tiles, sms=sms,
                **{f"{r}_us": t for r, t in times.items()}, rule=rule, warm_best=best,
                rule_over_best=warm[rule] / warm[best],
                step_best=min(times["step"], key=times["step"].get))), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
