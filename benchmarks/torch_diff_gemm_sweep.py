"""K-split sweep of the three GEMMs of the PyTorch/CUDA port.

    python3 benchmarks/torch_diff_gemm_sweep.py [--batch 2] [--mix full] [--reps 30] [--tag NAME]

At every DiT-XL/2 main-path shape for a batch of ``--batch`` requests (the
shapes of chip_smoke.py's parity phase at B = 2, W K-major as the compiled
pass keeps it), it times the two difference GEMMs, ``ditto_diff_matmul``
(``low_bits=8``) and ``ditto_fused_matmul`` with y_prev, and the act GEMM
``int8_matmul`` (at the shapes the act path gives it: every shape but the
difference-only attention sub-op ``attn-dk``), with K split every way from
1 to 8 (where K has that many 128-K class tiles) and with the kernel's own
choice (``common.diff_gemm_splits``). ``--mix full``: Δ uniform in
[-254, 254], so nearly every chunk takes the hi product; ``--mix mid``: Δ
uniform in [-20, 20], class 2 without a hi product. Both keep one class-0
tile; ``int8_matmul`` takes x_t as its x whatever the mix. Every forced
split is held bit for bit against the kernel's own launch before it is
timed. Times: CUDA events, median of ``--reps`` runs with the L2 cache
cleared before each, as chip_smoke.py times a kernel alone.

Prints one JSON line per (kernel, shape) with the times in microseconds,
then the card's name and power limit. It is the source of PERF.md's split
table; to compare two versions of a kernel, run it from two checkouts in
one call (``--tag`` labels the lines). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import ditto_diff_matmul as k_diff  # noqa: E402
from repro_torch.kernels import diff_encode as k_encode  # noqa: E402
from repro_torch.kernels import fused_step as k_fused  # noqa: E402
from repro_torch.kernels import int8_matmul as k_int8  # noqa: E402

TOKENS, D, MLP, HEADS, HEAD_DIM, OUT = 256, 1152, 4608, 16, 72, 16  # DiT-XL/2
SPLITS = range(1, 9)
DELTA = {"full": 254, "mid": 20}


def pad(x: int) -> int:
    return -(-x // 128) * 128


def shapes(b: int) -> dict:
    """name -> (batch dims, M, K, N) of the path's diff GEMMs for a batch of
    b requests, after the ops wrappers' 128-padding."""
    m, bh, hd = b * TOKENS, (b * HEADS,), pad(HEAD_DIM)
    return {
        "wq": ((), m, D, D),
        "wi": ((), m, D, MLP),
        "wd": ((), m, MLP, D),
        "final.out": ((), m, D, pad(OUT)),
        "mod": ((), pad(b), D, 6 * D),
        "attn-qk": (bh, TOKENS, hd, TOKENS),
        "attn-pv": (bh, TOKENS, TOKENS, hd),
        "attn-dk": (bh, hd, TOKENS, TOKENS),
    }


def median_us(fn, flush, reps, warm=3) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) * 1e3)
    return statistics.median(times)


def operands(g, lead, m, k, n, mix):
    """x_t, x_prev with Δ of ``mix``, W (N, K), y_prev, on the card."""
    dev = "cuda"
    x_t = torch.randint(-127, 128, lead + (m, k), generator=g, device=dev, dtype=torch.int8)
    d = torch.randint(-DELTA[mix], DELTA[mix] + 1, lead + (m, k), generator=g, device=dev,
                      dtype=torch.int32)
    d[..., :128, :128] = 0
    x_p = (x_t.to(torch.int32) - d).clamp(-127, 127).to(torch.int8)
    w = torch.randint(-127, 128, lead + (n, k), generator=g, device=dev, dtype=torch.int8)
    y_prev = torch.randint(-2**24, 2**24, lead + (m, n), generator=g, device=dev,
                           dtype=torch.int32)
    return x_t, x_p, w, y_prev


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--mix", choices=sorted(DELTA), default="full")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_diff_gemm_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    common.build_library()
    g = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(2**30, dtype=torch.uint8, device="cuda")
    for name, (lead, m, k, n) in shapes(args.batch).items():
        x_t, x_p, w, y_prev = operands(g, lead, m, k, n, args.mix)
        cls = k_encode.diff_encode(x_t, x_p)
        cls_f, dc, dh = k_fused.diff_encode_fused(x_t, x_p)
        batch = 1 if not lead else lead[0]
        kernels = {
            "ditto_diff_matmul": lambda s: k_diff.launch(x_t, x_p, w, y_prev, cls, 8, s),
            "ditto_fused_matmul": lambda s: k_fused.launch_matmul(w, dc, dh, cls_f, y_prev, s),
            "int8_matmul": lambda s: k_int8.launch(x_t, w, s),
        }
        for kname, run in kernels.items():
            if kname == "int8_matmul" and name == "attn-dk":  # a difference-only sub-op
                continue
            want = run(0)
            us = {}
            for s in SPLITS:
                if s > k // 128:
                    continue
                if not torch.equal(run(s), want):
                    raise AssertionError(f"{kname} at {name}: {s} splits disagree with the "
                                         f"kernel's own split")
                us[str(s)] = median_us(lambda: run(s), flush, args.reps)
            us["auto"] = median_us(lambda: run(0), flush, args.reps)
            print(json.dumps(dict(tag=args.tag, mix=args.mix, b=args.batch, kernel=kname,
                                  shape=name, batch=batch,
                                  mkn=[m, k, n], auto_splits=common.diff_gemm_splits(
                                      batch, m, n, k), us=us)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
