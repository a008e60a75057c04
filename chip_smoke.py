#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build   — compile the CUDA kernels from ``src/repro_torch/csrc``.
2. parity  — each kernel against its plain PyTorch version on the card,
             bit for bit (``torch.equal``), at every DiT-XL/2 main-path
             shape at B = 2 (the linear layers with W K-major, as the
             compiled pass keeps it, and (K, N)), over zero / low /
             boundary / full / sparse / lone Δ mixes (sparse: classes 0 /
             1 / 2 interleaved along K, K splits and a block row without a
             live tile; lone: one lane of +-7 or +-8 decides each tile's
             class, on a row at a block edge of every cluster size), with
             y_prev given and absent: the two-pass kernels (the diff
             GEMM at ``low_bits`` 8 and 4) and the fused pair (the Δ-cache
             compared on the tiles whose class gates it in; the fused GEMM
             also against the two-pass plain version). Both encodes also
             run at every shape and mix with each tile forced over a
             cluster of 1, 2, 4 and 8 blocks. ``int8_matmul``
             runs at every shape over a random and two extreme-value
             operand mixes (lanes of -128 and +-127; x and W all -128
             against W of -128 and of 127, the largest |int32| sums). All
             four GEMMs also run with K forced to every split count 1-8 at
             wd's shape (the difference GEMMs over the full and sparse
             mixes, ``int8_matmul`` over its three).
3. slice   — ``serve_records`` at DiT-XL/2 full width (random weights from
             a seed), 2 requests, 20 DDIM steps, under policy act, diff and
             defo, then under (diff, ``low_bits=4``), (diff, ``fused``) and
             (defo, ``low_bits=4``, ``fused``). Each compiled sample must
             equal the eager-only sample of its policy bit for bit (the
             eager pass computes its products with exact float64 matmuls,
             no kernel), be finite, the last three runs' tile-class
             histograms must equal those of the ``low_bits=8`` run of the
             same policy, and every kernel must have launched during these
             runs.
4. serve   — ``ServeSession`` at DiT-XL/2 through one runner cache (one
             CUDA graph captured per runner key, replayed every later step):
             requests of 1, 3, 2 and 4 rows (buckets 1, 4, 2, 4; the
             2-row one is the slice's own request) under (diff,
             statistics), the same without statistics (its graphs
             captured beforehand by ``cache.warmup``), a three-segment
             schedule (two-pass, then ``low_bits=4``, then ``low_bits=4``
             fused) and, at 10 steps, ``plan.watchdog`` with a ``drift``
             fault armed, then with a ``poison_nan`` fault and no
             saturation watch (so the one re-anchor is the rollback's).
             Every sample must equal uncached ``serve_records`` at its
             bucket bit for bit (the watchdog runs with the same fault and
             the same re-anchors; the poisoned run's re-anchor records
             too, whose class statistics read the rolled-back arena), the
             slice's request its tile histograms too; every key must
             capture once; each run's kernels must have launched from
             replayed graphs (launches per capture x replays). It prints
             the sample walls, the median wall of a replayed and an
             uncached compiled step and of the watchdog's arena snapshot
             per bucket, and the memory held and peaking in each request;
             bucket 4's sample must equal the unbucketed run
             of its 3 rows, and a PLMS request (which keeps earlier
             steps' eps) must equal uncached on the DDIM graph. Last,
             ``cache.warmup`` captures buckets 8 and 16, to read what the
             next rungs of the ladder hold.
5. scheduler — ``ServeScheduler`` at DiT-XL/2, 10 DDIM steps,
             ``max_batch=4``, no statistics, the kernel counts zeroed
             first. Sync: requests of 3, 3 and 2 rows dispatch as 4 + 4
             with no pad row (one by one: 2), each ticket equal to the
             same rows served alone through ``ServeSession`` bit for bit,
             both walls timed warm. Async (25 ms interval): a lone 1-row
             request with a budget dispatches as a "deadline" partial;
             then, on a cold cache, four client threads, each making its
             inputs on the card, submit two requests under diff, (diff,
             ``fused``), a two-segment schedule and act: every ticket
             equals its solo serve bit for bit and each runner key
             captures once (captures run on the dispatch thread while the
             clients allocate and synchronize). ``warmup(buckets=[1, 2,
             4])`` on a fresh cache, then the first requests capture
             nothing. The ladder: a ``session.serve`` error on (diff,
             ``fused``) with ``fallbacks=({"fused": False}, {"compiled":
             False})`` recovers on the two-pass rung, two errors on the
             eager rung, bit-identical to the fault-free rows; a
             ``scheduler.take`` fault fails exactly its ticket and the
             thread serves on; a seeded chaos run ends every ticket
             within its timeout. Each of the six kernels must have run
             from a replayed graph of the phase. It prints one
             ``scheduler: {...}`` line (dispatches, triggers, pad rows,
             deadline misses, latencies, captures, the warmup wall).
6. times   — each kernel on the inputs the slice gave it (the last call at
             each shape), CUDA events, median of 30 runs with the L2 cache
             flushed before each, beside its bound (the work at the path's
             own shapes, not the 128-padded ones), its plain version and,
             where one PyTorch call computes the same function, that call
             (``torch._int_mm`` for a 2-D ``int8_matmul``, timed on W both
             as a (K, N) contiguous copy and as the transposed view of the
             K-major weight; ``library_ms`` is the faster).

The last lines are the ``scheduler: {...}`` line, the kernels JSON, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoPlan, PlanSchedule, dit_runner  # noqa: E402
from repro_torch.kernels import common, ops, ref  # noqa: E402
from repro_torch.kernels import diff_encode as k_encode  # noqa: E402
from repro_torch.kernels import ditto_diff_matmul as k_diff  # noqa: E402
from repro_torch.kernels import fused_step as k_fused  # noqa: E402
from repro_torch.kernels import int8_matmul as k_int8  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.serve import (CompiledRunnerCache, DispatchFailed, Fault,  # noqa: E402
                               FaultInjector, InjectedFault, SchedulerDied, ServeScheduler,
                               ServeSession, bucket_for, chaos_schedule, inject)
from repro_torch.serve import cache as serve_cache  # noqa: E402
from repro_torch.sim import harness  # noqa: E402

INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak (data sheet)
BYTES_PER_S = 3.35e12  # H100 SXM HBM3
STEPS = 20
B = 2
DEVICE = "cuda"
CFG = dit.DIT_XL2

DIFF4 = "ditto_diff_matmul[low_bits=4]"
# name -> the module and attribute of its launch count, its source, the TPU
# kernel it replaces and the wrapper that launches it
KERNELS = {
    "int8_matmul": dict(module=k_int8, counter="launches",
                        source="src/repro_torch/csrc/int8_matmul.cu",
                        replaces="src/repro/kernels/int8_matmul.py:73"),
    "diff_encode": dict(module=k_encode, counter="launches",
                        source="src/repro_torch/csrc/diff_encode.cu",
                        replaces="src/repro/kernels/diff_encode.py:75"),
    "ditto_diff_matmul": dict(module=k_diff, counter="launches",
                              source="src/repro_torch/csrc/ditto_diff_matmul.cu",
                              replaces="src/repro/kernels/ditto_diff_matmul.py:213"),
    DIFF4: dict(module=k_diff, counter="launches_int4",
                source="src/repro_torch/csrc/ditto_diff_matmul.cu",
                replaces="src/repro/kernels/ditto_diff_matmul.py:213"),
    "diff_encode_fused": dict(module=k_fused, counter="encode_launches",
                              source="src/repro_torch/csrc/diff_encode_fused.cu",
                              replaces="src/repro/kernels/fused_step.py:123"),
    "ditto_fused_matmul": dict(module=k_fused, counter="matmul_launches",
                               source="src/repro_torch/csrc/ditto_fused_matmul.cu",
                               replaces="src/repro/kernels/fused_step.py:312"),
}
# the slice run whose compiled steps launch each kernel on every layer of its kind
STEP_RUN = {"int8_matmul": "act", "diff_encode": "diff", "ditto_diff_matmul": "diff",
            DIFF4: "diff low_bits=4", "diff_encode_fused": "diff fused=True",
            "ditto_fused_matmul": "diff fused=True"}
# the argument that carries y_prev, per GEMM wrapper
Y_PREV_AT = {"ditto_diff_matmul": 3, DIFF4: 3, "ditto_fused_matmul": 4}


def say(*a):
    print(*a, flush=True)


def launch_counts() -> dict:
    return {name: getattr(k["module"], k["counter"]) for name, k in KERNELS.items()}



def zero_counts() -> None:
    for k in KERNELS.values():
        setattr(k["module"], k["counter"], 0)


# ------------------------------------------------------------------ parity
# (batch dims, M, K, N, w_transposed) of every main-path kernel call at B = 2,
# after the ops wrappers' 128-padding. The compiled pass keeps the linear
# weights K-major (w_transposed); their (K, N) layout is held as well.
LINEAR_SHAPES = [
    ((), 512, 1152, 1152),  # wq / wk / wv / wo
    ((), 512, 1152, 4608),  # wi
    ((), 512, 4608, 1152),  # wd
    ((), 512, 1152, 128),  # final.out (N = 16)
    ((), 128, 1152, 6912),  # mod (M = B = 2)
]
PATH_SHAPES = [s + (wt,) for wt in (True, False) for s in LINEAR_SHAPES] + [
    ((32,), 256, 128, 256, True),  # qk, act and both diff sub-ops (head dim 72)
    ((32,), 256, 256, 128, True),  # pv act; pv diff sub-op dQ (N = 72)
    ((32,), 128, 256, 256, True),  # pv diff sub-op dK (M = 72)
]
MIXES = ("zero", "low", "edge", "full", "sparse", "lone")
# the rows of a class tile that are a first or a last row of a block at
# some cluster size: 0, 15, 16, 31, ..., 112, 127 (the 8-block slabs'
# edges, the 4- and 2-block slabs' among them)
LONE_ROWS = [r for s in range(8) for r in (16 * s, 16 * s + 15)]
# the shape (wd's, W K-major) at which the diff GEMMs run every K split count
SPLIT_SHAPE = ((), 512, 4608, 1152)
MAX_SPLITS = 8  # a portable thread-block cluster


def sparse_classes(lead, gm, kt):
    """The designed tile classes of the sparse mix, (*lead, gm, kt): classes
    0 / 1 / 2 interleaved along K, shifted by row and batch element; even
    rows hold no live tile in the first half of K, odd rows none in the
    second (whole K splits without a live tile); the last row, where there
    are several, holds none at all."""
    i = torch.arange(gm, device=DEVICE)[:, None]
    j = torch.arange(kt, device=DEVICE)[None, :]
    bidx = torch.arange(math.prod(lead), device=DEVICE).reshape(lead + (1, 1))
    cls = (i + j + bidx) % 3
    hole = torch.where(i % 2 == 0, j < kt // 2, j >= kt // 2)
    cls = torch.where(hole, 0, cls)
    if gm > 1:
        cls[..., gm - 1, :] = 0
    return cls


def lone_delta(shape):
    """Δ of the lone mix, (*lead, M, K) int32: one non-zero lane a class
    tile, 7 or 8 alternating by tile, its sign alternating every two tiles,
    every fifth tile all zero; from tile to tile the lane walks the rows of
    LONE_ROWS and the columns of the tile."""
    lead, (m, k) = shape[:-2], shape[-2:]
    nb, gm, gk = math.prod(lead), m // 128, k // 128
    t = torch.arange(nb * gm * gk, device=DEVICE)  # tiles in (batch, row, column) order
    val = (7 + t % 2) * (1 - 2 * (t // 2 % 2)) * (t % 5 != 4)
    rows = torch.tensor(LONE_ROWS, device=DEVICE)[t % len(LONE_ROWS)]
    d = torch.zeros((nb, gm, 128, gk, 128), dtype=torch.int32, device=DEVICE)
    d[t // (gm * gk), t // gk % gm, rows, t % gk, t * 37 % 128] = val.to(torch.int32)
    return d.reshape(shape)


def delta_pair(g, shape, mix):
    """(x_t, x_prev) int8 on the card whose Δ follows ``mix``; a full mix
    also keeps one class-0 tile so skipping is exercised; a sparse mix
    follows :func:`sparse_classes` tile by tile (class-2 tiles alternate
    between Δ in [-254, 254] and in [-20, 20])."""
    x_t = torch.randint(-127, 128, shape, generator=g, device=DEVICE, dtype=torch.int8)
    if mix == "sparse":
        lead, (m, k) = shape[:-2], shape[-2:]
        cls = sparse_classes(lead, m // 128, k // 128)
        cls = cls.repeat_interleave(128, dim=-2).repeat_interleave(128, dim=-1)
        wide = (torch.arange(k, device=DEVICE) // 128) % 2 == 0
        full = torch.randint(-254, 255, shape, generator=g, device=DEVICE, dtype=torch.int32)
        mid = torch.randint(-20, 21, shape, generator=g, device=DEVICE, dtype=torch.int32)
        low = torch.randint(-7, 8, shape, generator=g, device=DEVICE, dtype=torch.int32)
        d = torch.where(cls == 2, torch.where(wide, full, mid), torch.where(cls == 1, low, 0))
    elif mix == "lone":
        x_t = x_t.clamp(-100, 100)  # x_prev = x_t - Δ needs no clamp
        d = lone_delta(shape)
    elif mix == "zero":
        d = torch.zeros(shape, dtype=torch.int32, device=DEVICE)
    elif mix == "low":
        d = torch.randint(-7, 8, shape, generator=g, device=DEVICE, dtype=torch.int32)
    elif mix == "edge":
        sign = 1 - 2 * torch.randint(0, 2, shape, generator=g, device=DEVICE, dtype=torch.int32)
        d = torch.randint(7, 9, shape, generator=g, device=DEVICE, dtype=torch.int32) * sign
    else:  # full
        d = torch.randint(-254, 255, shape, generator=g, device=DEVICE, dtype=torch.int32)
        d[..., :128, :128] = 0
    return x_t, (x_t.to(torch.int32) - d).clamp(-127, 127).to(torch.int8)


INT8_MIXES = ("random", "extreme", "corner")


def int8_operands(g, lead, m, k, n, mix, w_transposed=True):
    """(x, W) int8 on the card for ``int8_matmul``; W (N, K) when
    ``w_transposed``, else (K, N). random: uniform over all 256 values;
    extreme: every lane -128, -127 or 127; corner: extreme, but x's first
    half of rows all -128 and W all -128 for the first half of the output
    columns and 127 for the rest, so those outputs reach +128 * 128 * K and
    -128 * 127 * K."""
    def draw(shape):
        if mix == "random":
            return torch.randint(-128, 128, shape, generator=g, device=DEVICE, dtype=torch.int8)
        pick = torch.randint(0, 3, shape, generator=g, device=DEVICE)
        return torch.tensor([-128, -127, 127], dtype=torch.int8, device=DEVICE)[pick]

    x, w = draw(lead + (m, k)), draw(lead + (n, k))
    if mix == "corner":
        x[..., : m // 2, :] = -128
        w[..., : n // 2, :] = -128
        w[..., n // 2:, :] = 127
    return x, (w if w_transposed else w.transpose(-1, -2).contiguous())


def phase_parity() -> dict:
    g = torch.Generator(device=DEVICE).manual_seed(1)
    max_err = dict.fromkeys(KERNELS, 0)
    checks = 0

    def hold(name, got, want):
        nonlocal checks
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item() if got.numel() else 0
        max_err[name] = max(max_err[name], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} disagrees with its plain version (max |err| {err})")
        checks += 1

    def hold_fused(got, want):
        """The fused encode's classes in full, its Δ-cache on the tiles whose
        class gates it in."""
        (cls, dc, dh), (want_c, want_dc, want_dh) = got, want
        hold("diff_encode_fused", cls, want_c)
        live = ref.tile_mask(want_c, (128, 64), lambda c: c >= 1)
        full = ref.tile_mask(want_c, (128, 128), lambda c: c == 2)
        hold("diff_encode_fused", dc[live], want_dc[live])
        hold("diff_encode_fused", dh[full], want_dh[full])

    for lead, m, k, n, wt in PATH_SHAPES:
        for mix in INT8_MIXES:
            x, w = int8_operands(g, lead, m, k, n, mix, wt)
            hold("int8_matmul", k_int8.int8_matmul(x, w, w_transposed=wt),
                 ref.int8_matmul_ref(x, w, w_transposed=wt))
        w = torch.randint(-127, 128, lead + ((n, k) if wt else (k, n)), generator=g,
                          device=DEVICE, dtype=torch.int8)
        for mix in MIXES:
            x_t, x_p = delta_pair(g, lead + (m, k), mix)
            want_cls = ref.diff_encode_ref(x_t, x_p, (128, 128))
            want_fused = ref.diff_encode_fused_ref(x_t, x_p, (128, 128))
            cls = k_encode.diff_encode(x_t, x_p)
            hold("diff_encode", cls, want_cls)
            cls_f, dc, dh = k_fused.diff_encode_fused(x_t, x_p)
            hold_fused((cls_f, dc, dh), want_fused)
            for c in common.ENCODE_CLUSTERS:  # each tile forced over c blocks
                hold("diff_encode", k_encode.launch(x_t, x_p, c), want_cls)
                hold_fused(k_fused.launch_encode(x_t, x_p, c), want_fused)
            y_prev = torch.randint(-2**24, 2**24, lead + (m, n), generator=g, device=DEVICE,
                                   dtype=torch.int32)
            bare = ref.ditto_fused_matmul_ref(w, dc, dh, cls_f, w_transposed=wt)
            for yp in (y_prev, None):
                want = ref.ditto_diff_matmul_ref(x_t, x_p, w, yp, cls, w_transposed=wt)
                hold("ditto_diff_matmul",
                     k_diff.ditto_diff_matmul(x_t, x_p, w, yp, cls, w_transposed=wt), want)
                hold(DIFF4, k_diff.ditto_diff_matmul(x_t, x_p, w, yp, cls, low_bits=4,
                                                     w_transposed=wt),
                     ref.ditto_diff_matmul_ref(x_t, x_p, w, yp, cls, w_transposed=wt,
                                               low_bits=4))
                got = k_fused.ditto_fused_matmul(w, dc, dh, cls_f, yp, w_transposed=wt)
                hold("ditto_fused_matmul", got, bare if yp is None else bare + yp)
                hold("ditto_fused_matmul", got, want)  # and the two-pass function
        splits = common.diff_gemm_splits(math.prod(lead), m, n, k)
        cluster = common.encode_cluster(math.prod(lead) * (m // 128) * (k // 128),
                                        common.sm_count(torch.device(DEVICE)))
        say(f"parity ok  lead={lead} M={m} K={k} N={n} w_transposed={wt} K splits={splits} "
            f"encode cluster={cluster}")

    # every K split count a cluster can take (the path launches 1, 3 and 5),
    # forced at wd's shape: the DSMEM reduction's share of the tile's
    # vectors differs for each count
    lead, m, k, n = SPLIT_SHAPE
    for mix in INT8_MIXES:
        x, w = int8_operands(g, lead, m, k, n, mix)
        want = ref.int8_matmul_ref(x, w, w_transposed=True)
        for splits in range(1, MAX_SPLITS + 1):
            hold("int8_matmul", k_int8.launch(x, w, splits), want)
    w = torch.randint(-127, 128, lead + (n, k), generator=g, device=DEVICE, dtype=torch.int8)
    for mix in ("full", "sparse"):
        x_t, x_p = delta_pair(g, lead + (m, k), mix)
        cls = k_encode.diff_encode(x_t, x_p)
        cls_f, dc, dh = k_fused.diff_encode_fused(x_t, x_p)
        y_prev = torch.randint(-2**24, 2**24, lead + (m, n), generator=g, device=DEVICE,
                               dtype=torch.int32)
        for yp in (y_prev, None):
            want = ref.ditto_diff_matmul_ref(x_t, x_p, w, yp, cls, w_transposed=True)
            want4 = ref.ditto_diff_matmul_ref(x_t, x_p, w, yp, cls, w_transposed=True,
                                              low_bits=4)
            for splits in range(1, MAX_SPLITS + 1):
                hold("ditto_diff_matmul", k_diff.launch(x_t, x_p, w, yp, cls, 8, splits), want)
                hold(DIFF4, k_diff.launch(x_t, x_p, w, yp, cls, 4, splits), want4)
                hold("ditto_fused_matmul",
                     k_fused.launch_matmul(w, dc, dh, cls_f, yp, splits), want)
    say(f"parity ok  forced K splits 1..{MAX_SPLITS} lead={lead} M={m} K={k} N={n}")
    say(f"parity: {checks} checks bit-exact, max |err| {max_err}")
    return max_err


# ------------------------------------------------------------------- slice
WRAPPERS = ("int8_matmul", "diff_encode", "ditto_diff_matmul", "diff_encode_fused",
            "ditto_fused_matmul")


class Capture:
    """Wraps the kernel entry points that ``ops`` calls: counts calls per
    (kernel, shape) and keeps the last call's arguments at each shape, so
    phase 4 times every kernel on the inputs the main path gave it (a diff
    GEMM call with ``low_bits=4`` counts as its own kernel). It also wraps
    the two ``ops`` functions the compiled pass calls, to note each call's
    (M, K, N) before ``ops`` pads it to the 128-tile grid."""

    def __init__(self):
        self.calls: dict = {}
        self.last: dict = {}
        self.unpadded = None
        self.orig = {name: getattr(ops, name) for name in WRAPPERS}
        self.orig_ops = (ops.int8_act_matmul, ops.ditto_linear_step)
        for name, fn in self.orig.items():
            setattr(ops, name, self._wrap(name, fn))
        ops.int8_act_matmul = self._note_unpadded(self.orig_ops[0], w_at=1)
        ops.ditto_linear_step = self._note_unpadded(self.orig_ops[1], w_at=2)

    def _note_unpadded(self, fn, w_at):
        def wrapped(*args, **kw):
            x, w = args[0], args[w_at]
            self.unpadded = (*x.shape[-2:], w.shape[-2] if kw.get("w_transposed") else w.shape[-1])
            return fn(*args, **kw)
        return wrapped

    def _wrap(self, wrapper, fn):
        def wrapped(*args, **kw):
            name = DIFF4 if kw.get("low_bits") == 4 else wrapper
            key = (name, tuple(tuple(a.shape) if a is not None else None for a in args[:3]),
                   args[Y_PREV_AT[name]] is not None if name in Y_PREV_AT else None,
                   kw.get("w_transposed", False), self.unpadded)
            self.calls[key] = self.calls.get(key, 0) + 1
            self.last[key] = (args, kw)
            return fn(*args, **kw)
        return wrapped

    def close(self):
        for name, fn in self.orig.items():
            setattr(ops, name, fn)
        ops.int8_act_matmul, ops.ditto_linear_step = self.orig_ops


def dense_weights(tree):
    """Every dense weight ("w" leaf) of a param tree."""
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from dense_weights(v)
        elif key == "w":
            yield v


def serve(params, sched, x_T, labels, plan):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records, sample, eng = harness.serve_records(params, CFG, sched, x_T, labels, plan, device=DEVICE)
    torch.cuda.synchronize()
    return records, sample, time.perf_counter() - t0


def tile_hists(records) -> dict:
    """(layer, step) -> the tile-class histogram of every compiled diff record."""
    return {(r["layer"], r["step"]): r["tile_hist"] for r in records if "tile_hist" in r}


def step_calls(calls_after: dict, calls_before: dict, n_compiled: int) -> dict:
    """Calls per compiled step of each (kernel, shape) key over one run,
    from Capture.calls before and after it; printed."""
    out = {key: (c - calls_before.get(key, 0)) / n_compiled
           for key, c in calls_after.items() if c != calls_before.get(key, 0)}
    for key, c in sorted(out.items(), key=str):
        say(f"  per compiled step: {c:g} x {key[0]} args {key[1]} y_prev={key[2]} "
            f"w_transposed={key[3]} unpadded (M, K, N) {key[4]}")
    return out


def make_model():
    """DiT-XL/2 params (random, from a seed) on the card, the slice's B = 2
    request (x_T, labels) and the noise schedule."""
    g = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    params = dit.init(g, CFG, device=DEVICE)
    # adaLN-Zero zeroes every block's gates, which would leave the blocks
    # out of the sample: give the mod projections N(0, 0.02) weights
    params["blocks"]["mod"]["w"].normal_(0.0, 0.02, generator=g)
    n_weights = sum(w.numel() for w in dense_weights(params))
    say(f"model: DiT-XL/2 init {time.perf_counter() - t0:.2f} s, "
        f"{n_weights / 1e6:.1f} M dense weights")
    x_T = torch.randn((B, CFG.input_size, CFG.input_size, CFG.in_channels), generator=g,
                      device=DEVICE)
    labels = torch.randint(0, CFG.n_classes, (B,), generator=g, device=DEVICE)
    return params, x_T, labels, diffusion.linear_schedule(1000)


def phase_slice(cap: Capture, params, x_T, labels, sched) -> tuple[dict, dict, dict, dict]:
    zero_counts()
    per_policy: dict = {}
    walls: dict = {}
    eager_by_policy: dict = {}
    hists_by_policy: dict = {}
    steps_by_run: dict = {}
    for policy in ("act", "diff", "defo"):
        before = launch_counts()
        calls_before = dict(cap.calls)
        recs, sample, wall = serve(params, sched, x_T, labels, DittoPlan(steps=STEPS, policy=policy))
        after = launch_counts()
        per_policy[policy] = {n: after[n] - before[n] for n in after}
        n_compiled = len({r["step"] for r in recs if r.get("compiled")})
        calls_after = dict(cap.calls)
        _, eager, wall_eager = serve(params, sched, x_T, labels,
                                     DittoPlan(steps=STEPS, policy=policy, compiled=False))
        if launch_counts() != after:
            raise AssertionError("the eager-only pass launched a kernel")
        if sample.shape != x_T.shape or not torch.isfinite(sample).all():
            raise AssertionError(f"{policy}: sample is not finite or has the wrong shape")
        if not torch.equal(sample, eager):
            diff = (sample - eager).abs().max().item()
            raise AssertionError(f"{policy}: compiled sample differs from eager (max {diff})")
        eager_by_policy[policy], hists_by_policy[policy] = eager, tile_hists(recs)
        if policy == "diff":
            diff_run = dict(sample=sample, records=recs)
        modes = {}
        for r in recs:
            if r["step"] == STEPS - 1:
                modes[r["mode"]] = modes.get(r["mode"], 0) + 1
        walls[policy] = dict(compiled_s=wall, eager_s=wall_eager, compiled_steps=n_compiled)
        say(f"slice {policy}: compiled == eager bit-identical; wall {wall:.2f} s "
            f"({n_compiled} compiled steps), eager-only {wall_eager:.2f} s; "
            f"launches {per_policy[policy]}; last-step modes {modes}; "
            f"sample |x| mean {sample.abs().mean().item():.4f}")
        if policy == "diff":  # the serving fast path: no class statistics
            _, bare, wall_bare = serve(params, sched, x_T, labels,
                                       DittoPlan(steps=STEPS, policy=policy, collect_stats=False))
            if not torch.equal(bare, sample):
                raise AssertionError("collect_stats=False changed the diff sample")
            walls["diff_no_stats"] = dict(compiled_s=wall_bare, compiled_steps=n_compiled)
            say(f"slice diff, collect_stats=False: same sample; wall {wall_bare:.2f} s")
        steps_by_run[policy] = step_calls(calls_after, calls_before, n_compiled)
    # the packed-int4 branch and the fused flow, each held to the eager
    # sample and the two-pass tile histograms of its policy
    for policy, kw in (("diff", dict(low_bits=4)), ("diff", dict(fused=True)),
                       ("defo", dict(low_bits=4, fused=True))):
        label = policy + "".join(f" {k}={v}" for k, v in kw.items())
        before = launch_counts()
        calls_before = dict(cap.calls)
        recs, sample, wall = serve(params, sched, x_T, labels,
                                   DittoPlan(steps=STEPS, policy=policy, **kw))
        after = launch_counts()
        per_policy[label] = {n: after[n] - before[n] for n in after}
        n_compiled = len({r["step"] for r in recs if r.get("compiled")})
        if sample.shape != x_T.shape or not torch.isfinite(sample).all():
            raise AssertionError(f"{label}: sample is not finite or has the wrong shape")
        if not torch.equal(sample, eager_by_policy[policy]):
            diff = (sample - eager_by_policy[policy]).abs().max().item()
            raise AssertionError(f"{label}: compiled sample differs from eager (max {diff})")
        hists = tile_hists(recs)
        if hists != hists_by_policy[policy]:
            raise AssertionError(f"{label}: tile-class histograms differ from the "
                                 f"low_bits=8 two-pass run")
        tiles = [sum(h[c] for h in hists.values()) for c in range(3)]
        walls[label] = dict(compiled_s=wall, compiled_steps=n_compiled)
        say(f"slice {label}: compiled == eager bit-identical, tile histograms == two-pass; "
            f"wall {wall:.2f} s ({n_compiled} compiled steps); launches {per_policy[label]}; "
            f"tiles over the compiled steps (zero, low, full) {tiles}")
        steps_by_run[label] = step_calls(cap.calls, calls_before, n_compiled)
    totals = launch_counts()
    say(f"slice launches (all runs): {totals}")
    missing = [n for n, c in totals.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    return totals, walls, steps_by_run, diff_run


# ----------------------------------------------------------------- serving
SERVE_ROWS = (1, 3, 2, 4)  # buckets 1, 4, 2, 4; the 2-row request is the slice's
WATCHDOG_ROWS = (3, 2)
# the kernels each serving run must launch from its replayed graphs
RUN_KERNELS = {"diff": ("diff_encode", "ditto_diff_matmul"),
               "diff no stats": ("diff_encode", "ditto_diff_matmul"),
               "schedule": ("diff_encode", "ditto_diff_matmul", DIFF4, "diff_encode_fused",
                            "ditto_fused_matmul"),
               "watchdog drift": ("diff_encode", "ditto_diff_matmul", "int8_matmul"),
               "watchdog poison": ("diff_encode", "ditto_diff_matmul", "int8_matmul")}
WATCHDOG_STEPS = 10  # the watchdog runs are held to uncached runs with statistics
# the faults of the watchdog runs, at a denoise.step arrival (compiled step)
DRIFT = Fault("denoise.step", 3, "drift", value=64.0)
POISON = Fault("denoise.step", 4, "poison_nan")
LADDER_PROBE = (8, 16)  # buckets whose graphs the phase captures only to read their memory


class StepClock:
    """Wall time of every compiled step (``CompiledDittoDiT.__call__``,
    record reading included), the card synchronised before and after; keyed
    by whether the runner cache served it (a graph replay) and the bucket.
    Also the wall of every arena snapshot the watchdog takes before a
    guarded step."""

    def __init__(self):
        self.walls: dict = {}
        self.snaps: dict = {}
        self.orig = dit_runner.CompiledDittoDiT.__call__
        self.orig_snapshot = serve_cache.ArenaState.snapshot
        clock = self

        def timed(runner, latents, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = clock.orig(runner, latents, *args, **kw)
            torch.cuda.synchronize()
            key = (isinstance(runner._step, serve_cache._Runner), latents.shape[0])
            clock.walls.setdefault(key, []).append(time.perf_counter() - t0)
            return out

        def timed_snapshot(state):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = clock.orig_snapshot(state)
            torch.cuda.synchronize()
            rows = state["blk0.wq"]["x_prev"].shape[0]
            clock.snaps.setdefault(rows, []).append(time.perf_counter() - t0)
            return out

        dit_runner.CompiledDittoDiT.__call__ = timed
        serve_cache.ArenaState.snapshot = timed_snapshot

    def take(self, cached: bool) -> dict:
        """Median ms per bucket of the steps timed since the last take."""
        out = {b: statistics.median(w) * 1e3 for (c, b), w in self.walls.items() if c == cached}
        self.walls = {k: w for k, w in self.walls.items() if k[0] != cached}
        return out

    def take_snapshots(self, tokens: int) -> dict:
        """Median ms per bucket of the watchdog's arena snapshots since the
        last take (a token layer's state holds bucket x ``tokens`` rows)."""
        out = {rows // tokens: statistics.median(w) * 1e3 for rows, w in self.snaps.items()}
        self.snaps = {}
        return out

    def close(self):
        dit_runner.CompiledDittoDiT.__call__ = self.orig
        serve_cache.ArenaState.snapshot = self.orig_snapshot


def phase_serve(params, x_T, labels, sched, diff_run) -> dict:
    """ServeSession at DiT-XL/2 through one runner cache (one CUDA graph per
    key), each sample held bit for bit to uncached ``serve_records`` at the
    same bucket."""
    g = torch.Generator(device=DEVICE).manual_seed(2)
    reqs = []
    for n in SERVE_ROWS:
        if n == B:
            reqs.append((x_T, labels))
        else:
            reqs.append((torch.randn((n,) + tuple(x_T.shape[1:]), generator=g, device=DEVICE),
                         torch.randint(0, CFG.n_classes, (n,), generator=g, device=DEVICE)))
    base = DittoPlan(steps=STEPS, policy="diff", max_batch=4)
    bare = base.replace(collect_stats=False)
    third = STEPS // 3
    schedule = PlanSchedule(bare, [(0, third, {}), (third, 2 * third, dict(low_bits=4)),
                                   (2 * third, STEPS, dict(low_bits=4, fused=True))])
    watchdog = base.replace(steps=WATCHDOG_STEPS, watchdog=True, reanchor_full_frac=0.9)
    guarded = watchdog.replace(reanchor_full_frac=None)
    armed = lambda fault: (contextlib.nullcontext() if fault is None
                           else inject(FaultInjector([fault])))
    cache = CompiledRunnerCache()
    sess = ServeSession(params, CFG, sched, base, cache=cache)
    clock = StepClock()
    out: dict = {"runs": {}, "mem_gib": []}

    def ref(x, lab, plan, bucket, fault=None):
        with armed(fault):
            recs, sample, eng = harness.serve_records(params, CFG, sched, x, lab, plan,
                                                      bucket=bucket, device=DEVICE)
        torch.cuda.synchronize()
        return sample, eng

    try:
        # uncached references (no statistics: the sample does not depend on them)
        bare_ref = [ref(x, lab, bare, bucket_for(x.shape[0], max_batch=4))[0]
                    for x, lab in reqs]
        out["uncached_step_ms_no_stats"] = clock.take(False)
        for name, plan, rows, fault in (("diff", base, SERVE_ROWS, None),
                                        ("diff no stats", bare, SERVE_ROWS, None),
                                        ("schedule", schedule, SERVE_ROWS, None),
                                        ("watchdog drift", watchdog, WATCHDOG_ROWS, DRIFT),
                                        ("watchdog poison", guarded, WATCHDOG_ROWS, POISON)):
            zero_counts()
            caps0, replayed0 = dict(cache.capture_counts), cache.replayed_launches()
            walls, events = [], []
            if name == "diff no stats":  # its graphs captured before its first request
                warm = cache.warmup(CFG, modes, [plan], buckets=(1, 4, 2), params=sess.params)
                if warm["captures"] != 3:
                    raise AssertionError(f"warmup captured {warm}, want 3 graphs")
            for n in rows:
                x, lab = reqs[SERVE_ROWS.index(n)]
                bucket = bucket_for(n, max_batch=4)
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated() / 2**30
                with armed(fault) as inj:
                    res = sess.serve(x, lab, plan=plan)
                if fault is not None and len(inj.fired) != 1:
                    raise AssertionError(f"{name}: the {fault.kind} fault did not fire")
                # (run, bucket, held before the request, peak in it)
                out["mem_gib"].append((name, bucket, held,
                                       torch.cuda.max_memory_allocated() / 2**30))
                walls.append((n, bucket, res.wall_s))
                chunk = res.chunks[0]
                modes = chunk.engine.compiled_modes()
                if name == "diff no stats" and res.captures_delta:
                    raise AssertionError(f"{name}: {n} rows captured after the warmup")
                events.append(chunk.engine.watchdog_events)
                if name in ("diff", "diff no stats"):
                    want = bare_ref[SERVE_ROWS.index(n)]
                else:
                    want, reng = ref(x, lab, plan, bucket, fault)
                    if fault is not None and reng.watchdog_events != chunk.engine.watchdog_events:
                        raise AssertionError(
                            f"{name}: re-anchors {chunk.engine.watchdog_events}, uncached "
                            f"{reng.watchdog_events}")
                    if fault is POISON:
                        if [e["trigger"] for e in reng.watchdog_events] != ["nonfinite"]:
                            raise AssertionError(f"{name}: uncached re-anchors "
                                                 f"{reng.watchdog_events}, want one nonfinite")
                        rolled = [r for r in chunk.engine.records if r.get("reanchor")]
                        if not rolled or rolled != [r for r in reng.records if r.get("reanchor")]:
                            raise AssertionError(f"{name}: the re-anchor's records differ "
                                                 "from uncached (the arena's rollback)")
                if res.sample.shape != x.shape or not torch.isfinite(res.sample).all():
                    raise AssertionError(f"{name}: {n} rows: sample not finite or misshapen")
                if not torch.equal(res.sample, want):
                    d = (res.sample - want).abs().max().item()
                    raise AssertionError(f"{name}: {n} rows (bucket {bucket}): session sample "
                                         f"differs from uncached serve_records (max {d})")
                if name == "diff" and n == B:  # the slice's own request and plan
                    if not torch.equal(res.sample, diff_run["sample"]):
                        raise AssertionError("diff: session sample differs from the slice's")
                    if tile_hists(res.records) != tile_hists(diff_run["records"]):
                        raise AssertionError("diff: session tile histograms differ from the "
                                             "slice's uncached run")
                if fault is not None and not chunk.engine.watchdog_events:
                    raise AssertionError(f"{name}: the {fault.kind} triggered no re-anchor")
            replayed1 = cache.replayed_launches()
            new_keys = [k for k, c in cache.capture_counts.items() if c != caps0.get(k, 0)]
            captured = {}
            for k in new_keys:
                for kern, c in cache.capture_launches.get(k, {}).items():
                    captured[kern] = captured.get(kern, 0) + c
            replayed = {k: replayed1.get(k, 0) - replayed0.get(k, 0) for k in replayed1}
            ticks = launch_counts()
            executed = {k: ticks[k] - captured.get(k, 0) + replayed.get(k, 0) for k in ticks}
            idle = [k for k in RUN_KERNELS[name] if not replayed.get(k)]
            if idle:
                raise AssertionError(f"{name}: no launch of {idle} from a replayed graph")
            out["runs"][name] = dict(
                sample_walls_s=walls, watchdog_events=events,
                captures={"/".join(sorted({m for _, m in k.mode_sig}))
                          + f" {k.plan_sig} bucket {k.bucket}": cache.capture_counts[k]
                          for k in new_keys},
                launches_executed={k: v for k, v in executed.items() if v},
                launches_replayed={k: v for k, v in replayed.items() if v},
                replayed_step_ms=clock.take(True), uncached_step_ms=clock.take(False),
                snapshot_ms=clock.take_snapshots(CFG.n_tokens))
            say(f"serve {name}: every sample == uncached serve_records; "
                f"{json.dumps(out['runs'][name])}")
        if any(c != 1 for c in cache.capture_counts.values()):
            raise AssertionError(f"captures per key: {cache.capture_counts}")
        # the PLMS sampler keeps earlier steps' eps: each replay must hand
        # back its own copy (same runner as DDIM: the sampler is no key field)
        x, lab = reqs[SERVE_ROWS.index(B)]
        plms = bare.replace(sampler="plms")
        res = sess.serve(x, lab, plan=plms)
        if res.captures_delta or not torch.equal(res.sample, ref(x, lab, plms, B)[0]):
            raise AssertionError("plms: the session sample differs from uncached (or it "
                                 "captured a new graph)")
        say(f"serve plms: session sample == uncached serve_records, no new capture; wall "
            f"{res.wall_s:.2f} s")
        # bucket 4's sample equals the unbucketed run of its 3 rows: the fp32
        # glue's products give each row the same bits at either batch size
        x, lab = reqs[SERVE_ROWS.index(3)]
        if not torch.equal(ref(x, lab, bare, None)[0], bare_ref[SERVE_ROWS.index(3)]):
            raise AssertionError("bucket 4's sample differs from the unbucketed 3-row run")
        # the memory the next rungs of the bucket ladder take: their graphs
        # and arenas, captured by warmup
        for bucket in LADDER_PROBE:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 2**30
            cache.warmup(CFG, modes, [bare], buckets=(bucket,), params=sess.params)
            out["mem_gib"].append(("warmup", bucket, held,
                                   torch.cuda.max_memory_allocated() / 2**30))
    finally:
        clock.close()
    out["cache"] = cache.stats()
    say(f"serve: captures per key all 1 ({cache.stats()}); memory (run, bucket, held before, "
        f"peak in it; GiB) {json.dumps(out['mem_gib'])}, held after "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    return out


# --------------------------------------------------------------- scheduler
SCHED_STEPS = 10
SCHED_ROWS = (3, 3, 2)  # one by one: buckets 4, 4, 2; coalesced: 4 + 4
DEADLINE_MS = 200.0  # the lone request's budget
INTERVAL_MS = 25.0  # the async policy's granularity
# the kernels the phase's plans run (diff, fused, a low_bits=4 segment, act)
SCHED_KERNELS = tuple(KERNELS)
WAIT_S = 300.0  # every result() of the phase


def phase_scheduler(params, sched) -> dict:
    """ServeScheduler at DiT-XL/2: coalescing, deadlines, concurrent clients
    on a cold cache, warmup, the degradation ladder and chaos, every ticket
    held bit for bit to the same rows served alone."""
    gc.collect()  # the serve phase's caches hold graphs and arenas
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    zero_counts()
    g = torch.Generator(device=DEVICE).manual_seed(3)

    def request(n, gen=g):
        return (torch.randn((n, CFG.input_size, CFG.input_size, CFG.in_channels), generator=gen,
                            device=DEVICE),
                torch.randint(0, CFG.n_classes, (n,), generator=gen, device=DEVICE))

    def equal(name, got, want):
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"scheduler {name}: rows not finite or misshapen")
        if not torch.equal(got, want):
            d = (got - want).abs().max().item()
            raise AssertionError(f"scheduler {name}: rows differ from the same rows served "
                                 f"alone (max {d})")

    def no_ladder(name, st, fired=()):
        """A run with no session.serve fault took no rung of the ladder (on
        the card a kernel, capture or replay error fails its tickets)."""
        if (not any(f.site == "session.serve" for f in fired)
                and (st["retries"], st["fallback_dispatches"]) != (0, 0)):
            raise AssertionError(f"scheduler {name}: {st['retries']} retries, "
                                 f"{st['fallback_dispatches']} fallback dispatches "
                                 f"with no session.serve fault")

    base = DittoPlan(steps=SCHED_STEPS, policy="diff", max_batch=4, collect_stats=False)
    caches = []
    out: dict = {}

    def fresh_cache():
        caches.append(CompiledRunnerCache())
        return caches[-1]

    # ---- sync coalescing: 3 + 3 + 2 as 4 + 4, both walls warm
    cache = fresh_cache()
    sess = ServeSession(params, CFG, sched, base, cache=cache)
    reqs = [request(n) for n in SCHED_ROWS]
    solo = [sess.serve(x, lab).sample for x, lab in reqs]  # captures buckets 4 and 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_by_one = [sess.serve(x, lab) for x, lab in reqs]
    torch.cuda.synchronize()
    wall_solo = time.perf_counter() - t0
    for i, res in enumerate(one_by_one):
        equal(f"one by one {i}", res.sample, solo[i])
    s = ServeScheduler(params, CFG, sched, base, cache=cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = [s.submit(x, lab) for x, lab in reqs]
    s.flush()
    rows = [t.result() for t in tickets]
    torch.cuda.synchronize()
    wall_coal = time.perf_counter() - t0
    st = s.stats()
    if (st["dispatches"], st["triggers"]["full"], s.pad_rows, s.naive_pad_rows()) != (2, 2, 0, 2):
        raise AssertionError(f"scheduler sync: {st}, pad rows {s.pad_rows} "
                             f"(one by one {s.naive_pad_rows()}); want 4 + 4, no pad row")
    no_ladder("sync", st)
    for i, r in enumerate(rows):
        equal(f"sync ticket {i}", r, solo[i])
    out["sync"] = dict(dispatches=st["dispatches"], triggers=st["triggers"], pad_rows=s.pad_rows,
                       pad_rows_one_by_one=sum(r.pad_rows for r in one_by_one),
                       wall_s=wall_coal, wall_one_by_one_s=wall_solo)
    say(f"scheduler sync: 3 + 3 + 2 rows -> 4 + 4, 0 pad rows (one by one 2), every ticket == "
        f"its solo serve; wall {wall_coal:.3f} s coalesced, {wall_solo:.3f} s one by one")

    # ---- async: a lone request's deadline partial
    latencies = []
    lone = request(1)
    solo_lone = sess.serve(*lone).sample
    s = ServeScheduler(params, CFG, sched, base, cache=cache, async_mode=True,
                       dispatch_interval_ms=INTERVAL_MS)
    with s:
        t = s.submit(*lone, deadline_ms=DEADLINE_MS)
        until = time.monotonic() + WAIT_S
        while not t.done and time.monotonic() < until:  # result() would demand it at once
            time.sleep(0.002)
        equal("deadline partial", t.result(timeout=WAIT_S), solo_lone)
        st = s.stats()
    if st["triggers"]["deadline"] != 1 or st["dispatches"] != 1:
        raise AssertionError(f"scheduler deadline: {st['triggers']}, want one deadline partial")
    no_ladder("deadline", st)
    latencies.append(t.done_t - t.submit_t)
    out["deadline"] = dict(deadline_ms=DEADLINE_MS, latency_s=latencies[-1],
                           missed=st["deadline_misses"])
    say(f"scheduler deadline: a lone 1-row request dispatched as a deadline partial; latency "
        f"{latencies[-1]:.3f} s against a {DEADLINE_MS:.0f} ms budget")

    # ---- async: four clients, mixed plans, a cold cache, no warmup
    cache2 = fresh_cache()
    half = SCHED_STEPS // 2
    client_plans = [base, base.replace(fused=True),
                    PlanSchedule(base, [(0, half, {}), (half, SCHED_STEPS, dict(low_bits=4))]),
                    base.replace(policy="act")]
    inputs, got, errors = {}, {}, []
    s = ServeScheduler(params, CFG, sched, base, cache=cache2, async_mode=True,
                       dispatch_interval_ms=INTERVAL_MS)

    def client(c):
        try:
            gen = torch.Generator(device=DEVICE).manual_seed(100 + c)
            tickets = []
            for j in range(2):
                inputs[(c, j)] = request(1 + (c + 2 * j) % 3, gen)  # made on the card, here
                tickets.append((j, s.submit(*inputs[(c, j)], plan=client_plans[c],
                                            deadline_ms=400.0 if j else None)))
            for j, t in tickets:
                rows = t.result(timeout=WAIT_S)
                if not bool(torch.isfinite(rows).all()):  # a synchronize on this thread
                    raise AssertionError(f"client {c}: non-finite rows")
                got[(c, j)] = (rows, t.done_t - t.submit_t)
        except Exception as e:  # raised below
            errors.append((c, e))

    with s:
        threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT_S)
        st = s.stats()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"scheduler clients: {errors or 'a client did not finish'}")
    no_ladder("clients", st)
    for (c, j), (x, lab) in sorted(inputs.items()):
        equal(f"client {c} request {j}", got[(c, j)][0],
              sess.serve(x, lab, plan=client_plans[c]).sample)
        latencies.append(got[(c, j)][1])
    if any(n != 1 for n in cache2.capture_counts.values()):
        raise AssertionError(f"scheduler clients: captures per key {cache2.capture_counts}")
    lat = sorted(latencies)
    out["clients"] = dict(dispatches=st["dispatches"], triggers=st["triggers"],
                          pad_rows=st["pad_rows"], deadline_misses=st["deadline_misses"],
                          keys=len(cache2), captures=cache2.n_captures)
    out["latency_s"] = dict(p50=statistics.median(lat),
                            p99=lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)],
                            n=len(lat))
    say(f"scheduler clients: 4 threads, 8 requests, 4 plans, cold cache: every ticket == its "
        f"solo serve, {len(cache2)} keys captured once each on the dispatch thread; "
        f"{json.dumps(out['clients'])}; latency {json.dumps(out['latency_s'])}")

    # ---- warmup: the ladder 1, 2, 4 captured first; the first requests capture nothing
    cache3 = fresh_cache()
    s = ServeScheduler(params, CFG, sched, base, cache=cache3)
    w = s.warmup(buckets=[1, 2, 4])
    for name, (x, lab), want in (("3 rows", reqs[0], solo[0]), ("1 row", lone, solo_lone),
                                 ("2 rows", reqs[2], solo[2])):
        equal(f"after warmup, {name}", s.submit(x, lab).result(), want)
    st = s.stats()
    if w["captures"] != 3 or st["captures_after_warmup"] != 0:
        raise AssertionError(f"scheduler warmup: {w}, then {st['captures_after_warmup']} "
                             f"captures; want 3, then 0")
    no_ladder("warmup", st)
    out["warmup"] = dict(w, captures_after_warmup=st["captures_after_warmup"])
    say(f"scheduler warmup: {json.dumps(out['warmup'])}")

    # ---- the ladder: fused -> two-pass -> eager, bit-identical
    ladder = base.replace(fused=True, max_retries=2,
                          fallbacks=({"fused": False}, {"compiled": False}))
    x, lab = reqs[0]
    s = ServeScheduler(params, CFG, sched, ladder, cache=cache)
    want = s.submit(x, lab).result()
    no_ladder("ladder, no fault", s.stats())
    out["ladder"] = {}
    for arrivals, rung in (((0,), (8, False, True)), ((0, 1), (8, True, False))):
        s = ServeScheduler(params, CFG, sched, ladder, cache=cache)
        with inject(FaultInjector([Fault("session.serve", a, "error") for a in arrivals])) as inj:
            t = s.submit(x, lab)
            rows = t.result()
        used = t.served_with
        if len(inj.fired) != len(arrivals) or (used.low_bits, used.fused, used.compiled) != rung:
            raise AssertionError(f"scheduler ladder: fired {inj.fired}, served with {used}")
        equal(f"ladder rung {len(arrivals)}", rows, want)
        out["ladder"][f"{len(arrivals)} fault(s)"] = dict(
            served_with=dict(low_bits=used.low_bits, fused=used.fused, compiled=used.compiled),
            retries=s.stats()["retries"], fallback_dispatches=s.stats()["fallback_dispatches"])
    # a take fault fails exactly its ticket; the thread serves on
    s = ServeScheduler(params, CFG, sched, base, cache=cache, async_mode=True,
                       dispatch_interval_ms=INTERVAL_MS)
    with s:
        with inject(FaultInjector([Fault("scheduler.take", 0, "error")])):
            t1 = s.submit(*reqs[0])
            try:
                t1.result(timeout=WAIT_S)
                raise AssertionError("scheduler take: the faulted ticket was served")
            except InjectedFault:
                pass
        equal("after a take fault", s.submit(*reqs[2]).result(timeout=WAIT_S), solo[2])
        st = s.stats()
    if (st["failed"], st["completed"], st["died"]) != (1, 1, False):
        raise AssertionError(f"scheduler take: {st}")
    no_ladder("take fault", st)
    say(f"scheduler ladder: {json.dumps(out['ladder'])}; a take fault failed its one ticket "
        f"and the thread served on")

    # ---- chaos: every ticket ends, with rows or a typed error
    sites = ("session.serve", "scheduler.policy", "scheduler.take", "scheduler.dispatch",
             "denoise.step")
    chaos = base.replace(max_retries=2, retry_backoff_ms=5.0, fallbacks=({"fused": False},),
                         watchdog=True)
    injector = chaos_schedule(11, 4, sites=sites, max_at=4)
    ends = []
    s = ServeScheduler(params, CFG, sched, chaos, cache=cache, async_mode=True,
                       dispatch_interval_ms=INTERVAL_MS)
    with inject(injector):
        tickets = []
        for n in (3, 4, 2, 4, 1):
            try:
                tickets.append(s.submit(*request(n)))
            except SchedulerDied as e:
                ends.append(type(e).__name__)
        for t in tickets:
            try:
                if not bool(torch.isfinite(t.result(timeout=WAIT_S)).all()):
                    raise AssertionError("scheduler chaos: non-finite rows")
                ends.append("rows")
            except (InjectedFault, DispatchFailed, SchedulerDied) as e:
                ends.append(type(e).__name__)
    try:
        s.close(join_timeout_s=WAIT_S)
    except SchedulerDied:
        pass  # a policy fault kills the thread; close still returns
    st = s.stats()
    if len(ends) != 5 or st["live_tickets"] or st["queued_rows"]:
        raise AssertionError(f"scheduler chaos: {ends}, {st}")
    no_ladder("chaos", st, injector.fired)
    out["chaos"] = dict(faults=[f"{f.kind}@{f.site}[{f.at}]" for f in injector.faults],
                        fired=len(injector.fired), ends=ends, retries=st["retries"],
                        watchdog_events=st["watchdog_events"])
    say(f"scheduler chaos: every ticket ended; {json.dumps(out['chaos'])}")

    # ---- the kernels ran from replayed graphs of this phase
    ticks = launch_counts()
    replayed: dict = {}
    for c in caches:
        for k, v in c.replayed_launches().items():
            replayed[k] = replayed.get(k, 0) + v
    idle = [k for k in SCHED_KERNELS if not replayed.get(k)]
    if idle:
        raise AssertionError(f"scheduler: no launch of {idle} from a replayed graph")
    out["launches"] = dict(captured=ticks, replayed=replayed)
    out["captures"] = sum(c.n_captures for c in caches)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------------- times
def median_ms(fn, flush, reps=30, warm=3) -> float:
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
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def work(name, args, unpadded) -> tuple[float, float]:
    """(operations, bytes) the call must do and move at the path's own
    (M, K, N), before ``ops`` padded it to the 128-tile grid: each input read
    once, each output written once. The diff GEMMs count only the non-zero
    tiles, at their unpadded extent, and the weight rows they meet; the
    fused pair counts the Δ-cache planes on the tiles whose class gates
    them in (``dc``, half a byte a Δ: class >= 1; ``dh``: class 2)."""
    m, k, n = unpadded
    x = args[2] if name == "ditto_fused_matmul" else args[0]
    bat = x.numel() // (x.shape[-2] * x.shape[-1])
    if name in ("diff_encode", "diff_encode_fused"):
        cls = ref.diff_encode_ref(args[0], args[1], (128, 128))
        nbytes = 2 * bat * m * k + 4 * cls.numel()
        if name == "diff_encode_fused":
            nbytes += tile_elems(cls >= 1, m, k) // 2 + tile_elems(cls == 2, m, k)
        return 0.0, float(nbytes)
    w = args[1] if name == "int8_matmul" else args[0] if name == "ditto_fused_matmul" else args[2]
    w_bat = w.numel() // (w.shape[-2] * w.shape[-1])
    if name == "int8_matmul":
        return 2.0 * bat * m * n * k, float(bat * m * k + w_bat * k * n + 4 * bat * m * n)
    cls = args[3] if name == "ditto_fused_matmul" else args[4]
    x_elems = tile_elems(cls != 0, m, k)  # Δ elements of live tiles
    cols = (k - 128 * torch.arange(cls.shape[-1], device=cls.device)).clamp(0, 128)
    w_rows = int(((cls != 0).to(torch.int64).amax(dim=-2) * cols).sum())  # weight rows met
    if name == "ditto_fused_matmul":
        x_bytes = x_elems // 2 + tile_elems(cls == 2, m, k)  # dc, and dh of class-2 tiles
    else:
        x_bytes = 2 * x_elems  # x_t and x_prev
    nbytes = x_bytes + w_rows * n + 4 * bat * m * n + 4 * cls.numel()
    if args[Y_PREV_AT[name]] is not None:
        nbytes += 4 * bat * m * n
    return 2.0 * x_elems * n, float(nbytes)


def tile_elems(pred: torch.Tensor, m: int, k: int) -> int:
    """Elements of the tiles where ``pred`` holds, at their unpadded extent."""
    rows = (m - 128 * torch.arange(pred.shape[-2], device=pred.device)).clamp(0, 128)
    cols = (k - 128 * torch.arange(pred.shape[-1], device=pred.device)).clamp(0, 128)
    return int((pred.to(torch.int64) * rows[:, None] * cols[None, :]).sum())


def plain(name, args, kw):
    wt = kw.get("w_transposed", False)
    if name == "int8_matmul":
        return lambda: ref.int8_matmul_ref(*args[:2], w_transposed=wt)
    if name == "diff_encode":
        return lambda: ref.diff_encode_ref(*args[:2], (128, 128))
    if name == "diff_encode_fused":
        return lambda: ref.diff_encode_fused_ref(*args[:2], (128, 128))
    if name == "ditto_fused_matmul":  # the reference's split form: y_prev added after
        def bare():
            return ref.ditto_fused_matmul_ref(*args[:4], w_transposed=wt)
        return bare if args[4] is None else lambda: bare() + args[4]
    return lambda: ref.ditto_diff_matmul_ref(*args[:5], (128, 128), w_transposed=wt,
                                             low_bits=kw.get("low_bits", 8))


def phase_times(cap: Capture) -> tuple[list[dict], dict]:
    """One row per (kernel, shape) key the slice called, and each key's bound."""
    # 1 GiB: clearing it evicts the 50 MB L2 and keeps the card busy for
    # ~0.3 ms, longer than the host takes to enqueue the timed launch, so
    # the events time the kernel and not the host's launch latency
    flush = torch.empty(2**30, dtype=torch.uint8, device=DEVICE)
    real = dict(cap.orig, **{DIFF4: cap.orig["ditto_diff_matmul"]})
    rows = []
    bounds = {}
    for key, (args, kw) in sorted(cap.last.items(), key=str):
        name = key[0]
        ops_n, nbytes = work(name, args, key[4])
        t_ops, t_bytes = ops_n / INT8_OPS_PER_S * 1e3, nbytes / BYTES_PER_S * 1e3
        row = dict(name=name, args=[list(a.shape) if a is not None else None for a in args[:3]],
                   unpadded_mkn=list(key[4]), y_prev=key[2], w_transposed=key[3],
                   ms=median_ms(lambda: real[name](*args, **kw), flush),
                   plain_ms=median_ms(plain(name, args, kw), flush, reps=20),
                   bound_ms=max(t_ops, t_bytes), bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=None, slice_calls=cap.calls[key])
        x, w = args[:2]
        if name == "int8_matmul" and x.dim() == 2:
            # torch._int_mm takes W as (K, N): once as a (K, N) contiguous
            # copy, once as the transposed view of the K-major weight (the
            # layout cuBLASLt's int8 path reads), both made before the clock
            w_nk = w if kw.get("w_transposed", False) else w.t().contiguous()
            w_kn = w_nk.t().contiguous()
            row["library_ms_kn_copy"] = median_ms(lambda: torch._int_mm(x, w_kn), flush)
            row["library_ms_nk_view"] = median_ms(lambda: torch._int_mm(x, w_nk.t()), flush)
            row["library_ms"] = min(row["library_ms_kn_copy"], row["library_ms_nk_view"])
        rows.append(row)
        bounds[key] = row["bound_ms"]
        say("time " + json.dumps(row))
    return rows, bounds


# -------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    path, build_s = common.build_library(verbose=True)
    say(f"build: {path.name} in {build_s:.1f} s")

    max_err = phase_parity()
    params, x_T, labels, sched = make_model()
    cap = Capture()
    try:
        totals, walls, steps_by_run, diff_run = phase_slice(cap, params, x_T, labels, sched)
    finally:
        cap.close()
    serving = phase_serve(params, x_T, labels, sched, diff_run)
    scheduling = phase_scheduler(params, sched)
    rows, bounds = phase_times(cap)
    # the least device time a compiled step needs for each kernel's calls,
    # in the run that launches it on every layer of its kind
    step_bound = {name: sum(c * bounds[key] for key, c in steps_by_run[run].items()
                            if key[0] == name)
                  for name, run in STEP_RUN.items()}
    say(f"bound per compiled step (ms): {json.dumps(step_bound)}")

    # the kernels line reports each kernel at the MLP up-projection (wi):
    # x (512, 1152) against W (1152, 4608), the path's largest linear
    kernels = []
    for name, k in KERNELS.items():
        pick = next(r for r in rows
                    if r["name"] == name and r["unpadded_mkn"] == [512, 1152, 4608])
        kernels.append(dict(name=name, route="cuda", source=k["source"], replaces=k["replaces"],
                            launches=totals[name], max_abs_err=max_err[name], ms=pick["ms"],
                            plain_ms=pick["plain_ms"], bound_ms=pick["bound_ms"],
                            bound_by=pick["bound_by"], library_ms=pick["library_ms"],
                            shape=pick["args"]))
    say(f"slice walls: {json.dumps(walls)}")
    say(f"serving: {json.dumps(serving)}")
    say(f"total {time.perf_counter() - t0:.1f} s")
    say("scheduler: " + json.dumps(scheduling))
    say(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    say(smi.stdout.strip())
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
