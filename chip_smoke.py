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
6. mesh    — ``ServeScheduler`` on a ``ServeMesh`` at DiT-XL/2, 10 DDIM
             steps, ``max_batch=4``, over two distinct cards where there are
             two, else the one card named twice (it prints which), the
             kernel counts zeroed first. (a) async, ``steal=True``: 6 full
             buckets in one group go to one owner shard; the other shard
             steals (``steals >= 1``, ``stolen_rows`` == its rows). (b) sync,
             ``steal=False``, three groups with ``max_retries=1,
             fallbacks=({"low_bits": 4},)`` and one ``session.serve`` fault
             on the second dispatch: exactly that ticket walks to
             ``low_bits=4``, the scheduler lives. (c) ``dp=2`` under Defo with
             statistics: the split dispatch's frozen modes, sample and
             records (by (layer, step), tile histograms included) equal the
             unsharded dispatch's. (d)
             ``warmup(buckets=[1, 2, 4])`` captures on both shards
             (``primed`` = the sibling's 3), then no shard captures. Every
             ticket equals solo ``ServeSession`` serving ``torch.equal``.
             (e) ``dp=2`` with ``plan.watchdog`` (statistics on, a ``drift``
             fault armed): the sample, ``watchdog_events`` and records
             equal the unsplit session's;
             ``int8_matmul``, ``diff_encode`` and both ``ditto_diff_matmul``
             branches must launch from the shards' replayed graphs, and
             both stealing shards must replay diff steps. It prints the
             2-shard and 1-shard walls of the same warm stream and the
             median dispatch wall of each (one host drives both shards),
             per-shard dispatches and rows, and peak memory.
7. analysis — the port's lint and its runner-key audit (after the
             mesh phase, on its DiT-XL/2 weights): (a) ``python -m
             repro_torch.analysis``'s passes over the shipped tree, the
             audit on fake CUDA tensors: no finding; (b) seven (modes,
             plan) pairs served through one ``ServeSession`` at B = 2, 4
             DDIM steps (Defo's frozen modes under base, statistics,
             ``low_bits=4``, ``fused`` and ``fused`` + ``low_bits=4``; all-act
             and all-diff under base): for each key the fingerprint of what
             the step dispatches (aten ops and kernel launches, recorded
             around the step the cache captures) equals the one recorded
             on fake CUDA tensors, the launches recorded in the capture
             equal the cache's, one capture a key, and the sample equals
             uncached ``serve_records`` bit for bit; every kernel
             launches under a capture; (c) all-diff base, then 40 steps
             with a 250 ms deadline and the watchdog (the same sig), then
             ``low_bits=4``, through one cache: captures 1, 1, 2.
8. train   — DiT-XL/2 training at full width and depth from
             ``configs/dit_xl2.py`` (bfloat16 params, float32 compute):
             ``init_state``, ``make_train_step`` with ``make_optimizer(base_lr
             =3e-4)`` (TrainDriver's warmup for a 20-step run), 20 steps at
             B = 32 on ``batch_for``; every loss finite and the last 5
             losses' mean below the first; it prints the median step wall,
             samples/s, peak memory and the step's matmul FLOP (formula in
             ``train_flops``) against the card's float32 peak. Then
             ``make_denoise_step(int8=True)`` on the trained weights,
             quantized (B = 2): each of its 7 L + 5 products launches
             ``int8_matmul`` and equals the plain version on the same
             operands exactly (the conditioning products at M = 2,
             patch_embed at K = 16, the block layers at M = 512); the step
             is within 0.1 relative L2 of the float step; both walls
             printed. Last, a resume at
             full width and depth 2 through ``TrainDriver``: 8 steps
             straight against 4, a restart from the checkpoint and 4 more,
             the last losses within 1e-5 (and whether they are bit-identical).
9. lm      — the LM substrate's serving path at qwen3-0.6b's full width
             and depth (28 x 1024, 16 / 8 heads of 64, qk-norm, tied and
             padded vocab; random bf16 weights from a seed) through
             ``make_prefill_step`` / ``make_decode_step``, the DiT freed
             first: (a) a prefill of ``SHAPES["prefill_32k"]``'s 32768
             tokens at B = 1 (8 query chunks of 4096 a layer; the cell's
             B = 32 is cut for score memory), finite logits; (b) a 512-token
             prompt at B = 16, its cache zero-padded to ``decode_32k``'s
             32768 slots, 64 greedy steps with the position on the card,
             no argmax on a pad column (the cell's B = 128 would need
             ~240 GB of k / v), rows 0-1's decode logits and cache within
             ``LM_BF16_TOL`` of a bf16 forward's and prefill's over the
             same tokens; (c) float32 at full width: decode (the position
             on the card) == forward over 64 tokens (rel < 2e-3),
             prefill's last logits ==
             forward's (rtol = atol = 2e-4), chunked == full ``_sdpa`` at
             S = 8192 (1e-5); (d) the card's float32 forward against the
             CPU's on the same weights (B = 1, S = 16, TF32 off, within
             1e-4 of the logits' scale); (e) smollm-360m, minicpm-2b,
             internvl2-2b and musicgen-medium at full width, a 512-position
             prefill at B = 2 and 8 decode steps each, finite. It prints
             walls, tokens/s and peak memory; no Ditto kernel launches.
10. lm_train — LM training at qwen3-0.6b's full width and depth (bf16)
             through ``init_state`` / ``make_train_step``: (a) 12 steps at
             ``train_4k``'s 4096 tokens and the largest batch of 4, 2, 1
             that fits (the cell's 256 cut; a refused batch is printed),
             finite losses whose last 3 average below the first; the step
             wall, tokens/s, peak memory and the matmul FLOP (formula in
             ``lm_train_flops``) against the bf16 dense peak; (b) at depth
             2, the loss and gradients with remat on and off, within 1e-3
             relative (and whether bit-identical), both peaks; (c) at depth
             2, ``TrainDriver`` 4 + a restart + 4 steps against 8 straight,
             every state tensor ``torch.equal``; (d) the float32 smoke step
             on the card within 1e-4 of the CPU's (loss, grad_norm).
11. moe    — qwen2-moe-a2.7b (24 x 2048, 60 experts top 4 + a shared
             expert, 14.3 B params, random bf16 weights from a seed): (e) a
             4096-token prefill at B = 2, then a 512-token prompt and 32
             greedy decode steps at B = 16 (the position on the card),
             finite logits, no argmax on a pad column; walls, tokens/s,
             peak memory and each phase's share of dropped (token, choice)
             slots (decode's one group of 16 tokens has one slot an expert:
             the reference's rule, mirrored); (f) training at full width
             and depth 4 (B = 4, S = 4096, the config's grad_accum 4,
             float32 accumulation), 4 steps, finite loss and aux > 0; (g)
             at smoke size in float32 with capacity_factor 8, for
             qwen2-moe and arctic-480b: decode against forward within 2e-3
             relative, the card's forward and aux within 1e-4 of the CPU's.
             No Ditto kernel launches in either phase.
12. recurrent — the recurrent LM families at full width (random bf16
             weights from a seed), the DiT and the earlier LMs freed first:
             (a) xlstm-125m (2 x (5 mLSTM + 1 sLSTM), d 768) at full depth:
             a 32768-token prefill at B = 1; a 512-token prompt at
             ``decode_32k``'s B = 128 and 64 greedy steps with the
             position on the card, no argmax on a pad column, rows 0-1's
             logits held to a bf16 and a float32 forward over the same 576
             tokens (4.5 x 128: the forward runs the mLSTM's cells; the
             gate is relative, ``bf16_gate``); the device activities of a
             512-token prefill and of a decode step (``torch.profiler``);
             8 steps from position 524,288, finite. (b) zamba2-7b (13 x
             (5 Mamba2 + the shared attention) + 3, d 3584, window 4096) at
             full depth: a 32768-token prefill at B = 1; a 512-token
             prompt at B = 32 (the cell's 128 cut for memory), its ring
             widened to 4096 slots (``padded_cache``), 16 greedy steps; 8
             steps from position 524,288. (c) float32 at full width
             (xlstm-125m at full depth, zamba2-7b cut to 1 super-block +
             the 3 trailing layers): decode == forward over 256 tokens
             (rel < 2e-3: the forward chunked, the decode the cells),
             prefill's last logits == forward's (rtol = atol = 2e-4), the
             card's forward against the CPU's (B = 1, TF32 off; within 1e-4
             of the logits' scale, or 3x the model's own float32 noise, a
             one-ulp nudge of the embedding, where that is larger); for
             zamba2 a ring wrap (a 4096-token prompt, 128 steps over slots
             0-127 at B = 2) == the windowed forward over 33 x 128 tokens
             (rel < 2e-3). (d) training through ``init_state`` /
             ``make_train_step`` at ``train_4k``'s S = 4096: xlstm-125m at
             full depth and the largest B of 8, 4 that fits (a refused
             B printed; 16 does not fit), zamba2-7b at 2 super-blocks + 3 (B = 4, its
             grad_accum 4), 2 steps each, finite losses; remat on / off
             at 1 super-block (B = 2, S = 512), within 1e-3 (and whether
             bit-identical), both peaks. It prints walls, tokens/s, peaks
             and decode ms a step; no Ditto kernel launches.
13. distributed — the rest of ``distributed/`` on one rank (a NCCL group
             of one, a (1, 1) ``DeviceMesh``): (a) ``param_axes`` and
             ``spec_for`` for all eleven configs at full width on the (16,
             16) and (2, 16, 16) production meshes, on meta tensors, the
             card's memory unmoved (leaves, sharded leaves and parameter
             bytes a chip printed); (b) qwen3-0.6b's full-width params
             laid out by ``param_shardings``, each local tensor equal to
             its leaf, and a depth-2 train state (``TrainDriver``, 2 steps)
             restored with ``shardings=``, bit for bit; (c) 20 rounds of
             ``compressed_psum_grads`` on qwen3-0.6b's full-width
             gradients (one ``loss_and_grads`` at S = 4096, B = 1, as
             float32) scaled by (1 + 0.05 i), accumulated means plus the
             residual within 1e-4 (relative L2, each leaf) of the exact
             sum, ms a round and payload bytes printed; (d) DiT-XL/2's 28
             W8A8 blocks through ``pipeline_apply``, 4 stages of 7 on the
             one card, 4 microbatches of 4 rows, the conditioning carried
             as one more token row: bit for bit against the sequential
             stack on each microbatch, 784 ``int8_matmul`` launches each
             equal to the plain version; the walls of both (on one card,
             the schedule's own cost) and their device activities and
             time (``torch.profiler``).
14. launch — the launch tooling: (a) ``launch/dryrun.py``'s one-card
             record of every (arch, shape) cell at full width, at the
             batches the earlier phases cut the cells to (the recurrent
             families' ``prefill_32k`` and ``train_4k`` also at S = 512),
             counted on fake tensors in worker processes that cannot see
             the card, and the layout records of both production meshes
             here, the card's memory unmoved; (b) the dry run held against
             the card on qwen3-0.6b's ``prefill_32k`` (B = 1),
             ``decode_32k`` (B = 16, 32768 slots) and ``train_4k`` (B = 4)
             and DiT-XL/2's float32 and W8A8 denoiser (B = 2): the
             analyzer's count on the card's tensors equal to the fake
             count exactly (FLOPs, bytes, ``int8_matmul``'s recorded work),
             no measured wall below its roofline bound, the predicted peak
             within 20 % of the measured one (the bytes held before the
             step that it does not take as an argument subtracted), the
             hand formulas' FLOPs beside the count, and the W8A8 step's
             201 products held to the plain version exactly.
15. times  — each kernel on the inputs the slice gave it (the last call at
             each shape), CUDA events, median of 30 runs with the L2 cache
             flushed before each, beside its bound (the work at the path's
             own shapes, not the 128-padded ones), its plain version and,
             where one PyTorch call computes the same function, that call
             (``torch._int_mm`` for a 2-D ``int8_matmul``, timed on W both
             as a (K, N) contiguous copy and as the transposed view of the
             K-major weight; ``library_ms`` is the faster).

The last lines are the ``scheduler: {...}``, ``mesh: {...}``,
``training: {...}``, ``lm: {...}``, ``lm_train: {...}``, ``moe: {...}``,
``recurrent: {...}``, ``distributed: {...}``, ``launch: {...}`` and
``analysis: {...}`` lines,
the kernels JSON, the card's name and power limit, and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import configs, tree  # noqa: E402
from repro_torch.analysis import trace_audit  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoPlan, PlanSchedule, dit_runner  # noqa: E402
from repro_torch.data.synthetic import DataCfg, batch_for  # noqa: E402
from repro_torch.distributed import collectives, pipeline, sharding  # noqa: E402
from repro_torch.kernels import common, ops, ref  # noqa: E402
from repro_torch.kernels import diff_encode as k_encode  # noqa: E402
from repro_torch.kernels import ditto_diff_matmul as k_diff  # noqa: E402
from repro_torch.kernels import fused_step as k_fused  # noqa: E402
from repro_torch.kernels import int8_matmul as k_int8  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, roofline  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch.train import TrainDriver  # noqa: E402
from repro_torch.models import dit_int8  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.serve import (CompiledRunnerCache, DispatchFailed, Fault,  # noqa: E402
                               FaultInjector, InjectedFault, SchedulerDied, ServeMesh,
                               ServeScheduler, ServeSession, bucket_for, chaos_schedule, inject)
from repro_torch.serve import cache as serve_cache  # noqa: E402
from repro_torch.sim import harness  # noqa: E402

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
    the times phase runs every kernel on the inputs the main path gave it
    (a diff GEMM call with ``low_bits=4`` counts as its own kernel). It also wraps
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


# ------------------------------------------------------------------- mesh
MESH_STEPS = 10
MESH_BUCKETS = 6  # async stealing: 6 full buckets of 4 rows, one group
MESH_KERNELS = ("int8_matmul", "diff_encode", "ditto_diff_matmul", DIFF4)


def mesh_devices() -> tuple:
    """Two distinct cards where there are two, else the one card named twice
    (the port's counterpart of forced host devices), and what was chosen."""
    if torch.cuda.device_count() >= 2:
        return (torch.device("cuda", 0), torch.device("cuda", 1)), "two cards"
    return (torch.device("cuda", 0),) * 2, "one card named twice"


def phase_mesh(params, sched) -> dict:
    """ServeScheduler on a ServeMesh at DiT-XL/2, 10 DDIM steps, max_batch=4:
    async stealing, a fault on one shard, a dp=2 split dispatch under Defo
    and warmup on every shard, every ticket held bit for bit to solo serving
    (``torch.equal``), the counts zeroed first and read after."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    zero_counts()
    devs, layout = mesh_devices()
    say(f"mesh: devices {[str(d) for d in devs]} ({layout})")
    g = torch.Generator(device=DEVICE).manual_seed(19)

    def request(n):
        return (torch.randn((n, CFG.input_size, CFG.input_size, CFG.in_channels), generator=g,
                            device=DEVICE),
                torch.randint(0, CFG.n_classes, (n,), generator=g, device=DEVICE))

    def equal(name, got, want):
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"mesh {name}: rows not finite or misshapen")
        if not torch.equal(got.to(want.device), want):
            d = (got.to(want.device) - want).abs().max().item()
            raise AssertionError(f"mesh {name}: rows differ from solo serving (max {d})")

    base = DittoPlan(steps=MESH_STEPS, policy="diff", max_batch=4, collect_stats=False)
    solo = ServeSession(params, CFG, sched, base)
    schedulers, out = [], {}

    def sync_all():
        for d in set(devs):
            torch.cuda.synchronize(d)

    # ---- (a) async stealing: a skewed stream, one group, one owner shard
    reqs = [request(4) for _ in range(MESH_BUCKETS)]
    want = [solo.serve(x, lab).sample for x, lab in reqs]

    def run_stream(s, walls=None):
        """The stream through ``s``: its rows and wall; ``walls`` collects
        each dispatch's serve wall (the session's own clock)."""
        if walls is not None:
            for sess in s._sessions:
                inner = sess.serve

                def timed(x, labels=None, *, plan=None, inner=inner):
                    res = inner(x, labels, plan=plan)
                    walls.append(res.wall_s)
                    return res

                sess.serve = timed
        sync_all()
        t0 = time.perf_counter()
        tickets = [s.submit(x, lab) for x, lab in reqs]
        s.flush()
        rows = [t.result(timeout=WAIT_S) for t in tickets]
        sync_all()
        return rows, time.perf_counter() - t0

    mesh = ServeMesh(2, dp=1, steal=True, devices=devs)
    s = ServeScheduler(params, CFG, sched, base, mesh=mesh, async_mode=True,
                       dispatch_interval_ms=INTERVAL_MS)
    schedulers.append(s)
    with s:
        rows, wall_cold = run_stream(s)
        st = s.stats()
        owner = next(iter(s._groups.values())).shard
        walls_2: list = []
        rows2, wall_2 = run_stream(s, walls_2)  # warm: every key captured on both shards
        st2 = s.stats()
    for i, (r, r2) in enumerate(zip(rows, rows2)):
        equal(f"stealing ticket {i}", r, want[i])
        equal(f"stealing ticket {i}, warm", r2, want[i])
    m = st["mesh"]
    non_owner = sum(r for k, r in enumerate(m["shard_rows"]) if k != owner)
    if m["steals"] < 1 or m["stolen_rows"] != non_owner or st["failed"]:
        raise AssertionError(f"mesh stealing: {m}, owner {owner}, failed {st['failed']}")
    one = ServeScheduler(params, CFG, sched, base, cache=solo.cache, async_mode=True,
                         dispatch_interval_ms=INTERVAL_MS)
    walls_1: list = []
    with one:
        rows1, wall_1 = run_stream(one, walls_1)
    for i, r in enumerate(rows1):
        equal(f"one shard ticket {i}", r, want[i])
    m2 = st2["mesh"]
    out["stealing"] = dict(cold=m, warm=dict(
        shard_dispatches=[a - b for a, b in zip(m2["shard_dispatches"], m["shard_dispatches"])],
        shard_rows=[a - b for a, b in zip(m2["shard_rows"], m["shard_rows"])],
        steals=m2["steals"] - m["steals"]), wall_cold_s=wall_cold, wall_2_shards_s=wall_2,
        wall_1_shard_s=wall_1, dispatch_s_2_shards=statistics.median(walls_2),
        dispatch_s_1_shard=statistics.median(walls_1),
        # dispatch walls over the stream's: how many dispatches ran at once
        overlap_2_shards=sum(walls_2) / wall_2, overlap_1_shard=sum(walls_1) / wall_1)
    say(f"mesh stealing: {MESH_BUCKETS} buckets of 4 rows, one group owned by shard {owner}: "
        f"{m['steals']} steal(s), {m['stolen_rows']} stolen row(s) == the other shard's; "
        f"every ticket == solo; warm wall {wall_2:.3f} s on 2 shards, {wall_1:.3f} s on 1, "
        f"a dispatch {statistics.median(walls_2):.3f} / {statistics.median(walls_1):.3f} s "
        f"(median) ({layout})")

    # ---- (b) a fault on one shard walks that dispatch's ladder
    def mk(steps):
        return base.replace(steps=steps, max_retries=1, fallbacks=(dict(low_bits=4),))

    plans = [mk(MESH_STEPS), mk(MESH_STEPS + 1), mk(MESH_STEPS + 2)]  # three groups
    fx = [request(4) for _ in plans]
    s = ServeScheduler(params, CFG, sched, base, mesh=ServeMesh(2, steal=False, devices=devs))
    schedulers.append(s)
    with inject(FaultInjector([Fault("session.serve", 1, "error")])) as inj:
        tickets = [s.submit(x, lab, plan=p) for (x, lab), p in zip(fx, plans)]
        s.flush()
    st = s.stats()
    walked = [i for i, t in enumerate(tickets) if t.served_with.low_bits == 4]
    if (len(inj.fired) != 1 or walked != [1] or st["died"] or st["retries"] != 1
            or st["failed"]):
        raise AssertionError(f"mesh fault: fired {inj.fired}, walked {walked}, {st}")
    for i, ((x, lab), p, t) in enumerate(zip(fx, plans, tickets)):
        equal(f"fault ticket {i}", t.result(), solo.serve(x, lab, plan=p).sample)
    out["fault"] = dict(walked=walked, shard_dispatches=st["mesh"]["shard_dispatches"],
                        retries=st["retries"], fallback_dispatches=st["fallback_dispatches"],
                        died=st["died"])
    say(f"mesh fault: one session.serve fault on the second dispatch; ticket {walked} walked "
        f"to low_bits=4, every ticket == solo, died {st['died']}")

    # ---- (c) a dp=2 split dispatch under Defo, statistics on
    defo = base.replace(policy="defo", collect_stats=True)
    x, lab = request(4)
    ref = solo.serve(x, lab, plan=defo)
    s = ServeScheduler(params, CFG, sched, defo, mesh=ServeMesh(2, dp=2, devices=devs),
                       retain=True)
    schedulers.append(s)
    t = s.submit(x, lab)
    equal("dp=2 defo", t.result(), ref.sample)
    got_c, want_c = t.results[0].chunks[0], ref.chunks[0]
    modes = want_c.engine.compiled_modes()
    if got_c.engine.compiled_modes() != modes:
        raise AssertionError("mesh dp=2: the frozen modes differ from the unsharded dispatch's")
    recs = {(r["layer"], r["step"]): r for r in got_c.records}
    for r in want_c.records:
        key = (r["layer"], r["step"])
        differ = [f for f, v in r.items() if recs[key].get(f) != v]
        if differ or recs[key].keys() != r.keys():
            raise AssertionError(f"mesh dp=2: record {key} differs in {differ}")
    n_act = sum(v == "act" for v in modes.values())
    out["dp2"] = dict(act_layers=n_act, diff_layers=len(modes) - n_act,
                      records=len(want_c.records))
    say(f"mesh dp=2: defo modes ({n_act} act, {len(modes) - n_act} diff) == unsharded, the "
        f"sample == unsharded bit for bit, {len(want_c.records)} records equal by (layer, "
        f"step), tile histograms included")

    # ---- (d) warmup captures on every shard; serving then captures nothing
    s = ServeScheduler(params, CFG, sched, base, mesh=ServeMesh(2, devices=devs))
    schedulers.append(s)
    w = s.warmup(buckets=[1, 2, 4])
    other = base.replace(steps=MESH_STEPS + 1)  # a second group: the other shard
    wreqs = [(request(4), None), (request(1), None), (request(2), other), (request(4), other)]
    tickets = [s.submit(x, lab, plan=p) for (x, lab), p in wreqs]
    s.flush()
    for i, (((x, lab), p), t) in enumerate(zip(wreqs, tickets)):
        equal(f"after warmup {i}", t.result(), solo.serve(x, lab, plan=p).sample)
    st = s.stats()
    if (w["captures"], w["primed"]) != (3, 3) or st["mesh"]["captures_after_warmup"] != [0, 0] \
            or 0 in st["mesh"]["shard_dispatches"]:
        raise AssertionError(f"mesh warmup: {w}, then {st['mesh']}")
    out["warmup"] = dict(w, shard_dispatches=st["mesh"]["shard_dispatches"],
                         captures_after_warmup=st["mesh"]["captures_after_warmup"])
    say(f"mesh warmup: {json.dumps(out['warmup'])}")

    # ---- (e) the watchdog on a dp=2 split: a drift saturates a step, both
    # groups re-anchor the next; samples, events and records == unsplit
    watch = base.replace(collect_stats=True, watchdog=True, reanchor_full_frac=0.9)
    x, lab = request(4)
    split = ServeSession(params, CFG, sched, watch.replace(mesh_devices=2), mesh=devs)
    unsplit = ServeSession(params, CFG, sched, watch)
    res = {}
    for name, sess in (("split", split), ("unsplit", unsplit)):
        with inject(FaultInjector([DRIFT])) as inj:
            res[name] = sess.serve(x, lab)
        if len(inj.fired) != 1:
            raise AssertionError(f"mesh dp=2 watchdog: the drift fired {inj.fired} ({name})")
    got_c, want_c = res["split"].chunks[0], res["unsplit"].chunks[0]
    events = want_c.engine.watchdog_events
    equal("dp=2 watchdog", res["split"].sample, res["unsplit"].sample)
    if got_c.engine.watchdog_events != events or not events or events[0]["trigger"] != "saturation":
        raise AssertionError(f"mesh dp=2 watchdog: events {got_c.engine.watchdog_events}, "
                             f"unsplit {events}")
    recs = {(r["layer"], r["step"]): r for r in got_c.records}
    for r in want_c.records:
        key = (r["layer"], r["step"])
        differ = [f for f, v in r.items() if recs[key].get(f) != v]
        if differ or recs[key].keys() != r.keys():
            raise AssertionError(f"mesh dp=2 watchdog: record {key} differs in {differ}")
    out["dp2_watchdog"] = dict(events=events, records=len(want_c.records),
                               reanchor_records=sum(bool(r.get("reanchor"))
                                                    for r in want_c.records))
    say(f"mesh dp=2 watchdog: a drift at denoise.step arrival {DRIFT.at}; events {events} == "
        f"unsplit, the sample == unsplit bit for bit, {len(want_c.records)} records equal by "
        f"(layer, step)")
    del split, unsplit, res, got_c, want_c

    # ---- the path's kernels ran from the mesh shards' own graphs (the
    # counts, zeroed first, also hold the solo serves' captures)
    ticks = launch_counts()
    replayed: dict = {}
    per_shard = []
    for sch in schedulers:
        for sess in sch._sessions:
            mine: dict = {}
            for c in sess.caches:
                for k, v in c.replayed_launches().items():
                    replayed[k] = replayed.get(k, 0) + v
                    mine[k] = mine.get(k, 0) + v
            per_shard.append(mine)
    idle = [k for k in MESH_KERNELS if not replayed.get(k)]
    if idle:
        raise AssertionError(f"mesh: no shard graph launched {idle}")
    if "diff_encode" in MESH_KERNELS and any(not sh.get("diff_encode") for sh in per_shard[:2]):
        raise AssertionError(f"mesh: a shard of the stealing mesh replayed no diff step: "
                             f"{per_shard[:2]}")
    out["launches"] = dict(captured=ticks, replayed_by_shards=replayed)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_wall_s"] = time.perf_counter() - t_phase
    out["devices"] = layout
    del schedulers, solo
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- training
TRAIN_ARCH = configs.get("dit-xl2")  # bf16 params, as the config says
TRAIN_BATCH = 32
TRAIN_STEPS = 20
Q8_BATCH = 2
Q8_KERNELS = ("int8_matmul",)  # the W8A8 step's products
RESUME_LAYERS = 2  # full width, cut depth: small checkpoints
RESUME_BATCH = 8
RESUME_STEPS = 8  # straight; and 4 + a restart + 4


def train_flops(cfg: dit.DiTCfg, batch: int) -> int:
    """Matmul FLOP of one train step: 3 x the forward's (the backward runs
    two products for each forward product). Forward, per sample: L x [T x
    (8 d^2 for q, k, v, o + 16 d^2 for the MLP's d -> 4d -> d + 4 T d for
    QK^T and PV) + 12 d^2 for the adaLN projection d -> 6d] + 4 T p d
    (patch embedding and the final projection, p = patch_dim) + 2 (256 d +
    d^2 + 2 d^2) (the timestep MLP and the final adaLN). LayerNorm,
    softmax, activations and the optimizer are not counted."""
    d, t, L, p = cfg.d_model, cfg.n_tokens, cfg.n_layers, cfg.patch_dim
    per_layer = t * (8 * d * d + 16 * d * d + 4 * t * d) + 12 * d * d
    return 3 * batch * (L * per_layer + 4 * t * p * d + 2 * (256 * d + 3 * d * d))


def synced_wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def int8_held_exactly(where: str):
    """Route ``ops.int8_act_matmul`` (the W8A8 products) through a check:
    each product the kernel returns equals the plain version on the same
    operands, exactly (an int8 product is exact). Yields the count of
    products held at each (x, W) shape."""
    held: dict = {}
    kernel_route = ops.int8_act_matmul

    def held_exactly(x_q, w_q, **kw):
        y = kernel_route(x_q, w_q, **kw)
        want = ref.int8_matmul_ref(x_q, w_q, w_transposed=kw.get("w_transposed", False))
        key = f"x{list(x_q.shape)} w{list(w_q.shape)}"
        if not torch.equal(y, want):
            raise AssertionError(f"{where}: int8_matmul differs from its plain version at {key}: "
                                 f"{int((y != want).sum())} entries")
        held[key] = held.get(key, 0) + 1
        return y

    ops.int8_act_matmul = held_exactly
    try:
        yield held
    finally:
        ops.int8_act_matmul = kernel_route


def phase_train() -> dict:
    """DiT-XL/2 training at full width and depth, the W8A8 step on its
    trained weights, and a depth-2 resume through TrainDriver."""
    gc.collect()  # the earlier phases' caches hold graphs and arenas
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    arch = TRAIN_ARCH
    cfg = train_steps.make_dit_model(arch)
    out: dict = {}

    # ---- throughput: TRAIN_STEPS steps at TRAIN_BATCH
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    # the optimizer TrainDriver builds for a run of TRAIN_STEPS steps
    opt = train_steps.make_optimizer(arch, base_lr=3e-4, total=TRAIN_STEPS,
                                     warmup=train_steps.driver_warmup(TRAIN_STEPS))
    (state, init_s) = synced_wall(lambda: train_steps.init_state(arch, 0, opt, device=DEVICE))
    train = train_steps.make_train_step(arch, opt)
    dc = DataCfg(seed=0, batch=TRAIN_BATCH)
    losses, walls = [], []
    for step in range(TRAIN_STEPS):
        def one():
            nonlocal state
            state, m = train(state, batch_for(arch, dc, step, device=DEVICE))
            return float(m["loss"])
        loss, wall = synced_wall(one)
        losses.append(loss)
        walls.append(wall)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    if not statistics.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    step_s = statistics.median(walls)
    flops = train_flops(cfg, TRAIN_BATCH)
    n_params = sum(p.numel() for p in tree.leaves(state["params"]))
    out["train"] = dict(
        arch=arch.name, layers=cfg.n_layers, d_model=cfg.d_model, batch=TRAIN_BATCH,
        param_dtype=arch.param_dtype, params_m=n_params / 1e6, init_s=init_s, losses=losses,
        step_walls_s=walls, step_wall_s_median=step_s, samples_per_s=TRAIN_BATCH / step_s,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, held_before_gib=held,
        flop_per_step=flops, tflops=flops / step_s / 1e12,
        fp32_peak_share=flops / step_s / roofline.PEAK_FLOPS_FP32)
    say(f"train: DiT-XL/2 {cfg.n_layers} x {cfg.d_model}, {n_params / 1e6:.1f} M params "
        f"({arch.param_dtype}), B = {TRAIN_BATCH}, {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (last 5 mean {statistics.mean(losses[-5:]):.4f}); median step "
        f"{step_s * 1e3:.1f} ms, {TRAIN_BATCH / step_s:.1f} samples/s; peak "
        f"{out['train']['peak_gib']:.2f} GiB; {flops / 1e12:.2f} TFLOP a step (3 B [L (T (24 d^2 "
        f"+ 4 T d) + 12 d^2) + 4 T p d + 2 (256 d + 3 d^2)]: matmuls, forward and backward), "
        f"{flops / step_s / 1e12:.2f} TFLOP/s = "
        f"{100 * flops / step_s / roofline.PEAK_FLOPS_FP32:.1f} % of the fp32 peak")

    # ---- the W8A8 step on the trained weights, against the float step
    params = state["params"]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    qparams = dit_int8.quantize_params(params, cfg)
    g = torch.Generator(device=DEVICE).manual_seed(4)
    batch = {"latents": torch.randn((Q8_BATCH, cfg.input_size, cfg.input_size, cfg.in_channels),
                                    generator=g, device=DEVICE),
             "t": torch.tensor([700.0, 500.0], device=DEVICE)[:Q8_BATCH],
             "labels": torch.randint(0, cfg.n_classes, (Q8_BATCH,), generator=g, device=DEVICE)}
    q8, fp = train_steps.make_denoise_step(arch, int8=True), train_steps.make_denoise_step(arch)
    # the counted run: every product it launches is held to the plain version
    with int8_held_exactly("w8a8") as held:
        zero_counts()
        y_q = q8(qparams, batch)
        per_step = launch_counts()
    # per block: mod, q, k, v, o, wi, wo; then patch_embed, t_mlp1, t_mlp2,
    # final_mod, final_out
    n_products = 7 * cfg.n_layers + 5
    if sum(held.values()) != n_products:
        raise AssertionError(f"w8a8: {sum(held.values())} products held, want {n_products}")
    short = {k: per_step[k] for k in Q8_KERNELS if per_step[k] != n_products}
    if short:
        raise AssertionError(f"w8a8: launches {short}, want {n_products} each")
    y_f = fp(params, batch)
    for name, y in (("w8a8", y_q), ("float", y_f)):
        if y.shape != batch["latents"].shape or not torch.isfinite(y).all():
            raise AssertionError(f"{name} step: output not finite or misshapen")
    rel = float(torch.linalg.norm(y_q - y_f) / torch.linalg.norm(y_f))
    q8_walls = [synced_wall(lambda: q8(qparams, batch))[1] for _ in range(5)]
    fp_walls = [synced_wall(lambda: fp(params, batch))[1] for _ in range(5)]
    out["w8a8"] = dict(batch=Q8_BATCH, rel_l2_vs_float=rel,
                       launches_per_step={k: v for k, v in per_step.items() if v},
                       held_exact_per_shape=held,
                       wall_ms=statistics.median(q8_walls) * 1e3,
                       float_wall_ms=statistics.median(fp_walls) * 1e3)
    if not rel < 0.1:
        raise AssertionError(f"w8a8: relative L2 error {rel:.4f} against the float step (>= 0.1)")
    say(f"train w8a8: B = {Q8_BATCH}, {n_products} products equal to the plain version at "
        f"{len(held)} shapes, relative L2 {rel:.4f} against the float step; "
        f"{json.dumps(out['w8a8'])}")
    del params, qparams
    gc.collect()
    torch.cuda.empty_cache()

    # ---- resume at full width, depth RESUME_LAYERS, through TrainDriver
    arch2 = dataclasses.replace(arch, n_layers=RESUME_LAYERS)
    kw = dict(batch=RESUME_BATCH, total_steps=RESUME_STEPS, ckpt_every=0, device=DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        straight = TrainDriver(arch2, workdir=os.path.join(tmp, "a"), **kw)
        _, t_straight = synced_wall(straight.run)
        first = TrainDriver(arch2, workdir=os.path.join(tmp, "b"), **kw)
        _, t_first = synced_wall(lambda: first.run(steps=RESUME_STEPS // 2))
        resumed = TrainDriver(arch2, workdir=os.path.join(tmp, "b"), **kw)
        _, t_resumed = synced_wall(resumed.run)
        ckpt_mib = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
                       os.walk(os.path.join(tmp, "a")) for f in fs) / 2**20
    want = [m["loss"] for m in straight.metrics_log]
    got = [m["loss"] for m in resumed.metrics_log]
    if [m["step"] for m in resumed.metrics_log] != list(range(RESUME_STEPS // 2, RESUME_STEPS)):
        raise AssertionError(f"resume: steps {[m['step'] for m in resumed.metrics_log]}")
    diff = abs(got[-1] - want[-1])
    out["resume"] = dict(layers=RESUME_LAYERS, batch=RESUME_BATCH, losses_straight=want,
                         losses_resumed=got, last_loss_diff=diff,
                         bit_identical=got == want[RESUME_STEPS // 2:],
                         checkpoint_mib=ckpt_mib,
                         walls_s=dict(straight=t_straight, first=t_first, resumed=t_resumed))
    if not diff < 1e-5:
        raise AssertionError(f"resume: last loss {got[-1]} against {want[-1]} straight")
    say(f"train resume: {json.dumps(out['resume'])}")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------- LM
LM_ARCH = "qwen3-0.6b"  # full width and depth: 28 layers, d 1024, 16 / 8 heads of 64
LM_PREFILL_LEN = configs.SHAPES["prefill_32k"].seq_len  # 32768 tokens: 8 chunks of 4096
LM_PREFILL_BATCH = 1  # the cell's 32 would need ~32x the score memory of one sample
LM_CACHE_LEN = configs.SHAPES["decode_32k"].seq_len  # 32768 slots
LM_DECODE_BATCH = 16  # the cell's 128 would need ~240 GB of k / v cache
LM_PROMPT = 512
LM_DECODE_STEPS = 64
LM_CHECK_ROWS = 2  # decode rows held against a forward over the same tokens, bf16
# max-abs difference over the max-abs of a forward's logits / a prefill's
# cache: about 3x the readings on one H100 (1.59e-2 / 1.58e-2); a k / v write
# one slot late reads 1.16 on the cache
LM_BF16_TOL = {"logits": 0.05, "cache": 0.05}
LM_IDENTITY_LEN = 64  # decode / prefill against forward, float32, B = 2
LM_CHUNK_LEN = 8192  # chunked against full _sdpa, float32
LM_CPU_LEN = 16  # the card against the CPU, float32, B = 1
LM_CPU_TOL = 1e-4  # max-abs difference over the CPU logits' max-abs
LM_OTHERS = ("smollm-360m", "minicpm-2b", "internvl2-2b", "musicgen-medium")
LM_OTHER_LEN, LM_OTHER_BATCH, LM_OTHER_STEPS = 512, 2, 8


def lm_arch(name: str) -> configs.ArchConfig:
    """The config the phase runs (a CPU rehearsal swaps in smoke configs)."""
    return configs.get(name)


def lm_inputs(arch, g, b, s, *, prefix=True):
    """A batch of ``s`` positions for ``arch`` on the card: token ids (a
    vision arch's prefix of ``n_frontend_tokens`` patch embeddings counted
    in ``s``, as the reference's ``input_specs``) or audio frame embeddings."""
    adt = configs.torch_dtype(arch.activation_dtype)
    nf = arch.n_frontend_tokens if arch.frontend == "vision" and prefix else 0
    if arch.frontend == "audio":
        return {"embeds": torch.randn((b, s, arch.d_model), generator=g, device=DEVICE).to(adt)}
    batch = {"tokens": torch.randint(0, arch.vocab_size, (b, s - nf), generator=g,
                                     device=DEVICE)}
    if nf:
        batch["frontend_embeds"] = (torch.randn((b, nf, arch.d_model), generator=g,
                                                device=DEVICE) * 0.02).to(adt)
    return batch


def padded_cache(model, cache, length):
    """A zero cache of ``length`` slots holding ``cache`` in its first slots.

    A recurrent (xLSTM) cache has no length and comes back as it is. A
    hybrid's ring is widened to ``min(attn_window, length)`` slots: zero k /
    v and position -1 in the new ones. The prefill's ring is the prompt's
    width, each position at its own slot (``pos % W = pos`` while the
    prompt fits), so the widened ring is the one a decode from position 0
    would have built."""
    if model.cfg.family == "ssm":
        return cache
    if model.cfg.family == "hybrid":
        ak = cache["a_k"]
        w = min(model.cfg.attn_window or length, length)
        if w == ak.shape[2]:
            return cache
        if w < ak.shape[2] or int(cache["a_p"].max()) >= ak.shape[2]:
            raise ValueError(f"a ring of {ak.shape[2]} slots holding positions up to "
                             f"{int(cache['a_p'].max())} does not widen to {w}")
        out = dict(cache)
        for name in ("a_k", "a_v"):
            out[name] = torch.zeros(ak.shape[:2] + (w,) + ak.shape[3:], dtype=ak.dtype,
                                    device=ak.device)
            out[name][:, :, :ak.shape[2]] = cache[name]
        out["a_p"] = torch.full((ak.shape[0], w), -1, dtype=cache["a_p"].dtype, device=ak.device)
        out["a_p"][:, :ak.shape[2]] = cache["a_p"]
        return out
    k = cache["k"]
    out = model.init_cache(k.shape[1], length, dtype=k.dtype, device=k.device)
    for name in ("k", "v"):
        out[name][:, :, :k.shape[2]] = cache[name]
    return out


def greedy(logits, arch):
    """(B, 1) next tokens; a device flag that is true where one is a pad column."""
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    return tok, (tok >= arch.vocab_size).any()


def next_inputs(arch, g, tok):
    if arch.frontend == "audio":  # frame embeddings in: the next frame is random
        return {"embeds": torch.randn((tok.shape[0], 1, arch.d_model), generator=g,
                                      device=DEVICE).to(configs.torch_dtype(arch.activation_dtype))}
    return {"tokens": tok}


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def rel_max(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def phase_lm() -> dict:
    """The LM substrate's serving path at qwen3-0.6b's full width and depth
    (random bf16 weights from a seed) through ``make_prefill_step`` /
    ``make_decode_step``: (a) a 32k prefill, (b) greedy decode against a
    32k-slot cache, (c) the reference's identities in float32, (d) the card
    against the CPU, (e) the other dense-stack configs at full width."""
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    zero_counts()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("lm: TF32 is on; the float32 identities need it off")
    from repro_torch.models import LM
    from repro_torch.nn import attention

    out: dict = {}
    arch = lm_arch(LM_ARCH)
    model = LM(arch)
    prefill, decode = train_steps.make_prefill_step(arch), train_steps.make_decode_step(arch)
    g = torch.Generator(device=DEVICE).manual_seed(23)
    params = model.init(g, device=DEVICE)
    n_params = sum(p.numel() for p in tree.leaves(params))
    say(f"lm: {arch.name} {arch.n_layers} x {arch.d_model}, heads {arch.n_heads} / "
        f"{arch.n_kv_heads} of {arch.resolved_head_dim}, vocab {arch.vocab_size} -> "
        f"{model.vocab_padded}, {n_params / 1e6:.1f} M params ({arch.param_dtype})")

    # ---- (a) prefill at the prefill_32k cell's length, B = 1
    prefill(params, lm_inputs(arch, g, 1, 2 * attention.CHUNK_Q))  # warm: two chunks
    chunks = []
    chunked = attention._sdpa_chunked

    def counted(q, *a, **kw):
        chunks.append(q.shape[1])
        return chunked(q, *a, **kw)

    batch = lm_inputs(arch, g, LM_PREFILL_BATCH, LM_PREFILL_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention._sdpa_chunked = counted
    try:
        (logits, cache), wall = synced_wall(lambda: prefill(params, batch))
    finally:
        attention._sdpa_chunked = chunked
    tok, pad_hit = greedy(logits, arch)
    if not bool(torch.isfinite(logits[..., :arch.vocab_size]).all()) or bool(pad_hit):
        raise AssertionError("lm prefill: logits not finite, or an argmax on a pad column")
    want_chunks = [LM_PREFILL_LEN] * arch.n_layers if LM_PREFILL_LEN > attention.CHUNK_Q else []
    if chunks != want_chunks:
        raise AssertionError(f"lm prefill: the chunked path ran {chunks}")
    score_gb = (LM_PREFILL_BATCH * arch.n_heads * min(LM_PREFILL_LEN, attention.CHUNK_Q)
                * LM_PREFILL_LEN * 4 / 1e9)
    cell_b = configs.SHAPES["prefill_32k"].global_batch
    out["prefill"] = dict(seq=LM_PREFILL_LEN, batch=LM_PREFILL_BATCH, wall_s=wall,
                          tokens_per_s=LM_PREFILL_BATCH * LM_PREFILL_LEN / wall,
                          peak_gib=peak_gib(), chunk_scores_gb=score_gb,
                          cache_gib=2 * cache["k"].numel() * cache["k"].element_size() / 2**30,
                          cell_batch=cell_b)
    say(f"lm prefill: {LM_PREFILL_LEN} tokens at B = {LM_PREFILL_BATCH} ({arch.param_dtype}, "
        f"{LM_PREFILL_LEN // attention.CHUNK_Q} query chunks of {attention.CHUNK_Q} a layer) "
        f"in {wall:.3f} s = {LM_PREFILL_BATCH * LM_PREFILL_LEN / wall:.0f} tokens/s, peak "
        f"{peak_gib():.2f} GiB; reduced from the cell's B = {cell_b}: a chunk's float32 scores "
        f"are {score_gb:.1f} GB a sample, {cell_b}x that at B = {cell_b}")
    del logits, cache, batch

    # ---- (b) greedy decode against the decode_32k cell's cache length
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prompt = lm_inputs(arch, g, LM_DECODE_BATCH, LM_PROMPT)
    (logits, pc), prompt_s = synced_wall(lambda: prefill(params, prompt))
    cache = padded_cache(model, pc, LM_CACHE_LEN)
    del pc
    tok, pad_any = greedy(logits, arch)
    # the position lives on the card (as a captured decode will need it):
    # the step never reads it back
    pos = torch.full((), LM_PROMPT, dtype=torch.int32, device=DEVICE)
    walls, fed, got = [], [], []
    for _ in range(LM_DECODE_STEPS):
        step_in = dict(next_inputs(arch, g, tok), pos=pos)
        (logits, cache), w = synced_wall(lambda: decode(params, cache, step_in))
        walls.append(w)
        fed.append(step_in["tokens"][:LM_CHECK_ROWS])
        got.append(logits[:LM_CHECK_ROWS, -1, :arch.vocab_size].clone())
        tok, pad_hit = greedy(logits, arch)
        pad_any = pad_any | pad_hit
        pos += 1
    if bool(pad_any) or not bool(torch.isfinite(logits[..., :arch.vocab_size]).all()):
        raise AssertionError("lm decode: an argmax on a pad column, or logits not finite")
    # the timed path itself (bf16, a device pos, the 32k-slot cache written in
    # place) against a bf16 forward and a prefill over the same prompt and fed
    # tokens: the decode logits against the forward's, the cache's live slots
    # against the prefill's
    seq = torch.cat([prompt["tokens"][:LM_CHECK_ROWS]] + fed, dim=1)
    want = model.forward(params, tokens=seq)[0][:, LM_PROMPT:, :arch.vocab_size]
    _, want_c = prefill(params, {"tokens": seq})
    bf16 = dict(logits=rel_max(torch.stack(got, dim=1), want),
                cache=max(rel_max(cache[n][:, :LM_CHECK_ROWS, :seq.shape[1]], want_c[n])
                          for n in ("k", "v")))
    del seq, want, want_c, fed, got
    if not all(bf16[n] <= LM_BF16_TOL[n] for n in bf16):
        raise AssertionError(f"lm decode: the decode's logits / cache differ from a forward's "
                             f"/ a prefill's over the same tokens by {bf16} of their max-abs, "
                             f"tolerance {LM_BF16_TOL}")
    kv_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    cell_b = configs.SHAPES["decode_32k"].global_batch
    step_s = statistics.median(walls)
    out["decode"] = dict(batch=LM_DECODE_BATCH, cache_len=LM_CACHE_LEN, prompt=LM_PROMPT,
                         steps=LM_DECODE_STEPS, prompt_prefill_s=prompt_s, step_walls_s=walls,
                         step_ms_median=step_s * 1e3, tokens_per_s=LM_DECODE_BATCH / step_s,
                         peak_gib=peak_gib(), kv_cache_gb=kv_gb, cell_batch=cell_b,
                         cell_kv_cache_gb=kv_gb * cell_b / LM_DECODE_BATCH,
                         vs_forward_rel=bf16, vs_forward_tol=LM_BF16_TOL)
    say(f"lm decode: B = {LM_DECODE_BATCH}, a {LM_PROMPT}-token prompt ({prompt_s:.3f} s), the "
        f"cache zero-padded to {LM_CACHE_LEN} slots, {LM_DECODE_STEPS} greedy steps: median "
        f"step {step_s * 1e3:.2f} ms = {LM_DECODE_BATCH / step_s:.0f} tokens/s, peak "
        f"{peak_gib():.2f} GiB; reduced from the cell's B = {cell_b}: k / v cache {kv_gb:.1f} GB "
        f"at B = {LM_DECODE_BATCH}, {kv_gb * cell_b / LM_DECODE_BATCH:.0f} GB at B = {cell_b}; "
        f"rows 0-{LM_CHECK_ROWS - 1}'s decode logits == a bf16 forward's over the same tokens "
        f"to {bf16['logits']:.2e} of their max-abs, its cache == a prefill's to "
        f"{bf16['cache']:.2e} (tolerances {LM_BF16_TOL})")
    del logits, cache, params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) the reference's identities at full width, float32
    arch32 = dataclasses.replace(arch, param_dtype="float32", activation_dtype="float32")
    m32 = LM(arch32)
    p32 = m32.init(torch.Generator(device=DEVICE).manual_seed(29), device=DEVICE)
    toks = torch.randint(0, arch.vocab_size, (2, LM_IDENTITY_LEN), generator=g, device=DEVICE)
    full, _ = m32.forward(p32, tokens=toks)
    c32 = m32.init_cache(2, LM_IDENTITY_LEN, device=DEVICE)
    dec, dpos = [], torch.zeros((), dtype=torch.int32, device=DEVICE)  # as the timed path's
    for i in range(LM_IDENTITY_LEN):
        lg, c32 = m32.decode_step(p32, c32, tokens=toks[:, i:i + 1], pos=dpos)
        dec.append(lg)
        dpos += 1
    dec_rel = rel_max(torch.cat(dec, dim=1), full)
    last, _ = m32.prefill(p32, tokens=toks)
    # assert_allclose(rtol=atol=2e-4): |last - full| <= 2e-4 (1 + |full|)
    pre_ratio = float(((last[:, 0] - full[:, -1]).abs() / (2e-4 * (1 + full[:, -1].abs()))).max())
    q = torch.randn((1, LM_CHUNK_LEN, arch.n_heads, arch.resolved_head_dim), generator=g,
                    device=DEVICE)
    k = torch.randn((1, LM_CHUNK_LEN, arch.n_kv_heads, arch.resolved_head_dim), generator=g,
                    device=DEVICE)
    v = torch.randn(k.shape, generator=g, device=DEVICE)
    pos = torch.arange(LM_CHUNK_LEN, device=DEVICE)
    sc = 1.0 / math.sqrt(arch.resolved_head_dim)
    ch = attention._sdpa_chunked(q, k, v, qpos=pos, kpos=pos, window=None, scale=sc)
    fl = attention._sdpa(q, k, v, mask=(pos[:, None] >= pos[None, :])[None, None, None],
                         scale=sc)
    ch_ratio = float(((ch - fl).abs() / (1e-5 * (1 + fl.abs()))).max())
    del q, k, v, ch, fl
    ident = dict(decode_vs_forward_rel=dec_rel, prefill_vs_forward_tol_share=pre_ratio,
                 chunked_vs_full_tol_share=ch_ratio)
    if not (dec_rel < 2e-3 and pre_ratio <= 1 and ch_ratio <= 1):
        raise AssertionError(f"lm identities: {ident}")
    out["identities"] = ident
    say(f"lm identities (float32, full width): decode (the position on the card) == forward "
        f"over {LM_IDENTITY_LEN} tokens at B = 2, max rel {dec_rel:.2e} (< 2e-3); prefill's last logits == forward's at "
        f"{pre_ratio:.3f} of rtol = atol = 2e-4; chunked == full _sdpa at S = {LM_CHUNK_LEN} at "
        f"{ch_ratio:.3f} of rtol = atol = 1e-5")

    # ---- (d) the card against the CPU: the same float32 weights and tokens
    toks = toks[:1, :LM_CPU_LEN]
    on_card, _ = m32.forward(p32, tokens=toks)
    p_cpu = tree.map_tree(lambda a: a.cpu(), p32)
    (on_cpu, _), cpu_s = synced_wall(lambda: m32.forward(p_cpu, tokens=toks.cpu()))
    real = slice(0, arch.vocab_size)
    cpu_rel = rel_max(on_card[..., real].cpu(), on_cpu[..., real])
    out["card_vs_cpu"] = dict(seq=LM_CPU_LEN, rel=cpu_rel, tol=LM_CPU_TOL, cpu_forward_s=cpu_s)
    if not cpu_rel <= LM_CPU_TOL:
        raise AssertionError(f"lm card vs CPU: {cpu_rel} > {LM_CPU_TOL}")
    say(f"lm card vs CPU: float32 forward, B = 1, S = {LM_CPU_LEN}, TF32 off: max-abs "
        f"difference {cpu_rel:.2e} of the CPU logits' max-abs (tolerance {LM_CPU_TOL})")
    del p32, p_cpu, c32, full, dec, on_card, on_cpu
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (e) the other dense-stack configs at full width, bf16
    out["others"] = {}
    for name in LM_OTHERS:
        a = lm_arch(name)
        mo = LM(a)
        pre, dec_step = train_steps.make_prefill_step(a), train_steps.make_decode_step(a)
        torch.cuda.reset_peak_memory_stats()
        po = mo.init(torch.Generator(device=DEVICE).manual_seed(31), device=DEVICE)
        batch = lm_inputs(a, g, LM_OTHER_BATCH, LM_OTHER_LEN)
        (lg, c), pre_s = synced_wall(lambda: pre(po, batch))
        c = padded_cache(mo, c, LM_OTHER_LEN + LM_OTHER_STEPS)
        tok, pad_any = greedy(lg, a)
        ok = torch.isfinite(lg[..., :a.vocab_size]).all()
        dwalls = []
        for i in range(LM_OTHER_STEPS):
            step_in = dict(next_inputs(a, g, tok), pos=LM_OTHER_LEN + i)
            (lg, c), w = synced_wall(lambda: dec_step(po, c, step_in))
            dwalls.append(w)
            tok, pad_hit = greedy(lg, a)
            pad_any, ok = pad_any | pad_hit, ok & torch.isfinite(lg[..., :a.vocab_size]).all()
        if not bool(ok) or bool(pad_any):
            raise AssertionError(f"lm {name}: logits not finite, or an argmax on a pad column")
        row = dict(layers=a.n_layers, d_model=a.d_model, heads=[a.n_heads, a.n_kv_heads],
                   vocab=[a.vocab_size, mo.vocab_padded], frontend=a.frontend,
                   params_m=sum(p.numel() for p in tree.leaves(po)) / 1e6,
                   prefill_s=pre_s, decode_ms_median=statistics.median(dwalls) * 1e3,
                   peak_gib=peak_gib())
        out["others"][name] = row
        say(f"lm {name}: {json.dumps(row)}")
        del po, c, lg, batch
        gc.collect()
        torch.cuda.empty_cache()

    out["launches"] = launch_counts()  # the LM path reaches no TPU kernel: all 0
    if any(out["launches"].values()):
        raise AssertionError(f"lm: a Ditto kernel launched: {out['launches']}")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# --------------------------------------------------------------- LM train
LMT_ARCH = "qwen3-0.6b"  # full width and depth, bf16 params, tied padded vocab
LMT_SEQ = configs.SHAPES["train_4k"].seq_len  # 4096
LMT_BATCHES = (4, 2, 1)  # the cell's 256 cut: the largest of these that fits the card
LMT_STEPS = 12
LMT_LR = 1e-3
LMT_LAYERS = 2  # (b) remat on / off and (c) the restart: full width, depth 2
LMT_REMAT_TOL = 1e-3  # relative, bf16 (the two runs compute the same ops)
LMT_RESUME_BATCH, LMT_RESUME_SEQ, LMT_RESUME_STEPS = 2, 1024, 8
LMT_CPU_TOL = 1e-4  # (d): the card's smoke step against the CPU's, float32


def lm_train_flops(arch: configs.ArchConfig, vocab_padded: int, batch: int, seq: int) -> int:
    """Matmul FLOP of one LM train step: 3 x the forward's (the backward runs
    two products for each forward product; remat's recomputed forward is
    not counted). Forward: 2 B S [L (d qd + 2 d kvd + qd d + 3 d f) + d V]
    (the projections, the gated MLP and the padded head) + 4 L B S^2 H hd
    (QK^T and PV over the whole masked square, as computed)."""
    d, f, L = arch.d_model, arch.d_ff, arch.n_layers
    hd = arch.resolved_head_dim
    qd, kvd = arch.n_heads * hd, arch.n_kv_heads * hd
    per_token = L * (2 * d * qd + 2 * d * kvd + 3 * d * f) + d * vocab_padded
    return 3 * (2 * batch * seq * per_token + 4 * L * batch * seq * seq * arch.n_heads * hd)


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm_train() -> dict:
    """LM training at qwen3-0.6b's full width and depth through
    ``init_state`` / ``make_train_step``: (a) steps at ``train_4k``'s
    sequence length, (b) remat on against off, (c) a TrainDriver restart,
    bit for bit, (d) the card's float32 smoke step against the CPU's."""
    free_card()
    t_phase = time.perf_counter()
    zero_counts()
    from repro_torch.models import LM

    out: dict = {}
    arch = lm_arch(LMT_ARCH)
    vpad = LM(arch).vocab_padded
    opt = train_steps.make_optimizer(arch, base_lr=LMT_LR, total=LMT_STEPS,
                                     warmup=train_steps.driver_warmup(LMT_STEPS))
    train = train_steps.make_train_step(arch, opt)

    # ---- (a) train_4k's sequence length, the largest batch that fits
    refused = []
    for batch in LMT_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        state = None
        try:
            (state, init_s) = synced_wall(lambda: train_steps.init_state(arch, 0, opt,
                                                                         device=DEVICE))
            dc = DataCfg(seed=0, batch=batch, seq_len=LMT_SEQ)
            losses, auxes, walls = [], [], []
            for step in range(LMT_STEPS):
                def one():
                    nonlocal state
                    state, m = train(state, batch_for(arch, dc, step, device=DEVICE))
                    return torch.stack([m["loss"], m["aux"]]).tolist()
                (loss, aux), wall = synced_wall(one)
                losses.append(loss)
                auxes.append(aux)
                walls.append(wall)
            break
        except torch.cuda.OutOfMemoryError as e:
            refused.append({"batch": batch, "error": str(e).splitlines()[0][:160]})
        state = None  # the error (and its frames) are gone here: free their memory
        free_card()
    else:
        raise AssertionError(f"lm_train: no batch of {LMT_BATCHES} fits: {refused}")
    peak = peak_gib()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"lm_train: a loss is not finite: {losses}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"lm_train: the loss did not fall: {losses}")
    step_s = statistics.median(walls[1:])
    flops = lm_train_flops(arch, vpad, batch, LMT_SEQ)
    n_params = sum(p.numel() for p in tree.leaves(state["params"]))
    cell_b = configs.SHAPES["train_4k"].global_batch
    out["train"] = dict(arch=arch.name, layers=arch.n_layers, d_model=arch.d_model,
                        params_m=n_params / 1e6, seq=LMT_SEQ, batch=batch, cell_batch=cell_b,
                        refused=refused, init_s=init_s, losses=losses, aux=auxes,
                        step_walls_s=walls, step_wall_s_median=step_s,
                        tokens_per_s=batch * LMT_SEQ / step_s, peak_gib=peak,
                        flop_per_step=flops, tflops=flops / step_s / 1e12,
                        bf16_peak_share=flops / step_s / roofline.PEAK_FLOPS)
    say(f"lm_train: {arch.name} {arch.n_layers} x {arch.d_model}, {n_params / 1e6:.1f} M "
        f"params ({arch.param_dtype}), B = {batch} (the cell's {cell_b} cut; refused: "
        f"{[r['batch'] for r in refused]}), S = {LMT_SEQ}, {LMT_STEPS} steps: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (last 3 mean {statistics.mean(losses[-3:]):.4f}); "
        f"median step {step_s * 1e3:.1f} ms (the first {walls[0] * 1e3:.1f}), "
        f"{batch * LMT_SEQ / step_s:.0f} tokens/s; peak {peak:.2f} GiB; "
        f"{flops / 1e12:.1f} TFLOP a step = {100 * flops / step_s / roofline.PEAK_FLOPS:.1f} % of "
        f"the bf16 dense peak")
    del state
    free_card()

    # ---- (b) remat on against off at depth LMT_LAYERS, bf16
    arch2 = dataclasses.replace(arch, n_layers=LMT_LAYERS)
    params = LM(arch2).init(torch.Generator(device=DEVICE).manual_seed(1), device=DEVICE)
    rb = batch_for(arch2, DataCfg(seed=1, batch=batch, seq_len=LMT_SEQ), 0, device=DEVICE)
    runs = {}
    for remat in (True, False):
        a = dataclasses.replace(arch2, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**30
        ce, _, grads = train_steps.make_train_step(a, opt).loss_and_grads(params, rb)
        torch.cuda.synchronize()
        runs[remat] = (ce, tree.leaves(grads), peak_gib() - base)
    (ce1, g1, peak1), (ce0, g0, peak0) = runs[True], runs[False]
    loss_rel = abs(float(ce1) - float(ce0)) / abs(float(ce0))
    grad_rel = max(rel_max(a, b) for a, b in zip(g1, g0) if b.abs().max() > 0)
    exact = torch.equal(ce1, ce0) and all(torch.equal(a, b) for a, b in zip(g1, g0))
    out["remat"] = dict(layers=LMT_LAYERS, batch=batch, seq=LMT_SEQ, loss_rel=loss_rel,
                        grad_rel=grad_rel, bit_identical=exact, tol=LMT_REMAT_TOL,
                        peak_gib_over_held=dict(remat=peak1, no_remat=peak0))
    if not (loss_rel <= LMT_REMAT_TOL and grad_rel <= LMT_REMAT_TOL):
        raise AssertionError(f"lm_train remat: {out['remat']}")
    say(f"lm_train remat: {json.dumps(out['remat'])}")
    del params, rb, runs, g1, g0, ce1, ce0
    free_card()

    # ---- (c) a restart through TrainDriver at depth LMT_LAYERS, bit for bit
    kw = dict(batch=LMT_RESUME_BATCH, seq=LMT_RESUME_SEQ, total_steps=LMT_RESUME_STEPS,
              ckpt_every=0, device=DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        straight = TrainDriver(arch2, workdir=os.path.join(tmp, "a"), **kw)
        (s1, _), t_straight = synced_wall(straight.run)
        first = TrainDriver(arch2, workdir=os.path.join(tmp, "b"), **kw)
        _, t_first = synced_wall(lambda: first.run(steps=LMT_RESUME_STEPS // 2))
        resumed = TrainDriver(arch2, workdir=os.path.join(tmp, "b"), **kw)
        (s3, step), t_resumed = synced_wall(resumed.run)
    want = [m["loss"] for m in straight.metrics_log]
    got = [m["loss"] for m in resumed.metrics_log]
    same = all(torch.equal(a, b) for a, b in zip(tree.leaves(s1), tree.leaves(s3)))
    out["resume"] = dict(layers=LMT_LAYERS, batch=LMT_RESUME_BATCH, seq=LMT_RESUME_SEQ,
                         losses_straight=want, losses_resumed=got, state_bit_identical=same,
                         walls_s=dict(straight=t_straight, first=t_first, resumed=t_resumed))
    if step != LMT_RESUME_STEPS or got != want[LMT_RESUME_STEPS // 2:] or not same:
        raise AssertionError(f"lm_train resume: not bit for bit: {out['resume']}")
    say(f"lm_train resume: {json.dumps(out['resume'])}")
    del s1, s3, straight, first, resumed
    free_card()

    # ---- (d) the card's float32 smoke step against the CPU's
    small = configs.get(LMT_ARCH).smoke()
    sopt = train_steps.make_optimizer(small, total=10)
    sb = batch_for(small, DataCfg(seed=2, batch=2, seq_len=16), 0, device="cpu")
    metrics = {}
    for dev in ("cpu", DEVICE):
        st = train_steps.init_state(small, 0, sopt, device="cpu")
        st = tree.map_tree(lambda a: a.to(dev), st)
        st["rng"] = st["rng"].cpu()
        _, m = train_steps.make_train_step(small, sopt)(
            st, {k: v.to(dev) for k, v in sb.items()})
        metrics[dev] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    cpu_rel = {k: abs(metrics[DEVICE][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
               for k in ("loss", "grad_norm")}
    out["card_vs_cpu"] = dict(arch=small.name + " smoke", rel=cpu_rel, tol=LMT_CPU_TOL,
                              metrics=metrics)
    if not all(v <= LMT_CPU_TOL for v in cpu_rel.values()):
        raise AssertionError(f"lm_train card vs CPU: {out['card_vs_cpu']}")
    say(f"lm_train card vs CPU: {json.dumps(out['card_vs_cpu'])}")

    out["launches"] = launch_counts()  # the LM train path reaches no TPU kernel
    if any(out["launches"].values()):
        raise AssertionError(f"lm_train: a Ditto kernel launched: {out['launches']}")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# --------------------------------------------------------------------- MoE
MOE_ARCH = "qwen2-moe-a2.7b"  # 24 x 2048, 60 experts top 4 + a shared expert
MOE_PREFILL_LEN, MOE_PREFILL_BATCH = 4096, 2
MOE_DECODE_BATCH, MOE_PROMPT, MOE_DECODE_STEPS = 16, 512, 32
MOE_TRAIN_LAYERS = 4  # full width, depth cut: bf16 params and grads, float32 moments
MOE_TRAIN_BATCH = 4  # grad_accum 4 of the config: microbatches of 1
MOE_TRAIN_SEQ = configs.SHAPES["train_4k"].seq_len
MOE_TRAIN_STEPS = 4
MOE_SMOKE = ("qwen2-moe-a2.7b", "arctic-480b")  # (g), float32, capacity_factor 8
MOE_DEC_TOL = 2e-3  # tests/test_models.py::test_decode_matches_forward
MOE_CPU_TOL = 1e-4


@contextlib.contextmanager
def counting_drops(tally: list):
    """While installed, every MoE layer's routing appends (kept, total)
    (token, choice) slots to ``tally``, as device scalars."""
    from repro_torch.nn import moe

    route = moe.route

    def counted(*a, **kw):
        r = route(*a, **kw)
        tally.append((r[3].sum(), r[3].numel()))
        return r

    moe.route = counted
    try:
        yield
    finally:
        moe.route = route


def drop_share(tally: list) -> float:
    kept = int(torch.stack([k for k, _ in tally]).sum())
    return 1.0 - kept / sum(n for _, n in tally)


def phase_moe() -> dict:
    """The MoE family: (e) qwen2-moe-a2.7b served at full width and depth
    (a 4096-token prefill at B = 2; 32 greedy decode steps at B = 16 after a
    512-token prompt), (f) trained at full width and depth 4 (B = 4, S =
    4096, grad_accum 4, float32 accumulation), (g) the reference's decode
    identity and the card against the CPU at smoke size."""
    free_card()
    t_phase = time.perf_counter()
    zero_counts()
    from repro_torch.models import LM
    from repro_torch.nn import moe

    out: dict = {}
    arch = lm_arch(MOE_ARCH)
    model = LM(arch)
    g = torch.Generator(device=DEVICE).manual_seed(37)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = synced_wall(lambda: model.init(g, device=DEVICE))
    n_params = sum(p.numel() for p in tree.leaves(params))
    out["params"] = dict(arch=arch.name, layers=arch.n_layers, d_model=arch.d_model,
                         experts=[arch.n_experts, arch.top_k], params_b=n_params / 1e9,
                         weights_gib=sum(p.numel() * p.element_size()
                                         for p in tree.leaves(params)) / 2**30,
                         init_s=init_s, init_peak_gib=peak_gib())
    say(f"moe: {json.dumps(out['params'])}")
    prefill, decode = train_steps.make_prefill_step(arch), train_steps.make_decode_step(arch)

    # ---- (e) serving: a long prefill, then greedy decode at B = 16
    prefill(params, lm_inputs(arch, g, 1, 128))  # warm
    batch = lm_inputs(arch, g, MOE_PREFILL_BATCH, MOE_PREFILL_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tally: list = []
    with counting_drops(tally):
        (logits, cache), wall = synced_wall(lambda: prefill(params, batch))
    tok, pad_hit = greedy(logits, arch)
    if not bool(torch.isfinite(logits[..., :arch.vocab_size]).all()) or bool(pad_hit):
        raise AssertionError("moe prefill: logits not finite, or an argmax on a pad column")
    cap = moe.capacity(model.moe_cfg, MOE_PREFILL_LEN)
    out["prefill"] = dict(seq=MOE_PREFILL_LEN, batch=MOE_PREFILL_BATCH, wall_s=wall,
                          tokens_per_s=MOE_PREFILL_BATCH * MOE_PREFILL_LEN / wall,
                          peak_gib=peak_gib(), groups=MOE_PREFILL_BATCH, capacity=cap,
                          dropped_share=drop_share(tally))
    say(f"moe prefill: {json.dumps(out['prefill'])}")
    del logits, cache, batch
    free_card()

    torch.cuda.reset_peak_memory_stats()
    prompt = lm_inputs(arch, g, MOE_DECODE_BATCH, MOE_PROMPT)
    (logits, pc), prompt_s = synced_wall(lambda: prefill(params, prompt))
    cache = padded_cache(model, pc, MOE_PROMPT + MOE_DECODE_STEPS)
    del pc
    tok, pad_any = greedy(logits, arch)
    pos = torch.full((), MOE_PROMPT, dtype=torch.int32, device=DEVICE)
    walls, tally = [], []
    ok = torch.isfinite(logits[..., :arch.vocab_size]).all()
    with counting_drops(tally):
        for _ in range(MOE_DECODE_STEPS):
            step_in = {"tokens": tok, "pos": pos}
            (logits, cache), w = synced_wall(lambda: decode(params, cache, step_in))
            walls.append(w)
            tok, pad_hit = greedy(logits, arch)
            pad_any, ok = pad_any | pad_hit, ok & torch.isfinite(logits[..., :arch.vocab_size]).all()
            pos += 1
    if bool(pad_any) or not bool(ok):
        raise AssertionError("moe decode: an argmax on a pad column, or logits not finite")
    step_s = statistics.median(walls)
    out["decode"] = dict(batch=MOE_DECODE_BATCH, prompt=MOE_PROMPT, steps=MOE_DECODE_STEPS,
                         prompt_prefill_s=prompt_s, step_walls_s=walls,
                         step_ms_median=step_s * 1e3, tokens_per_s=MOE_DECODE_BATCH / step_s,
                         peak_gib=peak_gib(), groups=1,
                         capacity=moe.capacity(model.moe_cfg, MOE_DECODE_BATCH),
                         dropped_share=drop_share(tally))
    say(f"moe decode: {json.dumps(out['decode'])}")
    del logits, cache, params, prompt
    free_card()

    # ---- (f) training at full width, depth MOE_TRAIN_LAYERS
    tarch = dataclasses.replace(arch, n_layers=MOE_TRAIN_LAYERS)
    topt = train_steps.make_optimizer(tarch, base_lr=3e-4, total=MOE_TRAIN_STEPS,
                                      warmup=train_steps.driver_warmup(MOE_TRAIN_STEPS))
    torch.cuda.reset_peak_memory_stats()
    state = train_steps.init_state(tarch, 0, topt, device=DEVICE)
    train = train_steps.make_train_step(tarch, topt)
    accum = train.effective_accum(MOE_TRAIN_BATCH)
    dc = DataCfg(seed=0, batch=MOE_TRAIN_BATCH, seq_len=MOE_TRAIN_SEQ)
    losses, auxes, walls = [], [], []
    for step in range(MOE_TRAIN_STEPS):
        def one():
            nonlocal state
            state, m = train(state, batch_for(tarch, dc, step, device=DEVICE))
            return torch.stack([m["loss"], m["aux"]]).tolist()
        (loss, aux), w = synced_wall(one)
        losses.append(loss)
        auxes.append(aux)
        walls.append(w)
    if not all(math.isfinite(x) for x in losses + auxes) or not all(a > 0 for a in auxes):
        raise AssertionError(f"moe train: loss {losses}, aux {auxes}")
    tp = sum(p.numel() for p in tree.leaves(state["params"]))
    out["train"] = dict(layers=MOE_TRAIN_LAYERS, params_b=tp / 1e9, batch=MOE_TRAIN_BATCH,
                        seq=MOE_TRAIN_SEQ, grad_accum=accum, accum_dtype=tarch.accum_dtype,
                        losses=losses, aux=auxes, step_walls_s=walls,
                        step_wall_s_median=statistics.median(walls[1:]),
                        tokens_per_s=MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
                        / statistics.median(walls[1:]), peak_gib=peak_gib())
    say(f"moe train: {json.dumps(out['train'])}")
    del state, train
    free_card()

    # ---- (g) smoke size, float32, no drops: decode == forward, the card == the CPU
    out["smoke"] = {}
    for name in MOE_SMOKE:
        a = dataclasses.replace(configs.get(name).smoke(), capacity_factor=8.0)
        m = LM(a)
        p_cpu = m.init(torch.Generator().manual_seed(3), device="cpu")
        p_dev = tree.map_tree(lambda t: t.to(DEVICE), p_cpu)
        toks = torch.randint(0, a.vocab_size, (2, 12), generator=torch.Generator().manual_seed(4))
        full, aux_dev = m.forward(p_dev, tokens=toks.to(DEVICE))
        c = m.init_cache(2, 12, device=DEVICE)
        dec = []
        for i in range(12):
            lg, c = m.decode_step(p_dev, c, tokens=toks[:, i:i + 1].to(DEVICE), pos=i)
            dec.append(lg)
        dec_rel = rel_max(torch.cat(dec, dim=1), full)
        on_cpu, aux_cpu = m.forward(p_cpu, tokens=toks)
        cpu_rel = rel_max(full.cpu(), on_cpu)
        aux_rel = abs(float(aux_dev) - float(aux_cpu)) / abs(float(aux_cpu))
        row = dict(decode_vs_forward_rel=dec_rel, card_vs_cpu_rel=cpu_rel, aux_rel=aux_rel)
        out["smoke"][name] = row
        if not (dec_rel < MOE_DEC_TOL and cpu_rel <= MOE_CPU_TOL and aux_rel <= MOE_CPU_TOL):
            raise AssertionError(f"moe smoke {name}: {row}")
    say(f"moe smoke (float32, capacity_factor 8): {json.dumps(out['smoke'])}")

    out["launches"] = launch_counts()  # the MoE path reaches no TPU kernel
    if any(out["launches"].values()):
        raise AssertionError(f"moe: a Ditto kernel launched: {out['launches']}")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# --------------------------------------------------------------- recurrent
REC_XL, REC_ZB = "xlstm-125m", "zamba2-7b"  # the ssm and hybrid families, full width
REC_PREFILL_LEN = configs.SHAPES["prefill_32k"].seq_len  # 32768, at B = 1
REC_PROMPT = 512
REC_DECODE_STEPS = {"ssm": 64, "hybrid": 16}  # zamba2's cut from 64 for the phase's time
REC_XL_DECODE_BATCH = configs.SHAPES["decode_32k"].global_batch  # 128: ~24 MB of states a row
REC_ZB_DECODE_BATCH = 32  # the cell's 128 cut: ~0.89 GB of ring and states a row
REC_CHECK_ROWS = 2  # xlstm decode rows held against a bf16 forward over the same tokens
# (c): the ring wraps over slots 0-127; the forward over 33 x 128 tokens runs the chunked SSD
REC_WRAP_BATCH, REC_WRAP_PROMPT, REC_WRAP_STEPS = 2, 4096, 128
REC_FAR = configs.SHAPES["long_500k"].seq_len  # 524288: decode steps from here
REC_FAR_STEPS = 8
REC_IDENTITY_LEN = 256  # (c): float32 decode / prefill against forward, B = 2; card vs CPU, B = 1
REC_ZB_CUT = dict(n_super=1, n_trailing=3)  # (c): zamba2 at full width, depth 1 x 6 + 3
REC_DEC_TOL, REC_CPU_TOL = 2e-3, 1e-4
REC_CPU_NOISE = 3  # (c): the card vs the CPU within 3x the model's own float32 noise, if larger
REC_TRAIN_SEQ = configs.SHAPES["train_4k"].seq_len  # 4096
REC_XL_TRAIN_BATCHES = (8, 4)  # the cell's 256 cut: the largest of these that fits
REC_XL_TRAIN_STEPS = 2  # cut from 4 for the phase's time: ~45 s a host-bound step
REC_ZB_TRAIN = dict(n_super=2, n_trailing=3)  # (d): ~1.45 B params; the 13 supers need ~69 GB
REC_ZB_TRAIN_BATCH, REC_ZB_TRAIN_STEPS = 4, 2  # grad_accum 4 of the config: microbatches of 1
REC_REMAT = {REC_XL: dict(n_super=1), REC_ZB: dict(n_super=1, n_trailing=1)}
REC_REMAT_BATCH, REC_REMAT_SEQ = 2, 512  # 4 mLSTM / SSD chunks, 2 sLSTM scan segments
REC_REMAT_TOL = 1e-3


def device_profile(fn) -> dict:
    """The device activities (kernels, copies, fills) ``torch.profiler``
    records over ``fn()``, as ``benchmarks/torch_step_profile.py`` counts
    them, and the sum of their device times (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return dict(activities=len(acts),
                device_ms=sum(e.time_range.elapsed_us() for e in acts) / 1e3)


def device_activities(fn) -> int:
    return device_profile(fn)["activities"]


def greedy_decode(decode, params, cache, arch, g, tok, pos, steps, rows=0):
    """``steps`` greedy decode steps from ``tok`` at ``pos`` (a device
    scalar, advanced in place): (the next tokens, cache, step walls, the fed
    tokens' first ``rows`` rows, their logits, a device flag: a pad argmax
    or a non-finite logit)."""
    walls, fed, got = [], [], []
    bad = torch.zeros((), dtype=torch.bool, device=DEVICE)
    for _ in range(steps):
        step_in = dict(next_inputs(arch, g, tok), pos=pos)
        (logits, cache), w = synced_wall(lambda: decode(params, cache, step_in))
        walls.append(w)
        if rows:
            fed.append(step_in["tokens"][:rows])
            got.append(logits[:rows, -1, :arch.vocab_size].clone())
        tok, pad_hit = greedy(logits, arch)
        bad = bad | pad_hit | ~torch.isfinite(logits[..., :arch.vocab_size]).all()
        pos += 1
    return tok, cache, walls, fed, got, bad


def bf16_gate(model, params, seq, got, start) -> dict:
    """The timed bf16 decode's logits ``got`` (rows of ``seq`` from
    ``start``) against a bf16 forward over ``seq`` and against a float32
    forward on the same weights. A recurrent model in bf16 sits far from
    its float32 self at full width (the decode's chunked prefill and the
    forward's cells round apart), so the gate is relative: the decode is
    held to the float32 forward within twice the bf16 forward's own
    distance from it (or ``LM_BF16_TOL``, whichever is larger)."""
    from repro_torch.models import LM

    v = model.cfg.vocab_size
    a32 = dataclasses.replace(model.cfg, param_dtype="float32", activation_dtype="float32")
    with torch.no_grad():
        want16 = model.forward(params, tokens=seq)[0][:, start:, :v]
        p32 = tree.map_tree(lambda t: t.float(), params)
        want32 = LM(a32).forward(p32, tokens=seq)[0][:, start:, :v]
        del p32
    got = torch.stack(got, dim=1)
    row = dict(vs_forward_rel=rel_max(got, want16), vs_float32_rel=rel_max(got, want32),
               forward_vs_float32_rel=rel_max(want16, want32))
    row["tol"] = max(2 * row["forward_vs_float32_rel"], LM_BF16_TOL["logits"])
    row["ok"] = row["vs_float32_rel"] <= row["tol"]
    return row


def rec_serve(name, arch, g, decode_batch) -> dict:
    """(a) / (b): the 32k prefill at B = 1, a 512-token prompt at
    ``decode_batch`` then greedy steps with the position on the card (the
    hybrid's ring widened to its 4096-slot window), and steps from
    position 524,288; the xLSTM's rows 0-1 held to forwards over the same
    tokens (``bf16_gate``)."""
    from repro_torch.models import LM

    model = LM(arch)
    prefill, decode = train_steps.make_prefill_step(arch), train_steps.make_decode_step(arch)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = synced_wall(lambda: model.init(g, device=DEVICE))
    n_params = sum(p.numel() for p in tree.leaves(params))
    out: dict = dict(arch=arch.name, d_model=arch.d_model, n_super=arch.n_super,
                     per_super=arch.per_super, n_trailing=arch.n_trailing,
                     params_b=n_params / 1e9, init_s=init_s, init_peak_gib=peak_gib())
    prefill(params, lm_inputs(arch, g, 1, 256))  # warm

    # ---- the prefill_32k cell's length at B = 1
    batch = lm_inputs(arch, g, 1, REC_PREFILL_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (logits, cache), wall = synced_wall(lambda: prefill(params, batch))
    tok, pad_hit = greedy(logits, arch)
    if not bool(torch.isfinite(logits[..., :arch.vocab_size]).all()) or bool(pad_hit):
        raise AssertionError(f"recurrent {name} prefill: logits not finite, or a pad argmax")
    out["prefill"] = dict(seq=REC_PREFILL_LEN, batch=1, wall_s=wall,
                          tokens_per_s=REC_PREFILL_LEN / wall, peak_gib=peak_gib(),
                          cell_batch=configs.SHAPES["prefill_32k"].global_batch)
    say(f"recurrent {name} prefill: {json.dumps(out['prefill'])}")
    del logits, cache, batch
    free_card()

    # ---- a 512-token prompt, then greedy decode with the position on the card
    torch.cuda.reset_peak_memory_stats()
    prompt = lm_inputs(arch, g, decode_batch, REC_PROMPT)
    (logits, pc), prompt_s = synced_wall(lambda: prefill(params, prompt))
    cache = padded_cache(model, pc, configs.SHAPES["decode_32k"].seq_len)  # the ring to 4096
    del pc
    tok, bad = greedy(logits, arch)
    pos = torch.full((), REC_PROMPT, dtype=torch.int32, device=DEVICE)
    rows = REC_CHECK_ROWS if arch.family == "ssm" else 0
    steps = REC_DECODE_STEPS[arch.family]
    tok, cache, walls, fed, got, bad2 = greedy_decode(decode, params, cache, arch, g, tok,
                                                      pos, steps, rows)
    if bool(bad | bad2):
        raise AssertionError(f"recurrent {name} decode: a pad argmax or a non-finite logit")
    step_s = statistics.median(walls)
    out["decode"] = dict(batch=decode_batch, prompt=REC_PROMPT, steps=steps,
                         prompt_prefill_s=prompt_s, step_walls_s=walls,
                         step_ms_median=step_s * 1e3, tokens_per_s=decode_batch / step_s,
                         peak_gib=peak_gib(), cache_gib=sum(
                             t.numel() * t.element_size() for t in cache.values()) / 2**30,
                         cell_batch=configs.SHAPES["decode_32k"].global_batch)
    if rows:  # the timed path against forwards over the same 576 tokens (the cells)
        seq = torch.cat([prompt["tokens"][:rows]] + fed, dim=1)
        out["decode"]["bf16_check"] = bf16_gate(model, params, seq, got, REC_PROMPT)
        del seq
        if not out["decode"]["bf16_check"]["ok"]:
            raise AssertionError(f"recurrent {name} decode vs forward: {out['decode']}")
        # the host-bound loop's launches: one prefill of the prompt's length, one step
        one = lm_inputs(arch, g, 1, REC_PROMPT)
        step_in = dict(tokens=tok, pos=pos)
        out["device_activities"] = dict(
            prefill_tokens=REC_PROMPT, prefill=device_activities(lambda: prefill(params, one)),
            decode_batch=decode_batch,
            decode_step=device_activities(lambda: decode(params, cache, step_in)))
        out["device_activities"]["prefill_per_token"] = (
            out["device_activities"]["prefill"] / REC_PROMPT)
        say(f"recurrent {name} device activities: {json.dumps(out['device_activities'])}")
        del one
    say(f"recurrent {name} decode: " + json.dumps(
        {k: v for k, v in out["decode"].items() if k != "step_walls_s"}))
    del fed, got, prompt, logits

    # ---- long_500k: steps from position 524,288 (the ring and the states have no end)
    fpos = torch.full((), REC_FAR, dtype=torch.int32, device=DEVICE)
    tok, cache, fwalls, _, _, bad = greedy_decode(decode, params, cache, arch, g, tok, fpos,
                                                  REC_FAR_STEPS)
    if bool(bad):
        raise AssertionError(f"recurrent {name}: a decode step past {REC_FAR} is not finite")
    out["far"] = dict(first_pos=REC_FAR, steps=REC_FAR_STEPS, batch=tok.shape[0],
                      step_ms_median=statistics.median(fwalls) * 1e3)
    say(f"recurrent {name} far: {json.dumps(out['far'])}")
    del params, cache
    free_card()
    return out


@torch.no_grad()  # values only, as the serving steps run
def rec_identities(arch) -> dict:
    """(c): float32 at full width: decode (the position on the card) ==
    forward over ``REC_IDENTITY_LEN`` tokens (the forward chunked, the
    decode the cells), prefill's last logits == forward's, the card's
    forward against the CPU's on the same weights (within ``REC_CPU_TOL``,
    or ``REC_CPU_NOISE`` times the model's own float32 noise where that is
    larger), and for the hybrid a decode that wraps its 4096-slot ring ==
    the windowed forward."""
    from repro_torch.models import LM

    a32 = dataclasses.replace(arch, param_dtype="float32", activation_dtype="float32")
    m32 = LM(a32)
    p_cpu = m32.init(torch.Generator().manual_seed(41), device="cpu")
    p32 = tree.map_tree(lambda t: t.to(DEVICE), p_cpu)
    toks = torch.randint(0, arch.vocab_size, (2, REC_IDENTITY_LEN),
                         generator=torch.Generator().manual_seed(43)).to(DEVICE)
    full, _ = m32.forward(p32, tokens=toks)
    cache = m32.init_cache(2, REC_IDENTITY_LEN, device=DEVICE)
    dec, dpos = [], torch.zeros((), dtype=torch.int32, device=DEVICE)
    for i in range(REC_IDENTITY_LEN):
        lg, cache = m32.decode_step(p32, cache, tokens=toks[:, i:i + 1], pos=dpos)
        dec.append(lg)
        dpos += 1
    dec_rel = rel_max(torch.cat(dec, dim=1), full)
    last, _ = m32.prefill(p32, tokens=toks)
    pre_ratio = float(((last[:, 0] - full[:, -1]).abs() / (2e-4 * (1 + full[:, -1].abs()))).max())
    on_card, _ = m32.forward(p32, tokens=toks[:1])
    (on_cpu, _), cpu_s = synced_wall(lambda: m32.forward(p_cpu, tokens=toks[:1].cpu()))
    # the model's own float32 noise: the CPU logits' move when each embedding
    # entry moves by about one ulp (the port's zamba2 at random weights
    # amplifies it ~2000x)
    table = p_cpu["embed"]["table"]
    jitter = torch.randn(table.shape, generator=torch.Generator().manual_seed(47))
    nudged, _ = m32.forward(dict(p_cpu, embed={"table": table * (1 + 1e-7 * jitter)}),
                            tokens=toks[:1].cpu())
    real = slice(0, arch.vocab_size)
    cpu_rel = rel_max(on_card[..., real].cpu(), on_cpu[..., real])
    noise = rel_max(nudged[..., real], on_cpu[..., real])
    row = dict(layers=[a32.n_super, a32.per_super, a32.n_trailing], seq=REC_IDENTITY_LEN,
               decode_vs_forward_rel=dec_rel, prefill_vs_forward_tol_share=pre_ratio,
               card_vs_cpu_rel=cpu_rel, cpu_ulp_noise_rel=noise,
               card_vs_cpu_tol=max(REC_CPU_TOL, REC_CPU_NOISE * noise), cpu_forward_s=cpu_s)
    del nudged, jitter
    if arch.family == "hybrid":  # the ring wraps: 128 steps past a 4096-token prompt
        wt = torch.randint(0, arch.vocab_size, (REC_WRAP_BATCH, REC_WRAP_PROMPT + REC_WRAP_STEPS),
                           generator=torch.Generator().manual_seed(53)).to(DEVICE)
        _, wc = m32.prefill(p32, tokens=wt[:, :REC_WRAP_PROMPT])
        wpos, wdec = torch.full((), REC_WRAP_PROMPT, dtype=torch.int32, device=DEVICE), []
        for i in range(REC_WRAP_PROMPT, REC_WRAP_PROMPT + REC_WRAP_STEPS):
            lg, wc = m32.decode_step(p32, wc, tokens=wt[:, i:i + 1], pos=wpos)
            wdec.append(lg)
            wpos += 1
        want = m32.forward(p32, tokens=wt)[0][:, REC_WRAP_PROMPT:]
        slots = wc["a_p"][0, :REC_WRAP_STEPS + 1].tolist()
        row["ring_wrap"] = dict(batch=REC_WRAP_BATCH, prompt=REC_WRAP_PROMPT,
                                steps=REC_WRAP_STEPS, ring=wc["a_k"].shape[2],
                                decode_vs_forward_rel=rel_max(torch.cat(wdec, dim=1), want),
                                slots_ok=slots == list(range(REC_WRAP_PROMPT, REC_WRAP_PROMPT
                                                             + REC_WRAP_STEPS)) + [REC_WRAP_STEPS])
        del wc, wdec, want
    wrap = row.get("ring_wrap", dict(decode_vs_forward_rel=0.0, slots_ok=True))
    if not (dec_rel < REC_DEC_TOL and pre_ratio <= 1 and cpu_rel <= row["card_vs_cpu_tol"]
            and wrap["decode_vs_forward_rel"] < REC_DEC_TOL and wrap["slots_ok"]):
        raise AssertionError(f"recurrent {arch.name} identities: {row}")
    say(f"recurrent {arch.name} identities (float32): {json.dumps(row)}")
    del p32, p_cpu, cache, full, dec, on_card, on_cpu
    free_card()
    return row


def rec_train(arch, batches, steps) -> dict:
    """(d): ``steps`` train steps at ``train_4k``'s S through ``init_state``
    / ``make_train_step`` (the config's grad_accum) at the first of
    ``batches`` that fits; finite losses."""
    opt = train_steps.make_optimizer(arch, base_lr=3e-4, total=steps,
                                     warmup=train_steps.driver_warmup(steps))
    train = train_steps.make_train_step(arch, opt)
    refused = []
    for batch in batches:
        torch.cuda.reset_peak_memory_stats()
        state = None
        try:
            state = train_steps.init_state(arch, 0, opt, device=DEVICE)
            dc = DataCfg(seed=0, batch=batch, seq_len=REC_TRAIN_SEQ)
            losses, walls = [], []
            for step in range(steps):
                def one():
                    nonlocal state
                    state, m = train(state, batch_for(arch, dc, step, device=DEVICE))
                    return float(m["loss"])
                loss, w = synced_wall(one)
                losses.append(loss)
                walls.append(w)
            break
        except torch.cuda.OutOfMemoryError as e:
            refused.append({"batch": batch, "error": str(e).splitlines()[0][:160]})
        state = None  # the error (and its frames) are gone here: free their memory
        free_card()
    else:
        raise AssertionError(f"recurrent {arch.name} train: no batch of {batches} fits: {refused}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"recurrent {arch.name} train: a loss is not finite: {losses}")
    step_s = statistics.median(walls[1:])
    row = dict(layers=[arch.n_super, arch.per_super, arch.n_trailing],
               params_b=sum(p.numel() for p in tree.leaves(state["params"])) / 1e9,
               seq=REC_TRAIN_SEQ, batch=batch, refused=refused,
               grad_accum=train.effective_accum(batch), losses=losses, step_walls_s=walls,
               step_wall_s_median=step_s, tokens_per_s=batch * REC_TRAIN_SEQ / step_s,
               peak_gib=peak_gib(), cell_batch=configs.SHAPES["train_4k"].global_batch)
    say(f"recurrent {arch.name} train: {json.dumps(row)}")
    del state, train
    free_card()
    return row


def rec_remat(arch) -> dict:
    """(d): at a depth cut, the loss and gradients with remat on and off
    (within ``REC_REMAT_TOL`` relative; whether bit-identical), both peaks."""
    from repro_torch.models import LM

    params = LM(arch).init(torch.Generator(device=DEVICE).manual_seed(5), device=DEVICE)
    rb = batch_for(arch, DataCfg(seed=1, batch=REC_REMAT_BATCH, seq_len=REC_REMAT_SEQ), 0,
                   device=DEVICE)
    opt = train_steps.make_optimizer(arch)
    runs = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2**30
        ce, _, grads = train_steps.make_train_step(dataclasses.replace(arch, remat=remat),
                                                   opt).loss_and_grads(params, rb)
        torch.cuda.synchronize()
        runs[remat] = (ce, tree.leaves(grads), peak_gib() - base)
    (ce1, g1, peak1), (ce0, g0, peak0) = runs[True], runs[False]
    row = dict(layers=[arch.n_super, arch.per_super, arch.n_trailing], batch=REC_REMAT_BATCH,
               seq=REC_REMAT_SEQ, loss_rel=abs(float(ce1) - float(ce0)) / abs(float(ce0)),
               grad_rel=max(rel_max(a, b) for a, b in zip(g1, g0) if b.abs().max() > 0),
               bit_identical=torch.equal(ce1, ce0) and all(torch.equal(a, b)
                                                           for a, b in zip(g1, g0)),
               tol=REC_REMAT_TOL, peak_gib_over_held=dict(remat=peak1, no_remat=peak0))
    if not (row["loss_rel"] <= REC_REMAT_TOL and row["grad_rel"] <= REC_REMAT_TOL):
        raise AssertionError(f"recurrent {arch.name} remat: {row}")
    say(f"recurrent {arch.name} remat: {json.dumps(row)}")
    del params, rb, runs, g1, g0
    free_card()
    return row


def phase_recurrent() -> dict:
    """The recurrent LM families at full width: (a) xlstm-125m and (b)
    zamba2-7b served (a 32k prefill, greedy decode, the ring wrap, steps
    from position 524,288), (c) the float32 identities and the card against
    the CPU, (d) training at ``train_4k``'s S and remat on against off."""
    free_card()
    t_phase = time.perf_counter()
    zero_counts()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("recurrent: TF32 is on; the float32 identities need it off")
    out: dict = {}
    xl, zb = lm_arch(REC_XL), lm_arch(REC_ZB)
    walls = {}
    t = time.perf_counter()
    out["xlstm"] = rec_serve(REC_XL, xl, torch.Generator(device=DEVICE).manual_seed(47),
                             REC_XL_DECODE_BATCH)
    walls["a"] = time.perf_counter() - t
    t = time.perf_counter()
    out["zamba2"] = rec_serve(REC_ZB, zb, torch.Generator(device=DEVICE).manual_seed(53),
                              REC_ZB_DECODE_BATCH)
    walls["b"] = time.perf_counter() - t
    t = time.perf_counter()
    out["identities"] = {REC_XL: rec_identities(xl),
                         REC_ZB: rec_identities(dataclasses.replace(zb, **REC_ZB_CUT))}
    walls["c"] = time.perf_counter() - t
    t = time.perf_counter()
    out["train"] = {
        REC_XL: rec_train(xl, REC_XL_TRAIN_BATCHES, REC_XL_TRAIN_STEPS),
        REC_ZB: rec_train(dataclasses.replace(zb, **REC_ZB_TRAIN), (REC_ZB_TRAIN_BATCH,),
                          REC_ZB_TRAIN_STEPS)}
    out["remat"] = {n: rec_remat(dataclasses.replace(a, **REC_REMAT[n]))
                    for n, a in ((REC_XL, xl), (REC_ZB, zb))}
    walls["d"] = time.perf_counter() - t
    out["part_walls_s"] = walls
    out["launches"] = launch_counts()  # the recurrent paths reach no TPU kernel: all 0
    if any(out["launches"].values()):
        raise AssertionError(f"recurrent: a Ditto kernel launched: {out['launches']}")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------- distributed
DIST_LM = "qwen3-0.6b"  # (b) and (c): full width, bf16 params
DIST_RESTORE_LAYERS = 2  # (b): the restored train state at full width, depth 2
DIST_RESTORE_STEPS, DIST_RESTORE_BATCH, DIST_RESTORE_SEQ = 2, 2, 1024
DIST_GRAD_SEQ = LMT_SEQ  # (c): one full-depth loss_and_grads at S = 4096, B = 1
DIST_ROUNDS = 20  # (c): g (1 + 0.05 i), as examples/train_lm.py
DIST_TOL = 1e-4  # (c): tests/test_runtime.py::test_compressed_psum_error_feedback_converges
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS = 4, 4, 4  # (d): 4 stages of 7 blocks, B = 16
PIPE_KERNELS = ("int8_matmul",)


def dist_rules() -> dict:
    """(a): ``param_axes`` and ``spec_for`` for every config at full width on
    both production meshes, with no card memory allocated."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t = time.perf_counter()
    rows = {}
    for name in configs.names():
        arch = configs.get(name)
        axes, shapes = train_steps.param_axes(arch)
        row = dict(leaves=len(tree.leaves(axes)),
                   params_b=sum(s.numel() for s in tree.leaves(shapes)) / 1e9)
        for multi_pod in (False, True):
            mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
            rules = sharding.make_rules(arch, multi_pod=multi_pod)
            specs = [sharding.spec_for(a, tuple(s.shape), rules, mesh)
                     for a, s in zip(tree.leaves(axes), tree.leaves(shapes))]
            key = "x".join(map(str, mesh.axis_sizes))
            row[f"sharded_{key}"] = sum(any(e is not None for e in sp) for sp in specs)
            row[f"per_chip_gib_{key}"] = sharding.sharded_bytes(axes, shapes, rules, mesh) / 2**30
        rows[name] = row
    q_axes, q_shapes = train_steps.param_axes(configs.get("dit-xl2"), int8=True)
    torch.cuda.synchronize()
    out = dict(configs=rows, dit_int8_leaves=len(tree.leaves(q_axes)),
               dit_int8_sharded=sum(bool(a) for a in tree.leaves(q_axes)),
               wall_s=time.perf_counter() - t,
               allocated_delta=torch.cuda.memory_allocated() - held,
               peak_delta=torch.cuda.max_memory_allocated() - held)
    if out["allocated_delta"] or out["peak_delta"]:
        raise AssertionError(f"distributed rules: card memory moved: {out}")
    say(f"distributed rules: {json.dumps(out)}")
    return out


def dist_restore(mesh) -> dict:
    """(b): qwen3-0.6b's full-width params laid out by ``param_shardings`` on
    the one-rank (1, 1) mesh, and a depth-2 train state restored with
    ``shardings=``, each leaf bit for bit."""
    from repro_torch.models import LM

    arch = lm_arch(DIST_LM)
    rules = sharding.make_rules(arch)
    axes, _ = train_steps.param_axes(arch)
    params = LM(arch).init(torch.Generator(device=DEVICE).manual_seed(61), device=DEVICE)
    lays = sharding.param_shardings(axes, params, rules, mesh)
    same = [torch.equal(sharding.layout(p, lay).to_local(), p)
            for p, lay in zip(tree.leaves(params), tree.leaves(lays))]
    out = dict(mesh=list(mesh.shape), device_type=mesh.device_type, leaves=len(same),
               layout_bit_identical=all(same))
    del params, lays
    free_card()

    arch2 = dataclasses.replace(arch, n_layers=DIST_RESTORE_LAYERS)
    axes2, _ = train_steps.param_axes(arch2)
    with tempfile.TemporaryDirectory() as tmp:
        driver = TrainDriver(arch2, workdir=tmp, batch=DIST_RESTORE_BATCH, seq=DIST_RESTORE_SEQ,
                             total_steps=DIST_RESTORE_STEPS, ckpt_every=0, device=DEVICE)
        state, step = driver.run()
        shardings = {"params": sharding.param_shardings(axes2, state["params"], rules, mesh),
                     "opt": tree.map_tree(lambda _: sharding.replicated(mesh), state["opt"]),
                     "rng": sharding.replicated(mesh)}
        (restored, wall) = synced_wall(lambda: driver.ckpt.restore(step, state,
                                                                   shardings=shardings))
    same2 = [torch.equal(d.to_local().cpu(), a.cpu())
             for a, d in zip(tree.leaves(state), tree.leaves(restored))]
    out.update(restore_layers=DIST_RESTORE_LAYERS, restore_step=step,
               restore_leaves=len(same2), restore_bit_identical=all(same2),
               restore_wall_s=wall)
    if not (out["layout_bit_identical"] and out["restore_bit_identical"]):
        raise AssertionError(f"distributed layouts / restore: not bit for bit: {out}")
    say(f"distributed restore: {json.dumps(out)}")
    del state, restored, driver
    free_card()
    return out


def dist_allreduce() -> dict:
    """(c): ``DIST_ROUNDS`` rounds of ``compressed_psum_grads`` over the
    one-rank NCCL group on qwen3-0.6b's full-width gradients (float32
    copies) scaled by (1 + 0.05 i); accumulated means plus the residual
    within ``DIST_TOL`` (relative L2, each leaf) of the exact sum."""
    from repro_torch.models import LM

    arch = lm_arch(DIST_LM)
    params = LM(arch).init(torch.Generator(device=DEVICE).manual_seed(67), device=DEVICE)
    opt = train_steps.make_optimizer(arch)
    batch = batch_for(arch, DataCfg(seed=3, batch=1, seq_len=DIST_GRAD_SEQ), 0, device=DEVICE)
    _, _, grads = train_steps.make_train_step(arch, opt).loss_and_grads(params, batch)
    del params, batch
    grads = tree.map_tree(lambda g: g.to(torch.float32), grads)
    free_card()
    resid = collectives.zeros_residuals(grads)
    acc = tree.map_tree(torch.zeros_like, grads)
    exact = tree.map_tree(torch.zeros_like, grads)
    walls = []
    for i in range(DIST_ROUNDS):
        gi = tree.map_tree(lambda g: g * (1 + 0.05 * i), grads)
        (mean, resid), w = synced_wall(lambda: collectives.compressed_psum_grads(gi, resid))
        walls.append(w)
        for a, e, m, g in zip(*map(tree.leaves, (acc, exact, mean, gi))):
            a.add_(m)
            e.add_(g)
        del gi, mean
    rel = [float(torch.linalg.norm(a + r - e) / torch.linalg.norm(e))
           for a, r, e in zip(*map(tree.leaves, (acc, resid, exact))) if e.any()]
    numel = sum(g.numel() for g in tree.leaves(grads))
    n_leaves = len(tree.leaves(grads))
    out = dict(arch=arch.name, seq=DIST_GRAD_SEQ, batch=1, rounds=DIST_ROUNDS, leaves=n_leaves,
               numel=numel, rel_l2_max=max(rel), tol=DIST_TOL,
               round_ms_median=statistics.median(walls[1:]) * 1e3,
               round_ms_first=walls[0] * 1e3,
               payload_bytes_int8=numel + 4 * n_leaves, payload_bytes_fp32=4 * numel)
    if not out["rel_l2_max"] <= DIST_TOL:
        raise AssertionError(f"distributed all-reduce: {out}")
    say(f"distributed all-reduce: {json.dumps(out)}")
    del grads, resid, acc, exact
    free_card()
    return out


def pipe_layer(cfg):
    """``layer_fn`` of the W8A8 pipeline: a microbatch's activation is its
    tokens with the activated conditioning appended as one more row (both
    d wide), so ``c_act`` travels with its microbatch."""
    def layer(bp, h):
        x = dit_int8.block(bp, h[:, :-1].contiguous(), h[:, -1].contiguous(), cfg)
        return torch.cat([x, h[:, -1:]], dim=1)
    return layer


def pipe_sequential(blocks, x, c_act, cfg, m) -> torch.Tensor:
    """The W8A8 block stack run on each of ``m`` microbatches in turn."""
    layers = tree.map_tree(lambda a: a.unbind(0), blocks)
    outs = []
    for xj, cj in zip(x.chunk(m), c_act.chunk(m)):
        for i in range(cfg.n_layers):
            xj = dit_int8.block(tree.map_tree(lambda a, i=i: a[i], layers), xj, cj, cfg)
        outs.append(xj)
    return torch.cat(outs)


def dist_pipeline() -> dict:
    """(d): DiT-XL/2's W8A8 blocks through ``pipeline_apply`` over
    ``PIPE_STAGES`` stages on the one card, ``PIPE_MICRO`` microbatches of
    ``PIPE_ROWS`` rows; bit for bit against the sequential stack on each
    microbatch; every ``int8_matmul`` launch held to its plain version."""
    cfg = CFG
    params = dit.init(torch.Generator(device=DEVICE).manual_seed(71), cfg, device=DEVICE)
    blocks = dit_int8.quantize_params(params, cfg)["blocks"]
    del params
    free_card()
    g = torch.Generator(device=DEVICE).manual_seed(73)
    b = PIPE_MICRO * PIPE_ROWS
    x = torch.randn((b, cfg.n_tokens, cfg.d_model), generator=g, device=DEVICE)
    c_act = torch.nn.functional.silu(torch.randn((b, cfg.d_model), generator=g, device=DEVICE))
    h = torch.cat([x, c_act[:, None]], dim=1)
    stages = (torch.device(DEVICE),) * PIPE_STAGES
    layer = pipe_layer(cfg)

    def run_pipe():
        return pipeline.pipeline_apply(layer, blocks, h, stages=stages,
                                       n_microbatches=PIPE_MICRO)

    with int8_held_exactly("pipeline") as held:
        zero_counts()
        got = run_pipe()
        launches = launch_counts()
    want = pipe_sequential(blocks, x, c_act, cfg, PIPE_MICRO)
    n_products = PIPE_MICRO * cfg.n_layers * 7
    out = dict(stages=PIPE_STAGES, microbatches=PIPE_MICRO, rows=PIPE_ROWS, layers=cfg.n_layers,
               bit_identical=torch.equal(got[:, :-1], want) and torch.equal(got[:, -1], c_act),
               finite=bool(torch.isfinite(got).all()),
               launches={k: v for k, v in launches.items() if v}, held_exact_per_shape=held,
               want_launches=n_products)
    runs = {"pipeline": run_pipe,
            "sequential": lambda: pipe_sequential(blocks, x, c_act, cfg, PIPE_MICRO)}
    walls = {k: [] for k in runs}
    for order in (("pipeline", "sequential"), ("sequential", "pipeline")) * 3:
        for k in order:
            walls[k].append(synced_wall(runs[k])[1])
    out["wall_ms"] = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    out["wall_ms_each"] = {k: [w * 1e3 for w in v] for k, v in walls.items()}
    out["device"] = {k: device_profile(fn) for k, fn in runs.items()}
    out["note"] = ("one card: every stage on cuda:0, so the pipeline's wall against the "
                   "sequential one is the schedule's own cost, not a pipelining gain")
    if not (out["bit_identical"] and out["finite"]):
        raise AssertionError(f"distributed pipeline: not bit for bit: {out}")
    short = {k: launches[k] for k in PIPE_KERNELS if launches[k] != n_products}
    if short or sum(held.values()) != n_products:
        raise AssertionError(f"distributed pipeline: launches {short}, held "
                             f"{sum(held.values())}, want {n_products}")
    say(f"distributed pipeline: {json.dumps(out)}")
    del blocks, x, c_act, h, got, want
    free_card()
    return out


def phase_distributed() -> dict:
    """The rest of ``distributed/`` on one rank: (a) the sharding rules of
    every config, (b) layouts and the elastic restore, (c) the compressed
    all-reduce, (d) the W8A8 pipeline."""
    free_card()
    t_phase = time.perf_counter()
    zero_counts()
    out: dict = {}
    walls = {}
    with mesh_mod.local_group(DEVICE):
        t = time.perf_counter()
        out["rules"] = dist_rules()
        walls["a"] = time.perf_counter() - t
        t = time.perf_counter()
        out["restore"] = dist_restore(mesh_mod.make_test_mesh())
        walls["b"] = time.perf_counter() - t
        t = time.perf_counter()
        out["allreduce"] = dist_allreduce()
        walls["c"] = time.perf_counter() - t
    if any(launch_counts().values()):  # (a) - (c) reach no TPU kernel
        raise AssertionError(f"distributed: a Ditto kernel launched: {launch_counts()}")
    t = time.perf_counter()
    out["pipeline"] = dist_pipeline()
    walls["d"] = time.perf_counter() - t
    out["part_walls_s"] = walls
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------------------ launch
# (a): one batch a cell, the cuts the earlier phases run (PERF.md section 4);
# a cell no phase runs takes the cut of its shape
LAUNCH_BATCH = {"train_4k": LMT_BATCHES[0], "prefill_32k": LM_PREFILL_BATCH,
                "decode_32k": LM_DECODE_BATCH, "long_500k": 1}
LAUNCH_BATCH_OF = {("xlstm-125m", "train_4k"): REC_XL_TRAIN_BATCHES[0],
                   ("xlstm-125m", "decode_32k"): REC_XL_DECODE_BATCH,
                   ("zamba2-7b", "train_4k"): 1,  # one of the cut's 4 microbatches
                   ("zamba2-7b", "decode_32k"): REC_ZB_DECODE_BATCH,
                   ("dit-xl2", "train_4k"): TRAIN_BATCH}
LAUNCH_DIT_BATCH = B  # the denoiser cells: the slice's B = 2
# (a): the recurrent families' prefill_32k and train_4k run a few ops a token
# (10-100 ms of counting a token on the host): cut to the dry run's
# extrapolation base; the CPU's `dryrun --all` counts them whole
LAUNCH_REC_SEQ = dryrun.EXTRAPOLATE_LEN
LAUNCH_WORKERS = max(1, (os.cpu_count() or 2) - 1)  # (a): a process a core, the card hidden
LAUNCH_PEAK_TOL = 0.2  # (b): predicted against measured peak, relative
LAUNCH_TIMED = 3  # (b): timed runs a cell after the counted one (the LM prefill: 1)
# (b): (arch, shape, batch, variant)
LAUNCH_CHECKS = (
    (LM_ARCH, "prefill_32k", LM_PREFILL_BATCH, ""),
    (LM_ARCH, "decode_32k", LM_DECODE_BATCH, ""),
    (LMT_ARCH, "train_4k", LMT_BATCHES[0], ""),
    ("dit-xl2", "prefill_32k", LAUNCH_DIT_BATCH, ""),
    ("dit-xl2", "prefill_32k", LAUNCH_DIT_BATCH, "int8"),
)


def launch_arch(name: str) -> configs.ArchConfig:
    """The config a launch cell runs: DiT-XL/2 in float32, as the serving
    phases run it; the LM configs as ``lm_arch`` gives them."""
    if name == "dit-xl2":
        return dataclasses.replace(configs.get(name), param_dtype="float32",
                                   activation_dtype="float32")
    return lm_arch(name)


def launch_cells() -> list[tuple]:
    """(a)'s cells: every (arch, shape) with its batch and sequence cut, the
    slowest to count (the recurrent families' long cells) first."""
    cells = []
    for name in configs.names():
        for shape in configs.SHAPES:
            batch = LAUNCH_BATCH_OF.get((name, shape), LAUNCH_BATCH[shape])
            if name == "dit-xl2" and shape != "train_4k":
                batch = LAUNCH_DIT_BATCH
            recurrent = configs.get(name).family in ("ssm", "hybrid")
            seq = LAUNCH_REC_SEQ if recurrent and shape in ("train_4k", "prefill_32k") else None
            cells.append((name, shape, batch, seq))
    return sorted(cells, key=lambda c: (c[3] is None, c[1] != "train_4k"))


def dry_cell(cell) -> dict:
    """One (a) cell's one-card record (run in a worker process)."""
    name, shape, batch, seq = cell
    try:
        return dryrun.run_cell(name, shape, mesh="1", batch=batch, seq=seq)
    except Exception as e:  # noqa: BLE001 - the phase fails on any error record
        return dict(arch=name, shape=shape, batch=batch, seq=seq, status="error",
                    error=f"{type(e).__name__}: {e}")


def launch_dry_all() -> dict:
    """(a): the one-card dry run of every cell at full width, on fake
    tensors in worker processes that cannot see the card, then the layout
    records of both production meshes in this process; no card memory may
    move."""
    import multiprocessing

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t = time.perf_counter()
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # the workers count on meta tensors
    try:
        pool = multiprocessing.get_context("spawn").Pool(LAUNCH_WORKERS)
    finally:
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    with pool:
        recs = pool.map(dry_cell, launch_cells(), chunksize=1)
    one_card_s = time.perf_counter() - t
    for rec in recs:
        say(f"launch (a) {rec['arch']} {rec['shape']} B={rec.get('batch')} S={rec.get('seq')} "
            f"{rec['status']}{dryrun.summary(rec)}")
    t = time.perf_counter()
    layouts = [dryrun.run_cell(name, shape, mesh=m)
               for name in configs.names() for shape in configs.SHAPES
               for m in ("16x16", "2x16x16")]
    for rec in layouts:
        say(f"launch (a) {rec['arch']} {rec['shape']} {rec['mesh']} "
            f"{rec['status']}{dryrun.summary(rec)}")
    torch.cuda.synchronize()
    out = dict(cells=len(recs), ok=sum(r["status"] == "ok" for r in recs),
               skip=sum(r["status"] == "skip" for r in recs),
               layout=sum(r["status"] == "layout" for r in layouts),
               fits=sum(bool(r.get("fits")) for r in recs),
               one_card_wall_s=one_card_s, layout_wall_s=time.perf_counter() - t,
               workers=LAUNCH_WORKERS,
               allocated_delta=torch.cuda.memory_allocated() - held,
               peak_delta=torch.cuda.max_memory_allocated() - held)
    bad = [r for r in recs + layouts if r["status"] not in ("ok", "skip", "layout")]
    if bad:
        raise AssertionError(f"launch (a): cells failed: {bad}")
    if out["allocated_delta"] or out["peak_delta"]:
        raise AssertionError(f"launch (a): card memory moved: {out}")
    say(f"launch (a): {json.dumps(out)}")
    return out


def launch_args(arch, shape, batch, variant):
    """(step, args) of a (b) cell on the card: random weights and inputs of
    ``input_specs``' shapes and dtypes."""
    from repro_torch.models import LM

    g = torch.Generator(device=DEVICE).manual_seed(0)
    spec = configs.SHAPES[shape]
    specs = configs.input_specs(arch, spec, batch_override=batch)

    def real(t):
        if t.dtype in (torch.int32, torch.int64):
            hi = arch.n_classes if arch.family == "diffusion" else arch.vocab_size
            return torch.randint(0, hi, tuple(t.shape), generator=g, dtype=t.dtype,
                                 device=DEVICE)
        return torch.randn(tuple(t.shape), generator=g, device=DEVICE).to(t.dtype)

    batch_in = {k: real(v) for k, v in specs.items()}
    if arch.family == "diffusion":
        params = dit.init(g, train_steps.make_dit_model(arch), device=DEVICE,
                          dtype=configs.torch_dtype(arch.param_dtype))
        if variant == "int8":
            params = dit_int8.quantize_params(params, train_steps.make_dit_model(arch))
        batch_in["t"] = torch.rand((batch,), generator=g, device=DEVICE) * 999.0
        return train_steps.make_denoise_step(arch, int8=variant == "int8"), (params, batch_in)
    if spec.kind == "train":
        opt = train_steps.make_optimizer(arch)
        state = train_steps.init_state(arch, 0, opt, device=DEVICE)
        return train_steps.make_train_step(arch, opt), (state, batch_in)
    params = LM(arch).init(g, device=DEVICE)
    if spec.kind == "prefill":
        return train_steps.make_prefill_step(arch), (params, batch_in)
    batch_in["pos"] = torch.tensor(LM_PROMPT, dtype=torch.int32, device=DEVICE)
    cache = LM(arch).init_cache(batch, spec.seq_len, device=DEVICE)
    return train_steps.make_decode_step(arch), (params, cache, batch_in)


def formula_flops(arch, shape, batch) -> int | None:
    """The matmul FLOPs of the hand formulas (``train_flops``,
    ``lm_train_flops``) for a (b) cell: a forward is a third of a step."""
    from repro_torch.models import LM

    spec = configs.SHAPES[shape]
    if arch.family == "diffusion":
        return train_flops(train_steps.make_dit_model(arch), batch) // 3
    if spec.kind == "decode":
        return None
    step = lm_train_flops(arch, LM(arch).vocab_padded, batch, spec.seq_len)
    if spec.kind == "train":
        return step
    # a prefill's forward; its head runs on the last position alone
    d, v = arch.d_model, LM(arch).vocab_padded
    return step // 3 - 2 * batch * (spec.seq_len - 1) * d * v


def launch_check(name, shape, batch, variant) -> dict:
    """(b): one cell's dry run held against the card."""
    arch = launch_arch(name)
    rec = dryrun.run_cell(arch, shape, mesh="1", batch=batch, variant=variant)
    free_card()
    fn, args = launch_args(arch, shape, batch, variant)
    # the analyzer on the card: the same ops, so the same counts exactly
    real = op_analysis.analyze(fn, *args)
    del real["out"]
    cost = rec["cost"]
    got = dict(flops=real["flops"], bytes=real["hbm_bytes"], kernels=real["kernels"])
    want = dict(flops=cost["flops_per_device"], bytes=cost["bytes_per_device"],
                kernels=cost["kernels"])
    if got != want:
        diff = {op: (cost["by_op"].get(op), row) for op, row in real["by_op"].items()
                if cost["by_op"].get(op) != row}
        diff.update({op: (row, None) for op, row in cost["by_op"].items()
                     if op not in real["by_op"]})
        raise AssertionError(f"launch (b) {name} {shape}: the count on the card {got} differs "
                             f"from the fake one {want}; ops (fake, card): {diff}")
    walls, peaks = [], []
    long_run = configs.SHAPES[shape].kind == "prefill" and arch.family != "diffusion"
    for _ in range(1 if long_run else LAUNCH_TIMED):
        free_card()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out, wall = synced_wall(lambda: fn(*args))
        del out
        walls.append(wall)
        # bytes held before the step that it does not take as an argument
        peaks.append(torch.cuda.max_memory_allocated() - held + real["argument_bytes"])
    r = rec["roofline"]
    bound = max(r["compute_s"], r["memory_s"])
    wall, measured = min(walls), max(peaks)
    predicted = rec["memory"]["peak_bytes_per_device"]
    row = dict(arch=name, shape=shape, batch=batch, variant=variant, dtype=arch.param_dtype,
               flops=cost["flops_per_device"], flops_by_dtype=cost["flops_by_dtype"],
               bytes=cost["bytes_per_device"], kernels=cost["kernels"],
               compute_s=r["compute_s"], memory_s=r["memory_s"], dominant=r["dominant"],
               bound_s=bound, walls_s=walls, roofline_share=bound / wall,
               predicted_peak_gib=predicted / 2**30, measured_peak_gib=measured / 2**30,
               peak_error=(predicted - measured) / measured, analyze_s=rec["analyze_s"],
               formula_flops=formula_flops(arch, shape, batch))
    if row["formula_flops"]:
        row["formula_over_counted"] = row["formula_flops"] / cost["flops_per_device"]
    if variant == "int8":  # each product of the W8A8 denoiser against its plain version
        zero_counts()
        with int8_held_exactly(f"launch (b) {name} int8") as held_at:
            fn(*args)
        torch.cuda.synchronize()
        row["int8_launches"] = k_int8.launches
        row["int8_held"] = sum(held_at.values())
        if not row["int8_launches"] or row["int8_held"] != row["int8_launches"]:
            raise AssertionError(f"launch (b): int8_matmul launched {k_int8.launches} times, "
                                 f"held {row['int8_held']}")
    del fn, args
    free_card()
    say(f"launch (b) {name} {shape} B={batch} {variant or arch.param_dtype}: "
        f"{row['flops'] / 1e12:.3f} TFLOP (formula {row['formula_flops']}), "
        f"{row['bytes'] / 1e9:.2f} GB; bound {bound * 1e3:.2f} ms ({r['dominant']}), wall "
        f"{wall * 1e3:.2f} ms: roofline share {row['roofline_share']:.3f}; peak predicted "
        f"{row['predicted_peak_gib']:.2f} GiB, measured {row['measured_peak_gib']:.2f} GiB "
        f"({100 * row['peak_error']:+.1f} %)")
    if wall < bound:
        raise AssertionError(f"launch (b) {name} {shape}: wall {wall} s below the roofline "
                             f"bound {bound} s: the count is wrong")
    if abs(row["peak_error"]) > LAUNCH_PEAK_TOL:
        raise AssertionError(f"launch (b) {name} {shape}: predicted peak {predicted} B, "
                             f"measured {measured} B")
    return row


def phase_launch() -> dict:
    """The launch tooling: (a) the one-card dry run of every cell and the
    production meshes' layouts, on fake tensors; (b) the dry run held
    against the card on cells the earlier phases run."""
    free_card()
    t_phase = time.perf_counter()
    out: dict = {"card_total_memory": torch.cuda.get_device_properties(0).total_memory,
                 "hbm_bytes_constant": roofline.HBM_BYTES}
    say(f"launch: card memory {out['card_total_memory']} B (roofline.HBM_BYTES "
        f"{roofline.HBM_BYTES})")
    t = time.perf_counter()
    out["dry"] = launch_dry_all()
    walls = {"a": time.perf_counter() - t}
    t = time.perf_counter()
    out["checks"] = [launch_check(*c) for c in LAUNCH_CHECKS]
    walls["b"] = time.perf_counter() - t
    out["part_walls_s"] = walls
    out["phase_wall_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------- analysis
ANALYSIS_STEPS = 4  # Defo's two calibration steps, then a capture and replays
# (policy, plan fields over base) of (b): Defo's frozen modes under five
# plans, then all-act and all-diff modes under base
ANALYSIS_PAIRS = (("defo", {}), ("defo", dict(collect_stats=True)), ("defo", dict(low_bits=4)),
                  ("defo", dict(fused=True)), ("defo", dict(fused=True, low_bits=4)),
                  ("act", {}), ("diff", {}))
ANALYSIS_EQUAL = dict(steps=40, deadline_ms=250.0, watchdog=True)  # (c): base's sig


class CaptureRecorder:
    """While installed, every runner the cache builds records what its step
    dispatches while a CUDA graph captures it (``trace_audit.StepRecorder``,
    the recorder of the fake fingerprint), by runner key."""

    def __init__(self):
        self.records: dict = {}
        self.orig = serve_cache._Runner.__init__
        rec = self

        def init(runner, key, *args):
            rec.orig(runner, key, *args)
            step = runner.step

            def recorded(*a):
                if not torch.cuda.is_current_stream_capturing():
                    return step(*a)
                r = trace_audit.StepRecorder()
                with r:
                    out = step(*a)
                rec.records[key] = r
                return out

            runner.step = recorded

        serve_cache._Runner.__init__ = init

    def close(self):
        serve_cache._Runner.__init__ = self.orig


def first_divergence(a: list, b: list) -> str:
    """Where two event records first differ, and the ops whose counts
    differ, for the error message."""
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    ca, cb = (collections.Counter(e[1] for e in ev) for ev in (a, b))
    counts = {op: (ca[op], cb[op]) for op in ca.keys() | cb.keys() if ca[op] != cb[op]}
    return (f"{len(a)} vs {len(b)} events; first difference at {i}: "
            f"{a[i] if i < len(a) else None} vs {b[i] if i < len(b) else None}; "
            f"before it {a[max(i - 2, 0):i]}; counts that differ {counts}")


def phase_analysis(params, x_T, labels, sched) -> dict:
    """The port's lint and its runner-key audit on the card: (a) the lint
    over the shipped tree, its audit on fake CUDA tensors; (b) seven
    (modes, plan) pairs served through ``ServeSession`` at DiT-XL/2, each
    key's fake-CUDA fingerprint held equal to the one recorded around its
    capture, its recorded launches to the cache's, one capture a key, the
    sample to uncached ``serve_records`` bit for bit; (c) an equal-sig
    pair captures once, a distinct-sig pair twice."""
    from repro_torch.analysis import __main__ as lint

    free_card()
    t_phase = time.perf_counter()
    out: dict = {"walls_s": {}}
    t = time.perf_counter()
    findings = lint.run(ROOT)
    out["walls_s"]["a"] = time.perf_counter() - t
    out["fake_device"] = op_analysis.fake_device()
    say(f"analysis (a): the lint on the shipped tree, runner-key audit on fake "
        f"{out['fake_device']} tensors: {len(findings)} findings, "
        f"{out['walls_s']['a']:.1f} s")
    if findings or out["fake_device"] != "cuda":
        raise AssertionError("analysis (a): " + "; ".join(f.render() for f in findings))

    # (b)
    t = time.perf_counter()
    zero_counts()
    cache = CompiledRunnerCache()
    sess = ServeSession(params, CFG, sched, DittoPlan(steps=ANALYSIS_STEPS, collect_stats=False),
                        cache=cache)
    rec = CaptureRecorder()
    served = []
    try:
        for policy, kw in ANALYSIS_PAIRS:
            plan = DittoPlan(steps=ANALYSIS_STEPS, policy=policy, collect_stats=False).replace(**kw)
            res = sess.serve(x_T, labels, plan=plan)
            modes = res.chunks[0].engine.compiled_modes()
            key = cache.key_for(CFG, modes, plan, bucket=B)
            _, want, _ = harness.serve_records(params, CFG, sched, x_T, labels, plan, bucket=B,
                                               device=DEVICE)
            if not torch.equal(res.sample, want):
                d = (res.sample - want).abs().max().item()
                raise AssertionError(f"analysis (b) {policy} {kw}: the replayed sample differs "
                                     f"from uncached serve_records (max {d})")
            served.append((policy, kw, plan, modes, key))
    finally:
        rec.close()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    counts = launch_counts()
    t = time.perf_counter()
    pairs = []
    with op_analysis.fake_mode():
        state = trace_audit.abstract_state(CFG, B)
        for policy, kw, plan, modes, key in served:
            t1 = time.perf_counter()
            fake = trace_audit.trace_step(CFG, modes, plan, B, state)
            card = rec.records.get(key)
            if card is None:
                raise AssertionError(f"analysis (b) {policy} {kw}: no capture was recorded")
            if fake.fingerprint() != card.fingerprint():
                raise AssertionError(f"analysis (b) {policy} {kw}: the fake fingerprint differs "
                                     f"from the capture's: "
                                     f"{first_divergence(fake.events, card.events)}")
            if card.launch_counts() != cache.capture_launches[key]:
                raise AssertionError(f"analysis (b) {policy} {kw}: recorded launches "
                                     f"{card.launch_counts()}, the cache counted "
                                     f"{cache.capture_launches[key]}")
            row = dict(policy=policy, plan=kw, sig=list(key.plan_sig),
                       modes={m: sum(v == m for v in modes.values()) for m in set(modes.values())},
                       fingerprint=card.fingerprint(), events=len(card.events),
                       launches=card.launch_counts(), fake_s=time.perf_counter() - t1)
            pairs.append(row)
            say(f"analysis (b): {json.dumps(row)}")
    fake_s = time.perf_counter() - t
    keys = {key for *_, key in served}  # Defo may freeze all-act: then it shares act's key
    if set(cache.capture_counts) != keys or any(c != 1 for c in cache.capture_counts.values()):
        raise AssertionError(f"analysis (b): captures per key {cache.capture_counts}")
    captured = {k: sum(c.get(k, 0) for c in cache.capture_launches.values()) for k in counts}
    idle = [k for k, c in captured.items() if not c]
    if idle:
        raise AssertionError(f"analysis (b): {idle} never launched under a capture")
    out["b"] = dict(pairs=pairs, captures=len(cache.capture_counts), captured=captured,
                    launches=counts, serve_s=serve_s, fake_s=fake_s)
    out["walls_s"]["b"] = serve_s + fake_s
    del sess, cache
    free_card()

    # (c): all-diff modes, so Defo's decision (another step count draws
    # other timesteps) cannot make a second key for a reason outside the plan
    t = time.perf_counter()
    cache = CompiledRunnerCache()
    base = DittoPlan(steps=ANALYSIS_STEPS, policy="diff", collect_stats=False)
    sess = ServeSession(params, CFG, sched, base, cache=cache)
    captures = []
    for plan in (base, base.replace(**ANALYSIS_EQUAL), base.replace(low_bits=4)):
        sess.serve(x_T, labels, plan=plan)
        captures.append(cache.n_captures)
    if captures != [1, 1, 2]:
        raise AssertionError(f"analysis (c): captures after base, the equal-sig plan and "
                             f"low_bits=4: {captures}, want [1, 1, 2]")
    out["c"] = dict(captures=captures, equal=ANALYSIS_EQUAL)
    out["walls_s"]["c"] = time.perf_counter() - t
    del sess, cache
    free_card()
    out["phase_wall_s"] = time.perf_counter() - t_phase
    say(f"analysis: fake == capture fingerprints for {len(pairs)} keys, one capture a key, "
        f"captures (c) {captures}; walls {json.dumps(out['walls_s'])}, phase "
        f"{out['phase_wall_s']:.1f} s")
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
        t_ops, t_bytes = ops_n / roofline.PEAK_FLOPS_INT8 * 1e3, nbytes / roofline.HBM_BW * 1e3
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
    meshing = phase_mesh(params, sched)
    analysis = phase_analysis(params, x_T, labels, sched)
    del params, x_T, labels, diff_run  # the training phase needs the card's memory
    training = phase_train()
    lm = phase_lm()
    lm_training = phase_lm_train()
    moe_path = phase_moe()
    recurrent = phase_recurrent()
    distributed = phase_distributed()
    launching = phase_launch()
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
    say("mesh: " + json.dumps(meshing))
    say("training: " + json.dumps(training))
    say("lm: " + json.dumps(lm))
    say("lm_train: " + json.dumps(lm_training))
    say("moe: " + json.dumps(moe_path))
    say("recurrent: " + json.dumps(recurrent))
    say("distributed: " + json.dumps(distributed))
    say("launch: " + json.dumps(launching))
    say("analysis: " + json.dumps(analysis))
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
