"""Where a compiled denoising step, or an LM prefill and decode step, of the
PyTorch/CUDA port spends its time.

    python3 benchmarks/torch_step_profile.py [--policy act diff diff-fused defo] [--steps 8] [--short 4]
    python3 benchmarks/torch_step_profile.py --lm qwen3-0.6b [--batch 16] [--cache 32768]
        [--prompt 512] [--steps 8] [--prefill 32768]
    python3 benchmarks/torch_step_profile.py --lm qwen3-0.6b --train-seq 4096 [--batch 4]
        [--layers N] [--steps 3]

Serves DiT-XL/2 at B = 2 (random weights from a seed, adaLN ``mod`` weights
refilled N(0, 0.02), as chip_smoke.py does) through
``repro_torch.sim.harness.serve_records`` at ``--steps`` and at ``--short``
DDIM steps. Both calls run the same two eager calibration steps and the
same fixed costs of a call, and every further step is a compiled one, so
the difference between the two calls over ``--steps - --short`` is the cost
of one compiled step. Per run — ``act``, ``diff`` (the two-pass flow),
``diff-low_bits4`` (its packed-int4 branch) or ``diff-fused`` (the fused
flow) — with the default ``collect_stats=True`` plan and with
``collect_stats=False``, it prints:

- ``step_ms``: that difference of the two calls' wall times (host clock,
  each call ends in ``torch.cuda.synchronize()``; median of ``--reps``
  unprofiled calls each, after one warm-up call);
- from ``torch.profiler`` around one more call of each length, the same
  difference of: the device's busy time (its kernels', copies' and fills'
  device time), the device activities, the device time and launches of the
  port's kernels and of the top device items, and the top host ops;
  and the device's idle share against ``step_ms``.

Each run is profiled on two paths: ``uncached``, a
``serve_records`` call that runs the compiled step op by op, and
``session``, the same request through a ``repro_torch.serve.ServeSession``
whose runner cache replays one captured CUDA graph a step (its graph is
captured by the warm-up call, so the timed calls only replay; both lengths
share it, since the step count is not part of the runner key).

Defo (``defo``: the two-pass flow under the Defo policy, whose act layers
launch ``int8_matmul`` and diff layers the difference GEMMs) cannot be
differenced: its modes depend on the timesteps of the calibration steps,
which differ between the two lengths. It is read from one profiled
``--steps`` call instead: the device activities from the first launch of
a port kernel (the first compiled step's) to the end of the call, over
the call's compiled steps (``window``). That leaves out the device work
of the first compiled step before its first kernel and leaves in the
call's few ops after the last step; its ``step_ms`` is not measured.
In this mode ``device_busy_ms`` is the sum of the activities' device
times, which counts twice what ran at once.

``--lm ARCH`` profiles a token-only LM config instead, at full width and
depth (random weights from a seed, the config's dtypes), through
``launch.steps.make_prefill_step`` / ``make_decode_step`` and
``chip_smoke.py``'s LM helpers, as that script's ``lm`` phase runs it:

- ``decode``: a ``--prompt``-token prefill at ``--batch``, its cache
  zero-padded to ``--cache`` slots, then greedy steps. The wall of a step
  is the median of ``--steps`` unprofiled steps (host clock, each between
  two ``torch.cuda.synchronize()``); ``torch.profiler`` around ``--steps``
  more gives, per step, the traced wall, the device's busy time (the union
  of its kernels', copies' and fills' intervals, so what overlaps counts
  once) and its idle share of the traced wall, the sum of their device
  times, the activities, the top device items and the top host ops.
- ``prefill``: one ``--prefill``-token prompt at B = 1, the same figures
  over one profiled call after an unprofiled one (``--prefill 0`` skips it).

With ``--train-seq S`` the ``--lm`` mode profiles train steps instead
(``launch.steps.init_state`` / ``make_train_step``, the config's dtypes,
remat and grad_accum, at ``--batch`` rows of S tokens from ``lm_batch``,
depth cut to ``--layers`` when given: layers, or super-blocks for
xlstm-125m and zamba2-7b): the median wall of ``--steps``
steps after a warm one, then the same figures over ``--steps`` profiled
steps.

Each mode prints its rows as JSON lines and the card's name and power
limit. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

from repro_torch import configs  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.core.ditto import DittoPlan  # noqa: E402
from repro_torch.data.synthetic import DataCfg, lm_batch  # noqa: E402
from repro_torch.launch import steps as lm_steps  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.serve import ServeSession  # noqa: E402
from repro_torch.sim import harness  # noqa: E402

# the port's kernels, by a part of their __global__ function's name in csrc/:
# the three GEMMs are diff_gemm_kernel<P> with producer P (the packed-int4
# branch runs inside diff_gemm_kernel<DiffProducer>)
PORT_KERNELS = {"int8_matmul": "ActProducer", "diff_encode": "diff_encode_kernel",
                "ditto_diff_matmul": "DiffProducer",
                "diff_encode_fused": "diff_encode_fused_kernel",
                "ditto_fused_matmul": "FusedProducer"}
# run name -> (policy, kernel knobs of the plan)
RUNS = {"act": ("act", {}), "diff": ("diff", {}), "diff-low_bits4": ("diff", dict(low_bits=4)),
        "diff-fused": ("diff", dict(fused=True)), "defo": ("defo", {})}


def call(inputs, plan: DittoPlan, session: ServeSession | None) -> list:
    """One serve_records call (``session`` None) or one ServeSession.serve of
    the same request; returns its records."""
    if session is None:
        return harness.serve_records(*inputs, plan, device="cuda")[0]
    return session.serve(*inputs[3:], plan=plan).records


def serve(inputs, plan: DittoPlan, session: ServeSession | None = None) -> float:
    """Wall seconds of one call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(inputs, plan, session)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled(inputs, plan: DittoPlan, window: bool = False,
             session: ServeSession | None = None) -> tuple[dict, dict, int]:
    """Per name, (device ms, count) of every device activity and the host
    ops' self time in ms, over one call, and its compiled steps (the steps
    without an eager record: a compiled step records nothing without
    statistics). ``window``: only the device activities from the first
    launch of a port kernel on."""
    records, events, host, _ = trace(lambda: call(inputs, plan, session))
    if window:
        t0 = min(e.time_range.start for e in events
                 if any(fn in e.name for fn in PORT_KERNELS.values()))
        events = [e for e in events if e.time_range.start >= t0]
    eager = {r["step"] for r in records if not r.get("compiled")}
    return by_name(events), host, plan.steps - len(eager)


def trace(fn) -> tuple:
    """``fn()`` under ``torch.profiler``: its result, its device events, the
    host ops' self time in ms by name and the traced call's wall in ms."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    host = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CPU}
    return out, [e for e in prof.events() if e.device_type == DeviceType.CUDA], host, wall_ms


def by_name(events) -> dict:
    """Per name, (device ms, count) of the device events."""
    device: dict = {}
    for e in events:
        ms, n = device.get(e.name, (0.0, 0))
        device[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return device


def union_ms(events) -> float:
    """The device's busy ms: the union of the events' intervals, so that
    activities which ran at once count once."""
    total, end = 0.0, -math.inf
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in events):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total / 1e3


def summary(per_step: dict, host: dict) -> dict:
    """The device figures of one compiled step from its per-name (device
    ms, count), and its top host ops."""
    kernels = {}
    for port, fn in PORT_KERNELS.items():
        hits = [v for name, v in per_step.items() if fn in name]
        kernels[port] = (sum(ms for ms, _ in hits), sum(n for _, n in hits))
    return {
        "device_busy_ms": sum(ms for ms, _ in per_step.values()),
        "device_activities_per_step": sum(n for _, n in per_step.values()),
        "port_kernels_ms_launches_per_step": kernels,
        "top_device_ms_launches_per_step": sorted(
            ((name[:70], ms, n) for name, (ms, n) in per_step.items()),
            key=lambda t: t[1], reverse=True)[:10],
        "top_host_ms_per_step": sorted(host.items(), key=lambda kv: kv[1], reverse=True)[:12],
    }


def session_for(inputs, path: str) -> ServeSession | None:
    """A fresh session (its own runner cache) for the session path."""
    return None if path == "uncached" else ServeSession(*inputs[:3], device="cuda")


def window_profile(inputs, run: str, collect_stats: bool, steps: int, path: str) -> dict:
    """One compiled step of a ``--steps`` call, averaged over the call's
    compiled steps from the first port kernel on (no host ops: the host's
    steps are not separated)."""
    policy, knobs = RUNS[run]
    plan = DittoPlan(steps=steps, policy=policy, collect_stats=collect_stats, **knobs)
    session = session_for(inputs, path)
    serve(inputs, plan, session)  # warm-up (and the session's captures)
    device, _, n = profiled(inputs, plan, window=True, session=session)
    per_step = {name: (ms / n, c / n) for name, (ms, c) in device.items()}
    return {"run": run, "path": path, "collect_stats": collect_stats, "steps": [steps],
            "window": True, "compiled_steps": n, "step_ms": None,
            **summary(per_step, {})}


def step_profile(inputs, run: str, collect_stats: bool, steps: int, short: int,
                 reps: int, path: str) -> dict:
    policy, knobs = RUNS[run]
    long_plan = DittoPlan(steps=steps, policy=policy, collect_stats=collect_stats, **knobs)
    short_plan = DittoPlan(steps=short, policy=policy, collect_stats=collect_stats, **knobs)
    session = session_for(inputs, path)
    serve(inputs, short_plan, session)  # warm-up (and the session's captures)
    walls = {steps: [], short: []}
    for _ in range(reps):
        for plan in (long_plan, short_plan):
            walls[plan.steps].append(serve(inputs, plan, session))
    d = steps - short
    step_ms = (statistics.median(walls[steps]) - statistics.median(walls[short])) / d * 1e3
    (dev_l, host_l, _), (dev_s, host_s, _) = (profiled(inputs, long_plan, session=session),
                                              profiled(inputs, short_plan, session=session))
    per_step = {}
    for name in dev_l.keys() | dev_s.keys():
        (ms_l, n_l), (ms_s, n_s) = dev_l.get(name, (0.0, 0)), dev_s.get(name, (0.0, 0))
        per_step[name] = ((ms_l - ms_s) / d, (n_l - n_s) / d)
    host = {k: (host_l.get(k, 0.0) - host_s.get(k, 0.0)) / d
            for k in host_l.keys() | host_s.keys()}
    out = summary(per_step, host)
    return {"run": run, "path": path, "collect_stats": collect_stats, "steps": [steps, short],
            "step_ms": step_ms, "device_idle_share": 1.0 - out["device_busy_ms"] / step_ms,
            **out}


def lm_figures(fn, n: int) -> dict:
    """Per call of ``n`` traced calls of ``fn``: the traced wall, the
    device's busy ms (the union) and its idle share of that wall, its
    activities' summed ms, the activities, the top device items (ms, count)
    and the top host ops (self ms)."""
    _, events, host, wall_ms = trace(lambda: [fn() for _ in range(n)])
    busy = union_ms(events) / n
    return {
        "traced_wall_ms": wall_ms / n, "device_busy_ms": busy, "device_activity_ms_sum": sum(
            e.time_range.elapsed_us() for e in events) / 1e3 / n,
        "device_idle_share": 1 - busy * n / wall_ms, "device_activities": len(events) / n,
        "top_device_ms_count": sorted(((name[:80], ms / n, k / n) for name, (ms, k)
                                       in by_name(events).items()), key=lambda t: t[1],
                                      reverse=True)[:10],
        "top_host_ms": sorted(((k, v / n) for k, v in host.items()), key=lambda kv: kv[1],
                              reverse=True)[:10],
    }


def lm_profile(name: str, batch: int, cache_len: int, prompt: int, steps: int,
               prefill_len: int) -> dict:
    """The ``--lm`` mode's row: a decode step and a prefill of ``name``."""
    import chip_smoke as smoke  # its LM helpers: inputs, the padded cache, greedy steps

    arch = configs.get(name)
    if arch.frontend is not None:
        raise SystemExit(f"{name}: a token-only arch, please (chip_smoke.py's lm phase covers "
                         f"the frontends)")
    model = LM(arch)
    g = torch.Generator(device="cuda").manual_seed(23)
    params = model.init(g, device="cuda")
    prefill, decode = lm_steps.make_prefill_step(arch), lm_steps.make_decode_step(arch)
    out: dict = dict(arch=arch.name, batch=batch, cache=cache_len, prompt=prompt)
    logits, pc = prefill(params, smoke.lm_inputs(arch, g, batch, prompt))
    state = {"pos": prompt, "logits": logits, "cache": smoke.padded_cache(model, pc, cache_len)}
    del pc

    def step():
        tok, _ = smoke.greedy(state["logits"], arch)
        state["logits"], state["cache"] = decode(params, state["cache"],
                                                 {"tokens": tok, "pos": state["pos"]})
        state["pos"] += 1

    step()  # warm
    walls = [smoke.synced_wall(step)[1] * 1e3 for _ in range(steps)]
    wall_ms = statistics.median(walls)
    out["decode"] = dict(step_ms_median=wall_ms, step_walls_ms=walls,
                         tokens_per_s=batch / (wall_ms / 1e3),
                         **lm_figures(step, steps))
    del state, logits
    torch.cuda.empty_cache()
    if prefill_len:
        tokens = smoke.lm_inputs(arch, g, 1, prefill_len)
        _, wall = smoke.synced_wall(lambda: prefill(params, tokens))
        out["prefill"] = dict(seq=prefill_len, wall_s=wall, tokens_per_s=prefill_len / wall,
                              **lm_figures(lambda: prefill(params, tokens), 1))
    return out


def lm_train_profile(name: str, batch: int, seq: int, layers: int, steps: int) -> dict:
    """The ``--train-seq`` mode's row: train steps of ``name``."""
    import dataclasses

    import chip_smoke as smoke  # synced_wall

    arch = configs.get(name)
    if layers:  # the recurrent families stack super-blocks
        arch = dataclasses.replace(arch, **{"n_super" if arch.n_super else "n_layers": layers})
    opt = lm_steps.make_optimizer(arch, total=2 * steps + 1)
    state = {"s": lm_steps.init_state(arch, 0, opt, device="cuda")}
    train = lm_steps.make_train_step(arch, opt)
    data = lm_batch(arch, DataCfg(seed=0, batch=batch, seq_len=seq), 0, device="cuda")

    def step():
        state["s"], _ = train(state["s"], data)

    step()  # warm
    walls = [smoke.synced_wall(step)[1] * 1e3 for _ in range(steps)]
    wall_ms = statistics.median(walls)
    return dict(arch=arch.name, layers=arch.n_layers, batch=batch, seq=seq,
                grad_accum=train.effective_accum(batch), step_ms_median=wall_ms,
                step_walls_ms=walls, tokens_per_s=batch * seq / (wall_ms / 1e3),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, **lm_figures(step, steps))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--policy", nargs="+", default=["act", "diff", "diff-fused"],
                    choices=tuple(RUNS))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--short", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--lm", metavar="ARCH", help="profile this LM config instead of the DiT")
    ap.add_argument("--batch", type=int, default=16, help="--lm: the decode batch")
    ap.add_argument("--cache", type=int, default=32768, help="--lm: the decode cache's slots")
    ap.add_argument("--prompt", type=int, default=512, help="--lm: the decode prompt")
    ap.add_argument("--prefill", type=int, default=32768, help="--lm: the prefill's tokens")
    ap.add_argument("--train-seq", type=int, default=0, help="--lm: profile train steps instead")
    ap.add_argument("--layers", type=int, default=0,
                    help="--train-seq: cut the depth to this (super-blocks for ssm / hybrid)")
    args = ap.parse_args()
    if not args.lm and not 2 <= args.short < args.steps:
        ap.error("need 2 <= --short < --steps: steps 0-1 run eager")
    if not torch.cuda.is_available():
        print("torch_step_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}; {smi.stdout.strip()}")
    if args.lm and args.train_seq:
        row = lm_train_profile(args.lm, args.batch, args.train_seq, args.layers, args.steps)
        print("lm_train_profile: " + json.dumps(row), flush=True)
        return 0
    if args.lm:
        row = lm_profile(args.lm, args.batch, args.cache, args.prompt, args.steps, args.prefill)
        print("lm_profile: " + json.dumps(row), flush=True)
        return 0
    g = torch.Generator(device="cuda").manual_seed(0)
    params = dit.init(g, dit.DIT_XL2)
    params["blocks"]["mod"]["w"].normal_(0.0, 0.02, generator=g)
    x_T = torch.randn((2, 32, 32, 4), generator=g, device="cuda")
    labels = torch.tensor([207, 360], device="cuda")
    inputs = (params, dit.DIT_XL2, diffusion.linear_schedule(1000), x_T, labels)
    for run in args.policy:
        for collect_stats in (True, False):
            for path in ("uncached", "session"):
                if run == "defo":  # its modes differ between two lengths: one call's window
                    row = window_profile(inputs, run, collect_stats, args.steps, path)
                else:
                    row = step_profile(inputs, run, collect_stats, args.steps, args.short,
                                       args.reps, path)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
