"""End-to-end serving entry point of the PyTorch/CUDA port: a queue of
image-generation requests through one ``repro_torch.serve.ServeSession``.

The port's counterpart of ``examples/serve_diffusion.py``. The session is
configured by ONE ``DittoPlan`` (the flags fill its fields) and serves
DiT-XL/2 with random weights from ``--seed`` (the adaLN ``mod`` weights
drawn N(0, 0.02) so the blocks reach the sample; training is not ported
yet). Each batch runs the quantized DDIM loop with Defo: steps 1-2 on the
eager calibration engine, then the frozen per-layer modes through the
hand-written Hopper kernels (act layers -> ``int8_matmul``, diff layers ->
``diff_encode`` + ``ditto_diff_matmul``). The session pads ragged batches
to power-of-two buckets and keeps one runner per (modes,
``plan.cache_sig()``, bucket): on the card one captured CUDA graph,
replayed every later step of every later batch of that key. Per request it
reports the wall time, the simulated Ditto and ITC times and the cache's
counters; the request log is checkpointed atomically and resumed.

    python examples/serve_diffusion_torch.py [--requests 6] [--batch 4] [--steps 20]
    python examples/serve_diffusion_torch.py --low-bits 4    # packed-int4 low tiles
    python examples/serve_diffusion_torch.py --fused         # the fused diff flow
    python examples/serve_diffusion_torch.py --int4-from 8   # int8 early, int4 + fused late
    python examples/serve_diffusion_torch.py --deadline-ms 2000 --warmup  # async scheduler
    python examples/serve_diffusion_torch.py --chaos 7       # seeded faults, ladder + watchdog
    python examples/serve_diffusion_torch.py --device cpu --small --steps 4   # no card

It runs on the card unless ``--device cpu`` is given; ``--small`` swaps
DiT-XL/2 for a 2-block, 64-wide DiT that the CPU serves in seconds.

With ``--deadline-ms``, ``--warmup`` or ``--chaos`` the queue goes through
the async ``ServeScheduler`` instead: each request is submitted alone (one
row) with its latency budget, a dispatch thread coalesces them into bucket
batches (a full bucket at once, a partial one when a budget nears), and
``--warmup`` captures the bucket ladder's graphs first (1, 2 and 4 at the
default ``--batch 4``; keep ``--batch`` <= 16 at DiT-XL/2, where a bucket's
state arena takes 0.58 GB a sample, per ``chip_smoke.py`` on an NVIDIA H100
80GB HBM3 at 700 W). ``--chaos SEED`` serves under a seeded
fault schedule over ``session.serve`` and ``denoise.step`` with the recovery
stack armed: a retry ladder (fused -> two-pass -> ``low_bits=8``) whose
budget of 3 retries outlasts the 3 one-shot faults, and the re-anchor
watchdog. Each request's sample equals the same request served alone, bit
for bit.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core import diffusion  # noqa: E402
from repro_torch.kernels.common import resolve_device  # noqa: E402
from repro_torch.nn import dit  # noqa: E402
from repro_torch.serve import (DispatchFailed, DittoPlan, InjectedFault,  # noqa: E402
                               NumericalFault, PlanSchedule, SchedulerDied, ServeScheduler,
                               ServeSession, chaos_schedule, inject)
from repro_torch.sim import harness  # noqa: E402

SMALL = dit.DiTCfg(d_model=64, n_layers=2, n_heads=2, patch=2, in_channels=4, input_size=8,
                   n_classes=8)


def build_model(cfg: dit.DiTCfg, seed: int, device: torch.device) -> dict:
    """Random DiT params from ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    params = dit.init(g, cfg, device=device)
    # adaLN-Zero zeroes every block's gates; give the blocks a say
    params["blocks"]["mod"]["w"].normal_(0.0, 0.02, generator=g)
    return params


def make_plan(args) -> DittoPlan | PlanSchedule:
    # bucket ladders are powers of two: round a ragged --batch up
    max_batch = 1 << (max(args.batch, 1) - 1).bit_length()
    plan = DittoPlan(steps=args.steps, compiled=not args.eager, low_bits=args.low_bits,
                     fused=args.fused, max_batch=max_batch)
    if args.chaos is not None:
        # the dispatch ladder (fused -> two-pass -> int8) and the numerical
        # watchdog with the saturation re-anchor; no recovery field is part
        # of the runner key. A schedule below carries them on its base.
        plan = plan.replace(max_retries=3, retry_backoff_ms=25.0,
                            fallbacks=(dict(fused=False), dict(fused=False, low_bits=8)),
                            watchdog=True, reanchor_full_frac=0.97)
    if args.int4_from is not None:
        plan = PlanSchedule(plan, [(0, args.int4_from, {}),
                                   (args.int4_from, args.steps, dict(low_bits=4, fused=True))])
    return plan


def save(log: str, done: dict) -> None:
    """Write the request log atomically: a crash mid-write keeps the old one."""
    tmp = log + ".tmp"
    with open(tmp, "w") as f:
        json.dump(done, f)
    os.replace(tmp, log)


def serve_async(args, cfg, params, device, plan, done: dict, queue: list) -> dict:
    """The async path: one submission per request, a background dispatch
    thread coalescing them into buckets under their deadlines."""
    injector = None
    if args.chaos is not None:
        # 3 one-shot faults: session.serve's for the ladder, denoise.step's
        # for the watchdog
        injector = chaos_schedule(args.chaos, n_faults=3,
                                  sites=("session.serve", "denoise.step"), max_at=6)
        print(f"[serve] chaos seed {args.chaos}: "
              + ", ".join(f"{f.kind}@{f.site}[{f.at}]" for f in injector.faults))
    s = ServeScheduler(params, cfg, diffusion.cosine_schedule(1000), plan, device=device,
                       async_mode=True, dispatch_interval_ms=25.0)
    if args.warmup:
        w = s.warmup()
        print(f"[serve] warmup: {w['captures']} graph(s) captured in {w['wall_s']:.2f}s")
    t0 = time.monotonic()
    tickets = []
    with inject(injector) if injector is not None else contextlib.nullcontext():
        with s:
            for rid, cls in queue:
                g = torch.Generator(device=device).manual_seed(1000 + rid)
                x = torch.randn((1, cfg.input_size, cfg.input_size, cfg.in_channels),
                                generator=g, device=device)
                labels = torch.tensor([cls], device=device)
                tickets.append((rid, cls, s.submit(x, labels, deadline_ms=args.deadline_ms)))
            for rid, cls, t in tickets:
                try:
                    sample = t.result(timeout=600.0)
                except (InjectedFault, DispatchFailed, NumericalFault, SchedulerDied) as err:
                    done[rid] = {"class": cls, "error": repr(err)}
                    print(f"[serve] request {rid}: failed ({err!r})")
                    continue
                if not torch.isfinite(sample).all():
                    raise RuntimeError(f"request {rid}: non-finite sample")
                lat = t.done_t - t.submit_t
                rung = t.served_with
                done[rid] = {"class": cls, "wall_s": lat,
                             "served_with": dict(low_bits=rung.low_bits, fused=rung.fused,
                                                 compiled=rung.compiled)}
                print(f"[serve] request {rid}: latency {lat * 1e3:.0f} ms")
    save(args.log, done)
    st = s.stats()
    print(f"[serve] served {len(tickets)} request(s) in {time.monotonic() - t0:.2f}s: "
          f"{st['dispatches']} dispatch(es) {st['triggers']}, {st['pad_rows']} pad row(s) "
          f"({s.naive_pad_rows()} one by one), {st['deadline_misses']} deadline miss(es), "
          f"{st['failed']} failed")
    print(f"[serve] runner cache: {st['runners']} runner(s), {st['captures']} capture(s), "
          f"{st['replays']} replay(s)"
          + (f", {st['captures_after_warmup']} after warmup" if args.warmup else ""))
    if injector is not None:
        print(f"[serve] chaos: {len(injector.fired)}/{len(injector.faults)} fault(s) fired, "
              f"{st['retries']} retry(ies), {st['fallback_dispatches']} fallback "
              f"dispatch(es), {st['watchdog_events']} watchdog re-anchor(s)")
    return st


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--log", default=os.path.join(ROOT, "experiments",
                                                  "serve_diffusion_torch_log.json"))
    ap.add_argument("--eager", action="store_true",
                    help="run every step on the eager engine (no kernels, no runner cache)")
    ap.add_argument("--low-bits", type=int, default=8, choices=(4, 8),
                    help="4 = class-1 diff tiles through the packed-int4 kernel branch "
                         "(bit-identical samples, separate runner key)")
    ap.add_argument("--fused", action="store_true",
                    help="diff layers through the fused encode + Δ-cache GEMM "
                         "(bit-identical samples, separate runner key)")
    ap.add_argument("--int4-from", type=int, default=None, metavar="STEP",
                    help="serve a PlanSchedule: steps [0, STEP) on the base plan, "
                         "[STEP, --steps) with low_bits=4 and fused (one more runner)")
    ap.add_argument("--deadline-ms", type=float, default=None, metavar="MS",
                    help="serve through the async ServeScheduler, each request with this "
                         "latency budget: a partial bucket dispatches when a budget nears")
    ap.add_argument("--warmup", action="store_true",
                    help="capture the bucket ladder's graphs before serving (implies the "
                         "async scheduler)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="serve under a seeded fault schedule over session.serve and "
                         "denoise.step (implies the async scheduler) with the retry ladder "
                         "and the re-anchor watchdog armed")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run without")
    ap.add_argument("--small", action="store_true",
                    help="a 2-block, 64-wide DiT instead of DiT-XL/2 (for the CPU)")
    args = ap.parse_args(argv)
    if args.int4_from is not None and not 0 < args.int4_from < args.steps:
        ap.error(f"--int4-from must be inside (0, {args.steps})")

    device = resolve_device(args.device)
    cfg = SMALL if args.small else dit.DIT_XL2
    params = build_model(cfg, args.seed, device)

    done: dict = {}
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    if os.path.exists(args.log):
        with open(args.log) as f:
            done = {int(k): v for k, v in json.load(f).items()}
        print(f"[serve] resuming: {len(done)} requests already served")
    queue = [(i, i % cfg.n_classes) for i in range(args.requests) if i not in done]
    if args.deadline_ms is not None or args.warmup or args.chaos is not None:
        return serve_async(args, cfg, params, device, make_plan(args), done, queue)

    sess = ServeSession(params, cfg, diffusion.cosine_schedule(1000), make_plan(args),
                        device=device)
    while queue:
        batch, queue = queue[:args.batch], queue[args.batch:]
        rids = [r for r, _ in batch]
        labels = torch.tensor([c for _, c in batch], device=device)
        g = torch.Generator(device=device).manual_seed(1000 + rids[0])
        x = torch.randn((len(rids), cfg.input_size, cfg.input_size, cfg.in_channels),
                        generator=g, device=device)
        result = sess.serve(x, labels)
        if not torch.isfinite(result.sample).all():
            raise RuntimeError(f"batch {rids}: non-finite sample")
        chunk = result.chunks[0]
        res = harness.run_designs(result.records, t_mult=64, d_mult=18,
                                  designs=("itc", "ditto", "ditto+"))
        summ = chunk.engine.summary()
        dispatch_b = chunk.bucket or chunk.batch  # records are at bucket scale
        for rid, cls in batch:
            done[rid] = {
                "class": cls,
                "wall_s": result.wall_s / len(rids),
                "bucket": chunk.bucket,
                "cached_runner": result.captures_delta == 0,
                "watchdog_events": len(chunk.engine.watchdog_events),
                "sim_ditto_ms": res["ditto"]["time_s"] * 1e3 / dispatch_b,
                "sim_itc_ms": res["itc"]["time_s"] * 1e3 / dispatch_b,
                "bops_ratio": summ["bops"] / summ["bops_act"],
            }
        save(args.log, done)
        note = ("eager (no runner)" if chunk.bucket is None else
                "cached runner" if result.captures_delta == 0 else
                f"{result.captures_delta} new capture(s)")
        print(f"[serve] batch {rids} (bucket {chunk.bucket}, {note}): wall "
              f"{result.wall_s:.2f}s, sim ditto {res['ditto']['time_s'] * 1e3:.2f}ms vs "
              f"itc {res['itc']['time_s'] * 1e3:.2f}ms")
    st = sess.stats()
    print(f"[serve] served {st['requests']} request(s) in {st['batches']} batch(es); "
          f"runner cache: {st['runners']} runner(s), {st['captures']} capture(s), "
          f"{st['hits']} hit(s), {st['replays']} replay(s); "
          f"{st['watchdog_events']} watchdog re-anchor(s)")
    return st


if __name__ == "__main__":
    main()
