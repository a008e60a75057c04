"""One run of one cell of ``BENCHMARK.json``: set up the program under test,
drive the cell's traffic through it for the measured window, check what it
served against the plain reference, and print the metrics.

Everything that belongs to one configuration, model family, traffic mix or
metric is found by name: ``configs/<config>.json`` (through BENCHMARK.json's
``file``), ``families/<family>.py`` (the configuration's ``family``),
``traffic/<traffic>.json`` and ``metrics/<metric>.py``. A traffic file
names its ``kind``, one of :data:`TRAFFIC_KINDS`; a metric file defines
``read(run) -> float | None`` over a :class:`Run`.

A family module is everything that knows the model, behind the names of
:data:`FAMILY_INTERFACE` (``families/dit.py``'s docstring gives each
signature): it builds the program's scheduler, draws the weights and each
request's noise and conditioning ``cond`` (a dict of tensors, a request's
images on dim 0) from the seed, submits a request, samples the plain
reference, and counts the model's operations and ``int8_matmul`` launches.
The harness passes ``cond`` through without reading it.

The program under test is ``repro_torch``'s serving stack: an async
``ServeScheduler`` over one ``ServeSession`` and its runner cache, built
from the configuration's plan. The benchmark hands it the weights and
requests it made from the seed, and takes back the served latents, the
scheduler's and the runner cache's counters and, in the traced run, the
profiler's kernel names.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import threading
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names no run may load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: The program's kernels, by a part of the profiler's name of their
#: ``__global__`` function (``csrc/diff_gemm_sm90.cuh``: one GEMM template,
#: one producer each).
KERNELS = {"int8_matmul": "ActProducer", "ditto_diff_matmul": "DiffProducer"}

#: What a family module defines.
FAMILY_INTERFACE = ("build_scheduler", "make_weights", "make_request", "submit",
                    "reference_sample", "model_macs", "int8_matmul_launches")

#: How long a client waits for an answer past the window's close.
GRACE_S = 60.0

#: First request index of a Poisson mix's warm-up arrivals (their inputs are
#: drawn apart from the window's).
WARM_INDEX = 1 << 40


# --------------------------------------------------------------- the cell
@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    end_to_end: list[dict]
    per_layer: list[dict]
    family: object  # the configuration's family module


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg["file"]).read_text())
    if "family" not in config:
        raise SystemExit(f"{cfg['file']} names no family; add \"family\": \"<name>\" for "
                         f"perfbench/families/<name>.py")
    return Cell(name=workload, chips=w["chips"], config=config,
                traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
                family=load_family(config["family"]))


def load_family(name: str, root: Path = HERE):
    """``<root>/families/<name>.py`` as a module, with the whole of
    :data:`FAMILY_INTERFACE`."""
    path = root / "families" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"unknown model family {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_family_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [f for f in FAMILY_INTERFACE if not callable(getattr(mod, f, None))]
    if missing:
        raise SystemExit(f"model family {path} lacks {missing}")
    return mod


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------ the program
class Program:
    """The system under test: the cell's family's async ``ServeScheduler``
    of the configuration's model and plan over ``weights``, warmed up."""

    def __init__(self, cell: Cell, weights: dict, device):
        self.family = cell.family
        self.sched = cell.family.build_scheduler(cell.config, weights, device)
        self.plan = self.sched.session.plan
        mb = self.plan.max_batch
        buckets = [mb] if cell.traffic["warmup"] == "max_batch" else [
            1 << i for i in range(mb.bit_length())]
        self.warm = self.sched.warmup(buckets=buckets)

    @property
    def cache(self):
        return self.sched.session.cache

    def submit(self, x, cond: dict, **kw):
        return self.family.submit(self.sched, x, cond, **kw)

    def snapshot(self) -> dict:
        """The scheduler's counters and the cache's replays a runner key."""
        return {"stats": self.sched.stats(), "replays": dict(self.cache.replays)}

    def close(self) -> None:
        self.sched.close(drain=False, join_timeout_s=GRACE_S)


# ---------------------------------------------------------------- the run
@dataclasses.dataclass
class Request:
    index: int
    images: int
    x: object  # noise (images, ...)
    cond: dict  # the family's conditioning tensors, each (images, ...)
    due: float | None = None  # monotonic seconds the request was due
    in_hand: float | None = None  # its rows returned by Ticket.result()
    done_t: float | None = None  # the scheduler's completion time
    sample: object = None
    error: str | None = None
    ticket: object = None


@dataclasses.dataclass
class Run:
    """What a run measured; every metric reader takes one."""
    cell: Cell
    setup_s: float
    t_open: float
    t_close: float
    measured: list[Request]  # the window's requests
    open_snap: dict
    close_snap: dict
    keys: dict  # RunnerKey -> (modes dict, bucket, capture launches)
    trace: object = None  # tracing.TraceData in a traced run

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def images(self) -> int:
        return sum(r.images for r in self.measured if r.sample is not None)

    @property
    def model(self) -> dict:
        return self.cell.config["model"]


def drive_backlog(prog: Program, cell: Cell, seed: int, seconds: float, device, tracer,
                  t_start: float):
    """A closed loop that keeps at least ``queued_batches`` x max_batch rows
    queued, so every dispatch is a full bucket. The window opens at a
    completion and closes at the first completion ``seconds`` later."""
    tr, model = cell.traffic, cell.config["model"]
    per = tr["images_per_request"]
    keep = tr["queued_batches"] * prog.plan.max_batch
    outstanding: collections.deque[Request] = collections.deque()
    measured: list[Request] = []
    index = 0
    t_open = open_snap = None
    if tracer is not None:
        tracer.start()
    while True:
        queued = prog.sched.stats()["queued_rows"]
        while queued < keep:
            x, cond = cell.family.make_request(model, seed, index, per, device)
            r = Request(index, per, x, cond)
            r.ticket = prog.submit(x, cond)
            outstanding.append(r)
            index += 1
            queued += per
        head = outstanding[0]
        try:
            head.ticket.result(timeout=GRACE_S + seconds)
        except TimeoutError:
            raise RuntimeError(f"no request completed in {GRACE_S + seconds:.0f} s") from None
        except Exception:  # noqa: BLE001 - a failed request is counted below
            pass
        # the scheduler's lock: a dispatch delivers all its tickets under it,
        # so every ticket of the dispatch that completed is done past here
        prog.sched.stats()
        done = []
        while outstanding and outstanding[0].ticket.done:
            r = outstanding.popleft()
            r.in_hand = time.monotonic()
            r.done_t = r.ticket.done_t
            try:
                r.sample = r.ticket.result()
            except Exception as exc:  # noqa: BLE001 - a failed request counts as failed
                r.error = repr(exc)
            done.append(r)
        t = max(r.done_t for r in done)
        if t_open is None:
            t_open, open_snap = t, prog.snapshot()
            continue
        measured.extend(done)
        if t - t_open >= seconds:
            close_snap = prog.snapshot()
            trace = tracer.stop() if tracer is not None else None
            return t_open - t_start, t_open, t, measured, open_snap, close_snap, trace


def poisson_schedule(traffic: dict, seed: int, seconds: float) -> tuple[list, int]:
    """(due offset s, images) of every request, and how many of them are the
    window's (the first ones). The window holds ``rate_per_s`` x ``seconds``
    arrivals at uniform times, a Poisson process given its count, so it
    offers the rate exactly; the ``tail_s`` after it continues with
    exponential gaps. Times and uniform sizes are drawn once from the mix's
    own ``schedule_seed``; ``seed`` only reorders the gaps and sizes inside
    the window and inside the tail, so every seed offers the same work."""
    rng = np.random.default_rng(traffic["schedule_seed"])
    rate, sizes = traffic["rate_per_s"], traffic["images_per_request"]
    n_in = max(int(round(rate * seconds)), 1)
    times = np.sort(rng.uniform(0.0, seconds, n_in))
    gaps = list(np.diff(times, prepend=0.0))
    gaps += list(rng.exponential(1.0 / rate, int(math.ceil(rate * traffic["tail_s"]))))
    imgs = [int(v) for v in rng.integers(sizes[0], sizes[1] + 1, len(gaps))]
    perm = np.random.default_rng([seed, 7])
    order = np.concatenate([perm.permutation(n_in), n_in + perm.permutation(len(gaps) - n_in)])
    offs = np.cumsum([gaps[i] for i in order])
    return [(float(o), imgs[i]) for o, i in zip(offs, order)], n_in


def drive_poisson(prog: Program, cell: Cell, seed: int, seconds: float, device, tracer,
                  t_start: float):
    """An open loop: requests due at Poisson times, each submitted by one of
    ``clients`` threads that then waits on ``Ticket.result()``; every
    request's inputs are made before the first is due. The first
    ``warm_s`` of arrivals (a schedule of their own) warm the program up
    and count as set-up. The window's requests are those due in its first
    ``seconds``; it closes when the last of them is in hand (or ``GRACE_S``
    after, when one never comes). Later arrivals keep the load on meanwhile
    and are not measured."""
    tr, model = cell.traffic, cell.config["model"]
    warm_tr = dict(tr, schedule_seed=tr["schedule_seed"] + 1, tail_s=0.0)
    warm, n_warm = poisson_schedule(warm_tr, seed, tr["warm_s"]) if tr["warm_s"] else ([], 0)
    schedule, n_in = poisson_schedule(tr, seed, seconds)
    reqs = [Request(WARM_INDEX + i, n, None, None) for i, (_, n) in enumerate(warm[:n_warm])]
    reqs += [Request(i, n, None, None) for i, (_, n) in enumerate(schedule)]
    for r in reqs:  # all inputs made in set-up: no client touches the card before it submits
        r.x, r.cond = cell.family.make_request(model, seed, r.index, r.images, device)
    measured = reqs[n_warm:n_warm + n_in]
    lock = threading.Lock()
    stop = threading.Event()
    nxt = [0]
    t_warm = time.monotonic() + 0.2
    t0 = t_warm + tr["warm_s"]
    offsets = [off for off, _ in warm[:n_warm]] + [tr["warm_s"] + off for off, _ in schedule]
    for off, r in zip(offsets, reqs):
        r.due = t_warm + off

    def client():
        while not stop.is_set():
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(reqs):
                return
            r = reqs[i]
            if stop.wait(max(r.due - time.monotonic(), 0.0)):
                return
            try:
                r.ticket = prog.submit(r.x, r.cond, deadline_ms=tr["deadline_ms"])
            except Exception as exc:  # noqa: BLE001 - a refused request counts as failed
                r.error = repr(exc)
                continue
            while True:
                try:
                    r.sample = r.ticket.result(timeout=2.0)
                    r.in_hand = time.monotonic()
                    r.done_t = r.ticket.done_t
                    break
                except TimeoutError:
                    if stop.is_set():
                        return
                except Exception as exc:  # noqa: BLE001 - a failed request counts as failed
                    r.error = repr(exc)
                    r.done_t = r.ticket.done_t
                    break

    threads = [threading.Thread(target=client, name=f"perfbench-client{k}", daemon=True)
               for k in range(tr["clients"])]
    for th in threads:
        th.start()
    time.sleep(max(t0 - time.monotonic(), 0.0))
    if tracer is not None:
        tracer.start()  # the window only: the warm-up's events would be read for nothing
    open_snap = prog.snapshot()
    horizon = t0 + seconds + GRACE_S
    while time.monotonic() < horizon:
        if all(r.in_hand is not None or r.error is not None for r in measured):
            break
        time.sleep(0.1)
    t_close = max([r.in_hand or r.done_t or time.monotonic() for r in measured] + [t0])
    close_snap = prog.snapshot()
    trace = tracer.stop() if tracer is not None else None
    stop.set()
    for th in threads:
        th.join(timeout=GRACE_S)
    for r in measured:
        if r.in_hand is None and r.error is None:
            r.error = "no answer within the grace period"
    return t0 - t_start, t0, t_close, measured, open_snap, close_snap, trace


TRAFFIC_KINDS = {"backlog": drive_backlog, "poisson": drive_poisson}


# ---------------------------------------------------------- correctness
def pick_sample(measured: list[Request], count: int, seed: int) -> list[Request]:
    """``count`` served requests drawn from the seed, the largest among them."""
    served = [r for r in measured if r.sample is not None]
    if not served:
        return []
    rng = np.random.default_rng([seed, 11])
    largest = max(served, key=lambda r: (r.images, -r.index))
    rest = [r for r in served if r is not largest]
    take = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False) if rest else []
    return [largest] + [rest[int(i)] for i in take]


def compare(cell: Cell, weights: dict, picked: list[Request],
            served: list | None = None) -> float:
    """The widest relative L2 gap of a served image's latents from the
    family's reference's, in blocks of the configuration's
    ``reference_block`` images. ``served`` stands in for the requests'
    served latents (the control)."""
    import torch

    xs = torch.cat([r.x for r in picked])
    cond = {k: torch.cat([r.cond[k] for r in picked]) for k in picked[0].cond}
    got = torch.cat(served if served is not None else [r.sample for r in picked])
    block = cell.config["reference_block"]
    worst = 0.0
    with torch.no_grad():
        for lo in range(0, xs.shape[0], block):
            want = cell.family.reference_sample(
                weights, cell.config, xs[lo:lo + block],
                {k: v[lo:lo + block] for k, v in cond.items()})
            diff = (got[lo:lo + block].to(want.device) - want).flatten(1).norm(dim=1)
            rel = diff / want.flatten(1).norm(dim=1)
            worst = max(worst, float(rel.max()))
    return worst


# ------------------------------------------------------------------ main
def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None) -> dict:
    """One run; returns the result line's object (``correct`` included)."""
    import torch

    t_start = time.monotonic() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    phases = {"imports": time.monotonic() - t_start}
    if on_card:
        from repro_torch.kernels.common import build_library

        phases["build"] = build_library()[1]
    t = time.monotonic()
    weights = cell.family.make_weights(cell.config["model"], seed, device)
    if on_card:
        torch.cuda.synchronize()
    phases["weights"] = time.monotonic() - t
    t = time.monotonic()
    prog = Program(cell, weights, device)
    phases["program"] = time.monotonic() - t
    tracer = None
    if trace:
        from .tracing import Tracer

        tracer = Tracer()
    drive = TRAFFIC_KINDS[cell.traffic["kind"]]
    try:
        setup_s, t_open, t_close, measured, open_snap, close_snap, tdata = drive(
            prog, cell, seed, seconds, device, tracer, t_start)
    finally:
        prog.close()
    keys = {k: (dict(k.mode_sig), k.bucket, dict(prog.cache.capture_launches.get(k, {})))
            for k in prog.cache.capture_counts}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    for r in measured:
        r.ticket = None  # a ticket holds its scheduler, and so the runner cache
    run = Run(cell, setup_s, t_open, t_close, measured, open_snap, close_snap, keys, tdata)
    stats = close_snap["stats"]
    print(f"perfbench: {cell.name} seed {seed}: {len(measured)} requests, {run.images} images "
          f"in {run.window_s:.3f} s; setup {setup_s:.3f} s; warmup {prog.warm}; "
          f"dispatches {stats['dispatches']} triggers {stats['triggers']} runner keys "
          f"{len(keys)} captures after warmup {stats.get('captures_after_warmup')} arena bytes "
          f"{stats.get('arena_bytes')} peak {peak}; set-up phases (s) "
          f"{ {k: round(v, 3) for k, v in phases.items()} }",
          file=sys.stderr)
    if cell.traffic["kind"] == "poisson":
        from .stats import latencies, percentile

        lat = latencies(run)
        print("perfbench: latency quantiles (s) " + " ".join(
            f"p{q}={percentile(lat, q):.4f}" for q in (10, 25, 50, 75, 85, 90, 95, 99)),
            file=sys.stderr)
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    picked = pick_sample(measured, cell.traffic["sample_requests"], seed)
    failed = sum(r.sample is None for r in measured)
    limit = cell.config["correct"]["latent_rel_err"]
    gap = compare(cell, weights, picked) if picked else None
    print(f"perfbench: compared {sum(r.images for r in picked)} images of {len(picked)} "
          f"requests with the reference", file=sys.stderr)
    checks = {"unanswered": {"value": failed, "limit": 0},
              "latent_rel_err": {"value": gap, "limit": limit}}
    correct = gap is not None and failed == 0 and gap <= limit

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(measured), "failed": failed,
           "metrics": metrics, "device": dev}
    if tdata is not None:
        from . import tracing as trace_mod

        dev["busy_s"] = tdata.busy_s(t_open, t_close)
        dev["window_s"] = run.window_s
        out["breakdown"] = {"device_ops": trace_mod.top_device_ops(tdata, t_open, t_close),
                            "idle_gaps": trace_mod.idle_gaps(tdata, t_open, t_close)}
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return out


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found} (JAX or the JAX package)", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
