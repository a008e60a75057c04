"""Persistent compiled-runner cache for the serving path: one CUDA graph a key.

Mirror of ``src/repro/serve/cache.py``. The reference keeps one ``jax.jit``
trace per

    RunnerKey = (model-cfg signature, layer-mode signature,
                 plan.cache_sig(), batch bucket)

and this cache keeps one runner per key. On the card a runner captures the
compiled step (``dit_runner.make_step_fn``) into one ``torch.cuda.CUDAGraph``
the first time it is called and replays it afterwards, so a step costs
one graph launch instead of the 3,500-29,600 small launches the host
issues for it uncaptured (PERF.md). On the CPU a runner runs the same
in-place step on the same arena, uncaptured (the plain path the caller
asked for); its first call per key stands in for a capture there.

A graph replays fixed addresses, so everything it reads lives at one
place for the cache's life:

* **Weights and model params.** The cache binds to one params tree: the
  int8 K-major weights (``w_qk``) are built once from the first engine
  (:meth:`CompiledRunnerCache.weights_for`) and every engine of that tree
  reuses them; the fp32 params are read by pointer. The binding records
  each leaf's ``data_ptr`` and ``_version``; another tree, or one changed
  in place, raises instead of replaying stale weights.
* **One arena per (cfg, bucket).** The temporal state (x_prev / y_prev per
  linear layer, a_prev / b_prev / y_prev per attention layer), the
  per-sample scales and the static inputs (latents, t, labels) live in an
  :class:`_Arena` that every graph of that bucket reads and writes in
  place (the step copies each layer's new state over its old one right
  after the layer). A sample's first compiled step copies the eager
  engine's state and scales in; a segment swap or a re-anchor hands the
  arena's state handle (:class:`ArenaState`) on, so nothing is copied.
  One sample at a time may hold an arena: a handle that another sample's
  state has overwritten raises. The watchdog snapshots the arena before
  a step (:meth:`ArenaState.snapshot`) so it can roll back.
* **Outputs.** The graph's ``eps`` and class-statistics aux sit at fixed
  addresses; a replay returns a clone of ``eps`` (the PLMS sampler keeps
  earlier ones) and of the aux, flattened into one float64 vector in the
  graph so the host reads it in one copy.

Before its capture a runner runs the step once uncaptured on a side
stream (the kernels' build, their ``cudaFuncSetAttribute`` and the SM count
happen there), as PyTorch's capture recipe does. All graphs share one
memory pool and replay under the cache's lock. A capture or a replay that
fails raises; nothing falls back to an uncaptured or a CPU step.

A cache is bound to one device: the device of the params tree it binds
(:meth:`CompiledRunnerCache.weights_for`). Its weights, arenas, side
stream and capture stream live there, and a dispatch whose inputs, state
or params live elsewhere raises before any capture (the reference puts
the placement into its executables' fingerprint). A mesh therefore gives
every device of every shard a cache of its own (``serve/mesh.py``). The
captures of all caches in the process take one lock, so two shards
never capture at once.

A capture runs with ``capture_error_mode="thread_local"``: only the
capturing thread is barred from synchronizing CUDA calls while it lasts.
Under the default ``"global"`` mode a ``cudaMalloc`` or a synchronize on
any other thread (a client of ``ServeScheduler``'s dispatch thread making
its next request) would fail, or break the capture.

The wrappers' launch counters tick while a step is captured, not when it
is replayed: :attr:`CompiledRunnerCache.capture_launches` keeps each key's
launches per capture and :meth:`CompiledRunnerCache.replayed_launches`
multiplies them by its replays.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable

import torch

from .. import spans
from ..core.ditto import dit_runner
from ..core.ditto.dit_runner import DittoDiT
from ..core.ditto.compiled import CompiledDittoEngine
from ..core.ditto.engine import DittoEngine
from ..core.ditto.plan import DittoPlan, segment_resolved, segment_view

#: Held by every capture in the process: PyTorch's graph capture expects one
#: capture under way at a time, and the launch counters a capture reads are
#: the process's.
_CAPTURE_LOCK = threading.Lock()


def cfg_signature(cfg) -> tuple:
    """Hashable signature of a model config dataclass (e.g. DiTCfg)."""
    if dataclasses.is_dataclass(cfg):
        return (type(cfg).__name__,) + dataclasses.astuple(cfg)
    return (type(cfg).__name__, repr(cfg))


@dataclasses.dataclass(frozen=True)
class RunnerKey:
    cfg_sig: tuple
    mode_sig: tuple
    plan_sig: tuple  # DittoPlan.cache_sig(), ordered — see accessors below
    bucket: int | None = None

    # plan_sig's field order is DittoPlan.cache_sig()'s stable contract
    @property
    def block(self) -> int:
        return self.plan_sig[0]

    @property
    def collect_stats(self) -> bool:
        return self.plan_sig[1]

    @property
    def low_bits(self) -> int:
        return self.plan_sig[2]

    @property
    def fused(self) -> bool:
        return self.plan_sig[3]

    @property
    def mesh(self) -> tuple | None:
        return self.plan_sig[4]


def _launch_counts() -> dict[str, int]:
    """The kernel wrappers' launch counters, by kernel."""
    from ..kernels import diff_encode, ditto_diff_matmul, fused_step, int8_matmul, quant_rows

    return {"int8_matmul": int8_matmul.launches, "diff_encode": diff_encode.launches,
            "ditto_diff_matmul": ditto_diff_matmul.launches,
            "ditto_diff_matmul[low_bits=4]": ditto_diff_matmul.launches_int4,
            "diff_encode_fused": fused_step.encode_launches,
            "ditto_fused_matmul": fused_step.matmul_launches,
            "quantize_rows": quant_rows.quantize_launches,
            "dequantize_rows": quant_rows.dequantize_launches}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, getattr(tree, "value", tree)  # nn.core.Param or a tensor


def _fingerprint(params) -> tuple:
    """Where each leaf of a params tree lives and whether it was changed in place."""
    return tuple((path, t.data_ptr(), t._version, tuple(t.shape), t.dtype, t.device)
                 for path, t in _leaves(params))


def _map_state(fn, state) -> dict:
    return {name: {k: fn(v) for k, v in st.items()} for name, st in state.items()}


def _flat_aux(aux: dict) -> tuple[torch.Tensor | None, list]:
    """One float64 vector of every (3,) aux tensor, and its (layer, key) order."""
    keys = [(name, key) for name, a in aux.items() for key in a]
    if not keys:
        return None, keys
    return torch.cat([aux[n][k].to(torch.float64).reshape(3) for n, k in keys]), keys


def _unflat_aux(flat: torch.Tensor | None, keys: list) -> dict:
    """The aux dict of :func:`_flat_aux`'s order, as views of ``flat``."""
    aux: dict = {}
    for i, (name, key) in enumerate(keys):
        aux.setdefault(name, {})[key] = flat[3 * i:3 * i + 3]
    return aux


class ArenaState(dict):
    """The state dict of an arena, handed from step to step: the layers'
    tensors, which the graphs update in place. Its identity says which
    sample holds the arena."""

    def snapshot(self) -> dict:
        """A copy of the state as it is now (the watchdog's rollback point)."""
        return _map_state(torch.clone, self)


def _same_device(what: str, t: torch.Tensor | None, dev: torch.device) -> None:
    if t is not None and t.device != dev:
        raise ValueError(f"this runner cache is bound to {dev}; the dispatch's {what} lives on "
                         f"{t.device} (use a cache for each device)")


class _Arena:
    """The fixed-address buffers every graph of one (cfg, bucket) reads:
    temporal state, per-sample scales, static inputs and the dparams tree
    the graphs were captured with."""

    def __init__(self, weights: dict, dparams: dict, state: dict, latents, t):
        self.state = _map_state(torch.empty_like, state)
        self.dparams = {}
        for name, p in dparams.items():
            own = dict(weights.get(name, {}))
            for k, v in p.items():
                if k not in own:  # the per-sample scales
                    own[k] = None if v is None else torch.empty_like(v)
            self.dparams[name] = own
        self.latents = torch.empty_like(latents)
        self.t = torch.empty_like(t)
        self.labels = None
        self.holder: ArenaState | None = None  # the state handle of the sample in it
        self.scales_from = None  # the dparams whose scales are in it

    def nbytes(self) -> int:
        """Bytes of the arena's own buffers (the weights are the cache's)."""
        own = [v for st in self.state.values() for v in st.values()]
        own += [p[k] for name, p in self.dparams.items() for k in p
                if k not in ("w_qk", "w_scale", "bias") and p[k] is not None]
        own += [self.latents, self.t] + ([] if self.labels is None else [self.labels])
        return sum(t.numel() * t.element_size() for t in own)

    def load(self, dparams: dict, state, latents, t, labels) -> None:
        """Copy what differs from the last replay into the fixed buffers.
        Raises ``ValueError`` for a state or scale on another device."""
        dev = self.latents.device
        if state is not self.holder:
            if isinstance(state, ArenaState):
                raise RuntimeError(
                    "the runner cache's state arena for this bucket was overwritten by "
                    "another sample in flight; serve one sample per bucket at a time")
            for name, st in state.items():
                for k, v in st.items():
                    _same_device(f"state {name}.{k}", v, dev)
                    self.state[name][k].copy_(v)
            self.holder = ArenaState(self.state)
        if dparams is not self.scales_from:
            for name, p in dparams.items():
                own = self.dparams[name]
                for k, v in p.items():
                    if v is not own[k]:
                        _same_device(f"param {name}.{k}", v, dev)
                        own[k].copy_(v)  # scales per sample; foreign weights too
            self.scales_from = dparams
        self.latents.copy_(latents)
        self.t.copy_(t)
        if labels is not None:
            if self.labels is None:
                self.labels = torch.empty_like(labels)
            self.labels.copy_(labels)


class _Graph:
    __slots__ = ("graph", "out", "flat", "keys")

    def __init__(self, graph, out, flat, keys):
        self.graph, self.out, self.flat, self.keys = graph, out, flat, keys


class _Runner:
    """One cache entry: the in-place step of one key, run on its bucket's
    arena. On the card it captures the step into a CUDA graph on its first
    call (one graph per labels presence) and replays it; on the CPU it
    calls the step."""

    __slots__ = ("key", "step", "graphs", "_cache")

    def __init__(self, key: RunnerKey, cfg, modes: dict, plan: DittoPlan, cache):
        self.key = key
        self.step = dit_runner.make_step_fn(cfg, modes, plan, inplace=True)
        self.graphs: dict[bool, _Graph | None] = {}  # None: built on the CPU
        self._cache = cache

    def __call__(self, dparams, mparams, state, latents, t, labels):
        return self._cache._run(self, dparams, mparams, state, latents, t, labels)


class _AttributionFrame:
    """Per-thread capture counter yielded by ``CompiledRunnerCache.attribution``."""

    __slots__ = ("count",)

    def __init__(self):
        self.count = 0


class CompiledRunnerCache:
    """One runner per :class:`RunnerKey`, shared by every serve batch that
    maps to the key. ``capture_counts`` records how many CUDA graphs each
    key captured (on the CPU: 1 at its first call or warmup), so "N
    same-bucket batches capture once" is asserted, not inferred.

    Thread-safe: lookups, captures and replays run under one lock. A
    session that serves from several threads serializes its samples on
    :attr:`sample_lock`, since a bucket's arena holds one sample's state.
    """

    def __init__(self):
        self._steps: dict[RunnerKey, _Runner] = {}
        self.capture_counts: dict[RunnerKey, int] = {}
        self.capture_launches: dict[RunnerKey, dict] = {}
        self.replays: dict[RunnerKey, int] = {}
        self.hits = 0
        self.misses = 0
        self._arenas: dict[tuple, _Arena] = {}
        self._bound = None  # (params tree, fingerprint, weights)
        self.device: torch.device | None = None  # the bound params' device
        self._pool = None
        self._capture_stream = None
        self._lock = threading.RLock()
        self.sample_lock = threading.RLock()
        self._tls = threading.local()

    # ------------------------------------------------------- attribution
    def _attr_frames(self) -> list:
        frames = getattr(self._tls, "frames", None)
        if frames is None:
            frames = self._tls.frames = []
        return frames

    @contextlib.contextmanager
    def attribution(self):
        """Count the captures (CPU: runner builds) THIS THREAD causes inside
        the block. Yields an object with a ``count`` attribute."""
        frame = _AttributionFrame()
        frames = self._attr_frames()
        frames.append(frame)
        try:
            yield frame
        finally:
            frames.remove(frame)

    def _count_capture(self, key: RunnerKey) -> None:
        self.capture_counts[key] = self.capture_counts.get(key, 0) + 1
        for frame in self._attr_frames():
            frame.count += 1

    # ----------------------------------------------------------- weights
    def weights_for(self, params, engine: DittoEngine) -> dict:
        """Per linear layer ``dict(w_qk, w_scale, bias)`` for ``params``: built
        from ``engine``'s registered weights the first time (``w_qk`` is the
        int8 weight K-major, as the kernels read it), the same tensors for
        every later engine of the same params, on the params' device (the
        cache's from then on). Raises ``ValueError`` for another params
        tree or one changed in place: the cache's graphs read the weights
        and params it was bound to."""
        with self._lock:
            fp = _fingerprint(params)
            if self._bound is not None:
                if fp != self._bound[1]:
                    raise ValueError(
                        "this runner cache is bound to another params tree (or the tree "
                        "was changed in place); its graphs read the bound weights. "
                        "clear() it or use another cache")
                return self._bound[2]
            dev = next(t for _, t in _leaves(params)).device

            def on(t):
                return None if t is None else t.to(dev)

            weights = {name: dict(w_qk=st.w.q.t().contiguous().to(dev), w_scale=on(st.w.scale),
                                  bias=on(st.bias))
                       for name, st in engine.layers.items() if st.w is not None}
            # the leaves are held so their storage cannot be reused under the
            # recorded pointers
            self._bound = ([t for _, t in _leaves(params)], fp, weights)
            self.device = dev
            return weights

    def _check_params(self, mparams) -> None:
        if self._bound is None or _fingerprint(mparams) != self._bound[1]:
            raise ValueError(
                "a runner was called with params the cache is not bound to; build "
                "the step's engine through weights_for(params, engine) first")

    # ------------------------------------------------------------ replay
    def _run(self, runner: _Runner, dparams, mparams, state, latents, t, labels):
        """Load the step's inputs into its bucket's arena and run the step
        there: a graph replay on the card (a ``ditto.replay`` span from the
        load to the outputs' clones, a first call's ``ditto.capture``
        inside it), the step itself on the CPU."""
        with self._lock:
            self._check_params(mparams)
            _same_device("latents", latents, self.device)
            _same_device("labels", labels, self.device)
            akey = (runner.key.cfg_sig, latents.shape[0])
            arena = self._arenas.get(akey)
            if arena is None:
                arena = self._arenas[akey] = _Arena(self._bound[2], dparams, state,
                                                    latents, t)
            has_labels = labels is not None
            if latents.device.type != "cuda":
                arena.load(dparams, state, latents, t, labels)
                if has_labels not in runner.graphs:
                    runner.graphs[has_labels] = None
                    self._count_capture(runner.key)
                out, _, aux = runner.step(*self._args(arena, mparams, has_labels))
                return out, arena.holder, aux
            with spans.span("ditto.replay", bucket=akey[1]):
                arena.load(dparams, state, latents, t, labels)
                g = runner.graphs.get(has_labels)
                if g is None:
                    g = runner.graphs[has_labels] = self._capture(runner, arena, mparams,
                                                                  has_labels)
                g.graph.replay()
                self.replays[runner.key] = self.replays.get(runner.key, 0) + 1
                out = g.out.clone()
                aux = _unflat_aux(None if g.flat is None else g.flat.clone(), g.keys)
                return out, arena.holder, aux

    @staticmethod
    def _args(arena: _Arena, mparams, has_labels: bool) -> tuple:
        labels = arena.labels if has_labels else None
        return (arena.dparams, mparams, arena.state, arena.latents, arena.t, labels)

    def _capture(self, runner: _Runner, arena: _Arena, mparams, has_labels: bool) -> _Graph:
        """Warm the step once uncaptured on a side stream, then capture it,
        on the cache's device and under the process's capture lock (so the
        launch counters see this capture's launches alone). The warm step
        writes the arena's state in place, so it runs on a copy of the
        state that is put back before the capture."""
        with _CAPTURE_LOCK, spans.span("ditto.capture", bucket=arena.latents.shape[0]):
            return self._capture_locked(runner, arena, mparams, has_labels)

    def _capture_locked(self, runner: _Runner, arena: _Arena, mparams,
                        has_labels: bool) -> _Graph:
        args = self._args(arena, mparams, has_labels)
        dev = self.device
        saved = _map_state(torch.clone, arena.state)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            runner.step(*args)
        cur.wait_stream(side)
        for name, st in saved.items():
            for k, v in st.items():
                arena.state[name][k].copy_(v)
        del saved
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            # PyTorch's default capture stream is made once, on whichever
            # device is current then: each cache captures on its own
            self._capture_stream = torch.cuda.Stream(device=dev)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(
                graph, pool=self._pool, stream=self._capture_stream,
                capture_error_mode="thread_local"):
            out, _, aux = runner.step(*args)
            flat, keys = _flat_aux(aux)
        after = _launch_counts()
        self.capture_launches[runner.key] = {k: after[k] - before[k] for k in after
                                             if after[k] != before[k]}
        self._count_capture(runner.key)
        return _Graph(graph, out, flat, keys)

    # ------------------------------------------------------------------ api
    @staticmethod
    def _resolve(modes, plan: DittoPlan | None) -> tuple[DittoPlan, tuple]:
        """A constant ``PlanSchedule`` collapses to its plan (the same key);
        a multi-segment one is rejected: one key is one segment's step."""
        plan = segment_resolved(DittoPlan() if plan is None else plan)
        mode_sig = tuple(sorted(modes.items())) if isinstance(modes, dict) else tuple(modes)
        return plan, mode_sig

    def key_for(self, cfg, modes: dict[str, str] | tuple, plan: DittoPlan | None = None,
                *, bucket: int | None = None) -> RunnerKey:
        plan, mode_sig = self._resolve(modes, plan)
        return RunnerKey(cfg_signature(cfg), mode_sig, plan.cache_sig(), bucket)

    def step_for(self, cfg, modes: dict[str, str], plan: DittoPlan | None = None,
                 *, bucket: int | None = None) -> Callable:
        """The runner ``step(dparams, mparams, state, latents, t, labels) ->
        (eps, new_state, aux)`` of the key, built on a miss."""
        plan, mode_sig = self._resolve(modes, plan)
        key = RunnerKey(cfg_signature(cfg), mode_sig, plan.cache_sig(), bucket)
        with self._lock:
            if key in self._steps:
                self.hits += 1
                return self._steps[key]
            self.misses += 1
            runner = self._steps[key] = _Runner(key, cfg, dict(modes), plan, self)
            self.capture_counts.setdefault(key, 0)
            return runner

    def warmup(self, cfg, modes: dict[str, str], plans, buckets, *, params,
               labels: bool | None = None) -> dict:
        """Capture the graphs of a bucket ladder before the first request: for
        each bucket, one eager calibration step of an act-policy engine on
        seeded latents gives the arena its shapes, then each distinct
        segment plan of ``plans`` (plans or schedules) captures its graph
        under ``modes`` (on the CPU: runs its step once). ``labels`` says
        whether requests pass class labels (a graph per presence; default:
        whether ``cfg`` has classes). ``params`` is the tree the session
        serves; its device is the warmup's. Returns ``{"captures": the
        captures it made}``."""
        dev = next(t for _, t in _leaves(params)).device
        labels = bool(cfg.n_classes) if labels is None else labels
        before = self.n_captures
        for bucket in buckets:
            runners = {id(r): r for r in (self.step_for(cfg, modes, seg, bucket=bucket)
                                          for plan in plans for _, _, seg in segment_view(plan))}
            todo = [r for r in runners.values() if labels not in r.graphs]
            if not todo:
                continue
            g = torch.Generator(device=dev).manual_seed(bucket)
            x = torch.randn((bucket, cfg.input_size, cfg.input_size, cfg.in_channels),
                            generator=g, device=dev)
            t = torch.full((bucket,), 500, dtype=torch.int32, device=dev)
            lab = torch.arange(bucket, device=dev) % cfg.n_classes if labels else None
            eng = DittoEngine(policy="act", device=dev)
            DittoDiT(params, cfg, eng)(x, t, lab)
            eng.end_step()
            ceng = CompiledDittoEngine(eng, weights=self.weights_for(params, eng))
            state = ceng.init_state()
            for r in todo:
                _, state, _ = r(ceng.params, params, state, x, t, lab)
        return {"captures": self.n_captures - before}

    # ---------------------------------------------------------------- stats
    @property
    def n_captures(self) -> int:
        return sum(self.capture_counts.values())

    def replayed_launches(self) -> dict[str, int]:
        """Kernel launches the graphs' replays ran, by kernel: each key's
        launches per capture times its replays."""
        out: dict[str, int] = {}
        for key, n in self.replays.items():
            for name, c in self.capture_launches.get(key, {}).items():
                out[name] = out.get(name, 0) + c * n
        return out

    def __len__(self) -> int:
        return len(self._steps)

    def stats(self) -> dict[str, Any]:
        return {"runners": len(self._steps), "captures": self.n_captures,
                "hits": self.hits, "misses": self.misses,
                "replays": sum(self.replays.values()),
                "arena_bytes": {bucket: a.nbytes() for (_, bucket), a in self._arenas.items()}}

    @staticmethod
    def stats_of(caches) -> dict[str, Any]:
        """:meth:`stats` summed over ``caches`` (a mesh's), arena bytes by
        bucket; ``{}`` for none."""
        out: dict[str, Any] = {}
        for c in caches:
            for k, v in c.stats().items():
                if k == "arena_bytes":
                    merged = out.setdefault(k, {})
                    for b, nb in v.items():
                        merged[b] = merged.get(b, 0) + nb
                else:
                    out[k] = out.get(k, 0) + v
        return out

    def clear(self) -> None:
        """Drop every runner, graph, arena and the params binding."""
        with self._lock:
            self._steps.clear()
            self.capture_counts.clear()
            self.capture_launches.clear()
            self.replays.clear()
            self._arenas.clear()
            self._bound = None
            self.device = None
            self._pool = None
            self._capture_stream = None
            self.hits = self.misses = 0
