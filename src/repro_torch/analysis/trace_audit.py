"""Runner-key audit: prove ``cache_sig()`` ⇔ what a step launches, abstractly.

Counterpart of ``src/repro/analysis/trace_audit.py``. ``RunnerKey = (cfg_sig,
mode_sig, plan.cache_sig(), bucket)`` — the serving cache keeps one
captured CUDA graph a key (``serve/cache.py``), so the whole cache hangs on
``cache_sig()`` being exactly the set of plan fields that change what a
step launches. Two failure modes, one per direction:

* **stale graph** — a knob changes the step but not the sig. Two plans
  collide on one key and the second silently replays the first plan's
  graph (wrong results, no error).
* **duplicate graph** — a sig field has no effect on the step. Identical
  steps get distinct keys and re-pay the warm-up and capture the cache
  exists to amortize.

The reference fingerprints a jaxpr. The port has none: a step *is* what
it dispatches. :class:`StepRecorder` records, in order, each aten op the
step dispatches (the op, its tensors' shapes and dtypes, its other
arguments; devices and metadata queries are left out) and, interleaved where they happen, the
hand-written kernels' launches, which the dispatch cannot see: every
wrapper reports its static arguments through
``kernels/common.py:record_work`` (the operands' shapes and dtypes,
``low_bits``, ``w_transposed``, whether ``y_prev`` is given; not the K
split or the encode cluster, which the card chooses). The fingerprint
hashes that record. :func:`trace_fingerprint` runs
``dit_runner.make_step_fn(..., inplace=True)`` — the step the cache
captures — on fake tensors (``repro_torch/launch/op_analysis.py:fake_mode`` /
``fake_like``: fake CUDA where a card is visible, ``meta`` where not), so
no weight exists and no kernel launches; the temporal state's shapes come
from one abstract all-``act`` step (:func:`abstract_state`). On the card
``chip_smoke.py`` records the same around the step the cache captures and
holds the two fingerprints equal. Within an audit group (same cfg,
modes, bucket):

  equal sig, different fingerprint  -> ``trace-stale`` finding
  different sig, equal fingerprint  -> ``trace-dup`` finding, unless an
                                       explicit shared-trace allowlist
                                       entry covers the pair

The dup direction is only asserted in all-``diff`` mode groups: in an
all-``act`` group every diff-path knob is validated-then-ignored by
design (``int8_matmul`` has no Δ operand).

Where the port differs from the reference:

* ``block``: the card's kernels tile by 128, so a plan with another block
  is refused before any step (``plan.py:check_device_block``) on the
  card and on ``meta`` alike; the audit records ``block-unrefused`` if it
  is not. Such a plan is audited on a CPU leg instead, where the plain
  versions take any block: the whole tiny matrix on real CPU tensors made
  from one seed, the same for every plan (:func:`cpu_inputs`).
* Mesh plans: the port does not trace a sharding constraint into its
  step; a dispatch whose batch the plan's width divides runs as row
  groups (``dit_runner.SplitDittoDiT`` over
  ``distributed/sharding.py:batch_sharding``), each group's step at its
  own bucket, and one it does not divide runs unsplit on the shard's
  first device (``sim/harness.py:serve_records``). A mesh plan's
  fingerprint is that dispatch (:func:`dispatch_fingerprint`): each
  group's position and rows, then its step's fingerprint.
  ``mesh_axis`` reaches that split only as the name ``place_dispatch``
  is given, and a width that does not divide the bucket changes nothing
  a device runs: :data:`SHARED_TRACE_ALLOWLIST` holds both, each with its
  reason, beside the reference's ``fused-low-bits``.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..core.ditto import dit_runner
from ..core.ditto.plan import CARD_BLOCK, DittoPlan, PlanSchedule, check_device_block
from ..distributed.sharding import batch_sharding
from ..kernels import common
from ..kernels.common import DEFAULT_LOW_BITS
from ..launch import op_analysis
from ..nn import dit as dit_mod
from .findings import Finding

#: where sig/step mismatches anchor — the sig definition is the defect site
PLAN_PATH = "src/repro_torch/core/ditto/plan.py"


# ------------------------------------------------------------- fingerprints
def _canon(x):
    """A hashable, device-free stand-in for an op argument."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_canon(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((str(k), _canon(v)) for k, v in x.items()))
    if isinstance(x, torch.device):
        return "device"
    if isinstance(x, (torch.dtype, torch.layout, torch.memory_format)):
        return str(x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return type(x).__name__


#: metadata queries: a fake tensor answers them through the dispatch
#: (``prim.device``, ``aten.sym_size``), a real one without it; they launch
#: nothing, so the record leaves them out
_QUERIES = {torch.ops.aten.sym_size, torch.ops.aten.sym_stride, torch.ops.aten.sym_numel,
            torch.ops.aten.sym_storage_offset}


def _hash(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


class StepRecorder(TorchDispatchMode):
    """Records what the code run inside it dispatches: each aten op, and
    each kernel launch the wrappers report (``common.record_work``),
    interleaved in order. Enter it inside the fake mode that made the
    step's arguments (as ``op_analysis.analyze`` is entered), or around a
    step on real tensors."""

    def __init__(self):
        super().__init__()
        self.events: list[tuple] = []
        self.launches: list[tuple[str, dict]] = []
        self._recording = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not (func.namespace == "prim" or func.overloadpacket in _QUERIES):
            self.events.append(("op", str(func), _canon(args), _canon(kwargs)))
        return func(*args, **kwargs)

    def _launch(self, name: str, static: dict) -> None:
        self.events.append(("kernel", name, _canon(static)))
        self.launches.append((name, static))

    def __enter__(self):
        self._recording = common.recording(launches=self._launch)
        self._recording.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._recording.__exit__(*exc)

    def fingerprint(self) -> str:
        return _hash(self.events)

    def launch_counts(self) -> dict[str, int]:
        """Launches by kernel, keyed as the runner cache counts them
        (``serve/cache.py``: ``ditto_diff_matmul[low_bits=4]`` apart)."""
        out: dict[str, int] = {}
        for name, static in self.launches:
            key = f"{name}[low_bits=4]" if static.get("low_bits") == 4 else name
            out[key] = out.get(key, 0) + 1
        return out


@dataclasses.dataclass(frozen=True)
class TraceCase:
    """One audited point: a labelled (sig, fingerprint) pair.

    ``plan`` and ``batch`` ride along (not compared) so allowlist
    predicates can ask *why* two cases were expected to share a step.
    """
    label: str
    sig: tuple
    fingerprint: str
    plan: object = None
    batch: int | None = None


# -------------------------------------------------------- shared-trace list
def _differing_fields(pa, pb) -> set[str]:
    fields = {f.name for f in dataclasses.fields(pa)} if dataclasses.is_dataclass(pa) \
        else set(vars(pa))
    return {f for f in fields if getattr(pa, f) != getattr(pb, f, object())}


def _fused_low_bits(a: TraceCase, b: TraceCase) -> bool:
    """fused=True plans differing only in ``low_bits`` share one step: the
    fused flow's Δ-cache IS the int4 format, and ``kernels/ops.py`` runs
    ``diff_encode_fused`` -> ``ditto_fused_matmul`` whatever ``low_bits``
    says (as the reference does). ``low_bits`` stays in the sig: it
    selects distinct two-pass steps."""
    pa, pb = a.plan, b.plan
    if pa is None or pb is None:
        return False
    if not (getattr(pa, "fused", False) and getattr(pb, "fused", False)):
        return False
    return _differing_fields(pa, pb) == {"low_bits"}


def _unmeshed_sig(p) -> tuple:
    return p.replace(mesh_devices=None).cache_sig()


def _mesh_axis_name(a: TraceCase, b: TraceCase) -> bool:
    """Plans that split rows over the same width and whose sigs differ only
    in ``mesh_axis`` share one dispatch: the port's split has one axis
    (``place_dispatch`` hands the name to ``batch_sharding``, which does
    not read it), so the name labels the row groups and changes nothing a
    device launches. The name stays in ``cache_sig()`` so the port's
    ``RunnerKey`` keeps the reference's mesh identity and ``plan_rules``'
    mesh partition (every ``MESH_SIG_FIELDS`` name reaches the sig) holds;
    it costs a second capture only where one cache serves two axis names
    of one width, and ``ServeMesh.plan_for`` stamps every plan of a mesh
    with the mesh's one axis."""
    pa, pb = a.plan, b.plan
    if pa is None or pb is None or pa.mesh_devices is None:
        return False
    return pa.mesh_devices == pb.mesh_devices and _unmeshed_sig(pa) == _unmeshed_sig(pb)


def _mesh_unsplit(a: TraceCase, b: TraceCase) -> bool:
    """Plans whose sigs differ only in the mesh slot share one dispatch when
    neither splits this bucket: a width that does not divide the batch runs
    it whole on the shard's first device (``serve_records``), which is the
    unsharded step. The sig keeps the width, as the reference's does (its
    constraint is traced even when it replicates); a mesh session accepts
    only plans of its own width, so no cache holds both keys of such a
    pair."""
    pa, pb = a.plan, b.plan
    if pa is None or pb is None or a.batch is None or a.batch != b.batch:
        return False
    unsplit = all(p.mesh_devices is None or p.mesh_devices < 2 or a.batch % p.mesh_devices
                  for p in (pa, pb))
    return unsplit and _unmeshed_sig(pa) == _unmeshed_sig(pb)


#: # shared-trace — (name, predicate(case_a, case_b)) entries. A pair
#: matching any predicate may share a step despite distinct sigs.
SHARED_TRACE_ALLOWLIST: tuple = (
    ("fused-low-bits", _fused_low_bits),
    ("mesh-axis-name", _mesh_axis_name),
    ("mesh-unsplit", _mesh_unsplit),
)


# ------------------------------------------------------------------- audit
def audit_cases(cases: list[TraceCase], *, group: str = "", check_dup: bool = True,
                allowlist=SHARED_TRACE_ALLOWLIST) -> list[Finding]:
    """Pairwise both-direction check over one audit group."""
    findings = []
    for i, a in enumerate(cases):
        for b in cases[i + 1:]:
            if a.sig == b.sig and a.fingerprint != b.fingerprint:
                findings.append(Finding(
                    "trace-stale", PLAN_PATH, f"{group}:{a.label}~{b.label}",
                    f"[{group}] plans '{a.label}' and '{b.label}' share "
                    f"cache_sig() but dispatch different steps — the second "
                    f"to arrive would silently replay the first's graph; some "
                    f"knob distinguishing them is missing from cache_sig()"))
            elif a.sig != b.sig and a.fingerprint == b.fingerprint and check_dup:
                allowed = next((name for name, pred in allowlist if pred(a, b)), None)
                if allowed is None:
                    findings.append(Finding(
                        "trace-dup", PLAN_PATH, f"{group}:{a.label}~{b.label}",
                        f"[{group}] plans '{a.label}' and '{b.label}' have "
                        f"distinct cache_sig() but identical steps — a sig "
                        f"field with no effect on what a step launches "
                        f"duplicates graphs and re-pays their capture (add a "
                        f"shared-trace allowlist entry only if the sharing is "
                        f"intended)"))
    return findings


# ----------------------------------------------- abstract DiT inputs (no data)
def _layer_names(cfg):
    linear = []
    for i in range(cfg.n_layers):
        b = f"blk{i}"
        linear += [f"{b}.mod", f"{b}.wq", f"{b}.wk", f"{b}.wv", f"{b}.wo",
                   f"{b}.wi", f"{b}.wd"]
    linear.append("final.out")
    attn = [f"blk{i}.{s}" for i in range(cfg.n_layers) for s in ("qk", "pv")]
    return linear, attn


def uniform_modes(cfg, mode: str) -> dict[str, str]:
    linear, attn = _layer_names(cfg)
    return {nm: mode for nm in linear + attn}


def _linear_dims(cfg) -> dict[str, tuple[int, int, bool]]:
    """``{layer: (K, N, per-token)}`` of every linear layer, as
    ``dit_runner.DittoDiT`` registers them from the params."""
    d, hid = cfg.d_model, int(cfg.mlp_ratio * cfg.d_model)
    dims = {"mod": (d, 6 * d, False), "wq": (d, d, True), "wk": (d, d, True),
            "wv": (d, d, True), "wo": (d, d, True), "wi": (d, hid, True),
            "wd": (hid, d, True), "out": (d, cfg.patch_dim, True)}
    linear, _ = _layer_names(cfg)
    return {nm: dims[nm.split(".")[-1]] for nm in linear}


def _ditto_params(cfg, batch: int, make) -> dict:
    """The compiled pass's per-layer params (``CompiledDittoEngine.params``:
    K-major int8 weights, weight scales, biases, per-sample scales) with
    each tensor from ``make(shape, dtype)``."""
    out = {}
    for nm, (k, n, per_token) in _linear_dims(cfg).items():
        rows = batch * cfg.n_tokens if per_token else batch
        out[nm] = dict(w_qk=make((n, k), torch.int8), w_scale=make((n,), torch.float32),
                       bias=make((n,), torch.float32),
                       x_scale=make((rows, 1), torch.float32))
    bh = batch * cfg.n_heads
    for nm in _layer_names(cfg)[1]:
        out[nm] = dict(a_scale=make((bh, 1, 1), torch.float32),
                       b_scale=make((bh, 1, 1), torch.float32))
    return out


def abstract_inputs(cfg, batch: int):
    """Fake ``(dparams, mparams, latents, t, labels)`` for one step on
    ``op_analysis.fake_device()`` — call it inside ``op_analysis.fake_mode()``.
    The model params are initialized on ``meta`` (no weight exists); t is
    int32 as the samplers make it, the labels int64."""
    from ..launch.steps import _MetaGenerator  # initializers that allocate nothing

    dev = op_analysis.fake_device()
    mparams = op_analysis.fake_like(dit_mod.init(_MetaGenerator(), cfg, device="meta"), dev)
    dparams = _ditto_params(cfg, batch,
                            lambda shape, dt: torch.empty(shape, dtype=dt, device=dev))
    lat = torch.empty((batch, cfg.input_size, cfg.input_size, cfg.in_channels),
                      dtype=torch.float32, device=dev)
    t = torch.empty((batch,), dtype=torch.int32, device=dev)
    labels = torch.empty((batch,), dtype=torch.int64, device=dev) if cfg.n_classes else None
    return dparams, mparams, lat, t, labels


def abstract_state(cfg, batch: int) -> dict:
    """The temporal state's shapes from one abstract step: under all-``act``
    modes with ``collect_stats=False`` the step never READS its state, so
    an empty-dict state runs and the state it returns has every field's
    shape (the engine writes every field regardless of mode); returned as
    fresh contiguous fakes (a layout the step's dispatch does not depend
    on). Call it inside ``op_analysis.fake_mode()``."""
    dparams, mparams, lat, t, labels = abstract_inputs(cfg, batch)
    modes = uniform_modes(cfg, "act")
    step = dit_runner.make_step_fn(cfg, modes, DittoPlan(collect_stats=False))
    _, state, _ = step(dparams, mparams, {nm: {} for nm in modes}, lat, t, labels)
    return op_analysis.fake_like(state)


def record_step(cfg, modes: dict[str, str], plan, args) -> StepRecorder:
    """Run the in-place step of ``(cfg, modes, plan)`` — the one the runner
    cache captures — once on ``args = (dparams, mparams, state, latents, t,
    labels)`` under a :class:`StepRecorder`, and return it."""
    step = dit_runner.make_step_fn(cfg, modes, plan, inplace=True)
    rec = StepRecorder()
    with rec:
        step(*args)
    return rec


def trace_step(cfg, modes: dict[str, str], plan, batch: int, state) -> StepRecorder:
    """The :class:`StepRecorder` of one step of (cfg, modes, plan) at bucket
    ``batch`` on fake tensors: zero FLOPs, zero launches. ``plan`` is
    refused first as on the card (``check_device_block``); ``state`` (from
    :func:`abstract_state`) must be fake, and the call must sit in the
    ``op_analysis.fake_mode()`` that made it."""
    check_device_block(plan, op_analysis.fake_device())
    dparams, mparams, lat, t, labels = abstract_inputs(cfg, batch)
    args = (dparams, mparams, state, lat, t, labels)
    real = [x for x in tree_leaves(args) if isinstance(x, torch.Tensor) and not common.is_fake(x)]
    if real:
        raise ValueError("trace_step: the step's arguments must be fake tensors; call it "
                         "inside the op_analysis.fake_mode() that made the state")
    return record_step(cfg, modes, plan, args)


def trace_fingerprint(cfg, modes: dict[str, str], plan, batch: int, state=None) -> str:
    """Fingerprint of :func:`trace_step`; with no ``state`` it runs in a
    fake mode of its own."""
    if state is None:
        with op_analysis.fake_mode():
            return trace_fingerprint(cfg, modes, plan, batch, abstract_state(cfg, batch))
    return trace_step(cfg, modes, plan, batch, state).fingerprint()


def dispatch_fingerprint(plan, batch: int, step_fp) -> str:
    """Fingerprint of one dispatch of ``plan`` over ``batch`` rows: the
    step's own (``step_fp(rows, lo, hi)`` for rows ``[lo, hi)``) where the
    port runs it unsplit — no mesh, a width of one, or a width that does
    not divide the batch — else each row group's position, rows and step
    fingerprint at its bucket (``batch_sharding``, as ``SplitDittoDiT``
    splits it)."""
    msig = plan.mesh_sig()
    if msig is None or msig[0] < 2 or batch % msig[0]:
        return step_fp(batch, 0, batch)
    return _hash([(i, lo, hi, step_fp(hi - lo, lo, hi))
                  for i, (lo, hi) in enumerate(batch_sharding(msig, batch))])


# ----------------------------------------------------------- the CPU leg
def cpu_inputs(cfg, batch: int, seed: int = 0):
    """Real CPU ``(dparams, mparams, state, latents, t, labels)`` for one
    step, from ``seed``: random int8 weights, positive scales, the model
    params of ``nn/dit.py:init`` and the state of one real all-``act`` step."""
    g = torch.Generator().manual_seed(seed)

    def make(shape, dt):
        if dt == torch.int8:
            return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        return torch.rand(shape, generator=g) * 0.02 + 0.001

    mparams = dit_mod.init(g, cfg, device="cpu")
    dparams = _ditto_params(cfg, batch, make)
    lat = torch.randn((batch, cfg.input_size, cfg.input_size, cfg.in_channels), generator=g)
    t = torch.full((batch,), 500, dtype=torch.int32)
    labels = torch.arange(batch) % cfg.n_classes if cfg.n_classes else None
    modes = uniform_modes(cfg, "act")
    step = dit_runner.make_step_fn(cfg, modes, DittoPlan(collect_stats=False))
    _, state, _ = step(dparams, mparams, {nm: {} for nm in modes}, lat, t, labels)
    state = {nm: {k: v.contiguous() for k, v in st.items()} for nm, st in state.items()}
    return dparams, mparams, state, lat, t, labels


def _rows(args, lo: int, hi: int, batch: int):
    """Rows ``[lo, hi)`` of every per-row tensor of a step's arguments (the
    per-sample scales, the state, the inputs); the weights and model params
    are shared by every row group."""
    def rows(a):
        if a is None:
            return None
        per = a.shape[0] // batch
        return a[lo * per:hi * per]

    dparams, mparams, state, lat, t, labels = args
    dp = {nm: {k: rows(v) if k in ("x_scale", "a_scale", "b_scale") else v
               for k, v in p.items()} for nm, p in dparams.items()}
    st = {nm: {k: rows(v) for k, v in s.items()} for nm, s in state.items()}
    return dp, mparams, st, rows(lat), rows(t), rows(labels)


def cpu_fingerprint(cfg, modes: dict[str, str], plan, args) -> str:
    """Dispatch fingerprint of ``plan`` on real CPU tensors ``args`` (from
    :func:`cpu_inputs`); each step runs on a copy of its rows' state (the
    in-place step writes it), so every plan sees the same data."""
    batch = args[3].shape[0]

    def step_fp(rows, lo, hi):
        part = _rows(args, lo, hi, batch)
        state = {nm: {k: v.clone() for k, v in s.items()} for nm, s in part[2].items()}
        return record_step(cfg, modes, plan, part[:2] + (state,) + part[3:]).fingerprint()

    return dispatch_fingerprint(plan, batch, step_fp)


# ------------------------------------------------------- schedule expansion
def expand_schedule(label: str, schedule, *, normalize: bool = True) -> list:
    """``(label[start:stop), plan)`` audit cases, one per schedule segment.

    The audit's schedule contract is exactly the runtime's: a
    :class:`~repro_torch.core.ditto.PlanSchedule` IS its segment plans (the
    denoise loop partitions by segment and each segment hits the cache as
    a bare plan), so running the sig ⇔ step check over this expansion
    covers schedules with no new machinery. Normalizing first (default)
    audits what actually runs — merged segments appear once; a constant
    schedule expands to exactly its bare plan's case.
    """
    sched = schedule.normalized() if normalize else schedule
    return [(f"{label}[{start}:{stop})", plan)
            for start, stop, plan in sched.segment_plans()]


def default_schedule_matrix() -> list:
    """(label, schedule) variants for the shipped audit: the
    histogram-style int8 -> int4+fused split, a constant schedule (must
    land on the bare plan's sig AND step — no new graph), and a
    redundantly-split spelling that normalization must merge to one
    segment."""
    base = DittoPlan(collect_stats=False, steps=12)
    return [
        ("const", PlanSchedule(base, [(0, 6, {}), (6, 12, {})])),
        ("hist", PlanSchedule(base, [(0, 4, {}),
                                     (4, 12, dict(low_bits=4, fused=True))])),
        ("resplit-lb4", PlanSchedule(base, [(0, 2, dict(low_bits=4)),
                                            (2, 12, dict(low_bits=4))])),
    ]


# ------------------------------------------------------- recovery coverage
def audit_recovery_sigs(plans, audited_sigs, *, group: str = "recovery"
                        ) -> list[Finding]:
    """Prove the failure paths never mint surprise graphs: every rung of a
    plan's degradation ladder (``fallback_plans()``) and every watchdog
    plan's canonical re-anchor step (``fused=False``, default ``low_bits``
    — what ``make_denoise_fn`` actually builds) must resolve to a
    ``cache_sig()`` the audit matrix already fingerprinted."""
    findings: list[Finding] = []
    for label, plan in plans:
        rungs = plan.fallback_plans() if hasattr(plan, "fallback_plans") else ()
        for i, rung in enumerate(rungs):
            if rung.cache_sig() not in audited_sigs:
                findings.append(Finding(
                    "fallback-unaudited", PLAN_PATH, f"{group}:{label}#rung{i}",
                    f"[{group}] plan '{label}' fallback rung {i} resolves to "
                    f"cache_sig()={rung.cache_sig()} which no audit group "
                    f"fingerprinted — a failed dispatch would recover onto an "
                    f"unaudited step; add the sig to the plan matrix"))
        if getattr(plan, "watchdog", False):
            # a schedule re-anchors off whichever segment plan is live, so
            # every segment contributes a candidate re-anchor sig
            seg_plans = ([p for _, _, p in plan.segment_plans()]
                         if hasattr(plan, "segment_plans") else [plan])
            rsigs = {p.replace(fused=False, low_bits=DEFAULT_LOW_BITS).cache_sig()
                     for p in seg_plans}
            for rsig in sorted(rsigs - set(audited_sigs), key=repr):
                findings.append(Finding(
                    "reanchor-unaudited", PLAN_PATH, f"{group}:{label}#reanchor",
                    f"[{group}] plan '{label}' re-anchors onto "
                    f"cache_sig()={rsig} which no audit group fingerprinted — "
                    f"the watchdog's full-bit-width step would run an "
                    f"unaudited step; add the sig to the plan matrix"))
    return findings


def default_recovery_matrix():
    """(label, plan) recovery representatives: the production-shaped
    ladders whose rungs / re-anchor sigs the audit must have covered —
    the kernel-family ladder (fused -> unfused -> int8 -> eager) in both
    stats flavors, a scheduled base and a mesh-stamped ladder."""
    base = DittoPlan(collect_stats=False)
    ladder = (dict(fused=False), dict(fused=False, low_bits=8), dict(compiled=False))
    serving = base.replace(low_bits=4, fused=True, watchdog=True, max_retries=3,
                           retry_backoff_ms=25.0, fallbacks=ladder)
    stats_serving = DittoPlan(fused=True, watchdog=True, max_retries=3,
                              retry_backoff_ms=25.0, reanchor_full_frac=0.97,
                              fallbacks=(dict(fused=False),))
    sched = PlanSchedule(serving.replace(steps=12),
                         [(0, 4, dict(fused=False, low_bits=8)), (4, 12, {})])
    # rungs inherit the mesh fields via replace, so every recovery dispatch
    # (and the watchdog re-anchor) stays on the shard's devices
    mesh_serving = serving.replace(mesh_devices=2)
    return [("serving-ladder", serving),
            ("stats-serving-ladder", stats_serving),
            ("scheduled-ladder", sched),
            ("mesh-serving-ladder", mesh_serving)]


# ----------------------------------------------------------- default matrix
def _tiny_cfgs():
    """Audit configs: a minimal DiT plus a scaled-down echo of DiT-XL/2's
    geometry (patch 2, 4 latent channels, mlp_ratio 4, class-conditional)
    — same code paths, trace-sized shapes."""
    tiny = dit_mod.DiTCfg(d_model=16, n_layers=1, n_heads=2, patch=2,
                          in_channels=2, input_size=4, n_classes=2)
    xl2_echo = dit_mod.DiTCfg(d_model=32, n_layers=2, n_heads=4, patch=2,
                              in_channels=4, input_size=8, n_classes=10)
    return [("tiny", tiny), ("xl2-echo", xl2_echo)]


def default_plan_matrix():
    """(label, plan) variants spanning every cache_sig field plus every
    deliberately-absent field (the equal-sig probes): the reference's
    matrix less ``interpret-explicit``, which has no port field."""
    base = DittoPlan(collect_stats=False)
    return [
        # equal-sig probes: must all share one step with `base`
        ("base", base),
        ("steps-40", base.replace(steps=40)),
        ("sampler-plms", base.replace(sampler="plms")),
        ("policy-diff", base.replace(policy="diff")),
        ("max-batch-8", base.replace(max_batch=8)),
        ("deadline-250", base.replace(deadline_ms=250.0)),
        ("eager", base.replace(compiled=False)),
        ("watchdog", base.replace(watchdog=True)),
        ("retry-ladder", base.replace(
            max_retries=2, retry_backoff_ms=5.0,
            fallbacks=(dict(low_bits=4), dict(compiled=False)))),
        # distinct-sig probes: each must select a distinct step
        ("stats", base.replace(collect_stats=True)),
        # recovery knobs on top of stats: sig must STAY the stats sig
        ("watchdog-reanchor", base.replace(
            collect_stats=True, watchdog=True, reanchor_full_frac=0.9)),
        ("low-bits-4", base.replace(low_bits=4)),
        ("fused", base.replace(fused=True)),
        ("fused-low-bits-4", base.replace(fused=True, low_bits=4)),  # allowlisted vs fused
        ("block-256", base.replace(block=256)),  # refused off the CPU; the CPU leg audits it
        # mesh probes: a dispatch's row groups (dispatch_fingerprint)
        ("mesh-dp2", base.replace(mesh_devices=2)),
        ("mesh-dp2-deadline", base.replace(mesh_devices=2, deadline_ms=250.0)),
        ("mesh-dp4", base.replace(mesh_devices=4)),  # does not divide bucket 2: unsplit
        ("mesh-axis-x", base.replace(mesh_devices=2, mesh_axis="x")),
        # the mesh flavors of the serving ladder's rung sigs (the recovery
        # audit requires them fingerprinted)
        ("mesh-dp2-low-bits-4", base.replace(mesh_devices=2, low_bits=4)),
        ("mesh-dp2-fused-lb4", base.replace(mesh_devices=2, fused=True, low_bits=4)),
    ]


def run_trace_audit(log=None) -> list[Finding]:
    """The shipped audit matrix on the fake device (a few seconds on the
    CPU), plus the CPU leg.

    Full plan matrix on (tiny, all-diff, bucket 2) — the group where every
    knob is live — plus the schedule matrix expanded to segments in the
    same geometry; equal-sig stale probes on a second bucket, a second cfg
    and an all-act group (dup checking off there, see module docstring);
    the recovery ladders; and the whole tiny matrix again on real CPU
    tensors, where ``block-256`` runs. Fingerprints are memoized per (cfg,
    mode, bucket, plan) and leg.
    """
    say = log or (lambda *_: None)
    findings: list[Finding] = []
    cfgs = dict(_tiny_cfgs())
    fps: dict = {}
    audited_sigs: set = set()
    dev = op_analysis.fake_device()

    with op_analysis.fake_mode():
        states: dict = {}

        def fake_fp(cfg, modes, plan, batch):
            def step_fp(rows, lo, hi):
                key = (id(cfg), rows)
                if key not in states:
                    states[key] = abstract_state(cfg, rows)
                return trace_fingerprint(cfg, modes, plan, rows, states[key])
            return dispatch_fingerprint(plan, batch, step_fp)

        def build(cfg, modes, plans, batch, group):
            cases = []
            mode0 = next(iter(modes.values()))
            for label, plan in plans:
                if plan.block != CARD_BLOCK:
                    try:
                        check_device_block(plan, dev)
                    except ValueError:
                        say(f"  refused {group}:{label} on {dev} (block={plan.block})")
                        continue
                    findings.append(Finding(
                        "block-unrefused", PLAN_PATH, f"{group}:{label}",
                        f"[{group}] plan '{label}' (block={plan.block}) is not refused "
                        f"on {dev}: the kernels tile by {CARD_BLOCK}, so its step would "
                        f"fail inside a launch instead of before any step"))
                    continue
                memo = ("fake", id(cfg), mode0, batch, plan)
                fp = fps.get(memo)
                if fp is None:
                    fp = fps[memo] = fake_fp(cfg, modes, plan, batch)
                say(f"  traced {group}:{label} sig={plan.cache_sig()} fp={fp}")
                audited_sigs.add(plan.cache_sig())
                cases.append(TraceCase(label, plan.cache_sig(), fp, plan, batch))
            return cases

        plans = default_plan_matrix()
        tiny = cfgs["tiny"]
        diff = uniform_modes(tiny, "diff")
        say(f"group tiny/diff/b2: full plan matrix, both directions ({dev})")
        findings += audit_cases(build(tiny, diff, plans, 2, "tiny/diff/b2"),
                                group="tiny/diff/b2")

        # schedules audit as their segment expansion, against the bare base
        # plan in the same group: a constant schedule's one segment must share
        # the base's sig AND step, multi-segment schedules must split exactly
        # at their distinct sigs
        sched_cases = [("base", DittoPlan(collect_stats=False))]
        for label, schedule in default_schedule_matrix():
            sched_cases += expand_schedule(label, schedule)
        say("group tiny/diff/b2/sched: schedule segment expansion, both directions")
        findings += audit_cases(build(tiny, diff, sched_cases, 2, "tiny/diff/b2/sched"),
                                group="tiny/diff/b2/sched")

        stale_probes = [p for p in plans if p[0] in ("base", "steps-40", "watchdog", "stats")]
        say("group tiny/act/b2: stale direction only (diff knobs inert under act)")
        findings += audit_cases(
            build(tiny, uniform_modes(tiny, "act"), stale_probes, 2, "tiny/act/b2"),
            group="tiny/act/b2", check_dup=False)

        say("group tiny/diff/b4: stale probes at a second bucket")
        findings += audit_cases(build(tiny, diff, stale_probes, 4, "tiny/diff/b4"),
                                group="tiny/diff/b4", check_dup=False)

        echo = cfgs["xl2-echo"]
        echo_probes = [p for p in plans if p[0] in ("base", "steps-40", "fused")]
        say("group xl2-echo/diff/b2: DiT-XL/2-geometry spot check")
        findings += audit_cases(
            build(echo, uniform_modes(echo, "diff"), echo_probes, 2, "xl2-echo/diff/b2"),
            group="xl2-echo/diff/b2")

    say("group tiny/diff/b2/cpu: the whole matrix on real CPU tensors (block-256 runs here)")
    args = cpu_inputs(tiny, 2)
    cpu_cases = []
    for label, plan in plans:
        fp = cpu_fingerprint(tiny, diff, plan, args)
        say(f"  ran {label} sig={plan.cache_sig()} fp={fp}")
        audited_sigs.add(plan.cache_sig())
        cpu_cases.append(TraceCase(label, plan.cache_sig(), fp, plan, 2))
    findings += audit_cases(cpu_cases, group="tiny/diff/b2/cpu")

    say("group recovery: ladder rungs / re-anchor sigs ⊆ audited sigs")
    findings += audit_recovery_sigs(default_recovery_matrix(), audited_sigs)
    return findings
