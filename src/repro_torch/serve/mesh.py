"""ServeMesh: the serving stack over several devices.

Mirror of ``src/repro/serve/mesh.py``. A :class:`ServeMesh` carves
``n_devices`` devices into ``n_shards = n_devices // dp`` shards of ``dp``
devices each and hands the mesh-aware
:class:`~repro_torch.serve.scheduler.ServeScheduler` one dispatch lane per
shard (per-shard queues, cross-shard work stealing).

Identity and placement stay apart, as in the reference:

  * ``(dp, axis)`` — :meth:`ServeMesh.signature` — is runner identity. It
    is stamped onto every dispatched plan (``DittoPlan.mesh_devices`` /
    ``mesh_axis``, the ``MESH_SIG_FIELDS``) and ends ``cache_sig()``, so a
    sharded and an unsharded runner never share a CUDA graph.
  * Which devices a shard owns is placement: :meth:`ServeMesh.shard_devices`
    and the row split of :meth:`ServeMesh.row_split` (the port's
    counterparts of the reference's ``shard_mesh`` / ``sharding`` /
    ``replicated``, which build ``jax.sharding`` objects). A dispatch of a
    ``dp``-device shard runs its compiled steps one row group a device
    (``sim.harness.serve_records(mesh=)``).

One divergence, on purpose: every device of every shard has a
:class:`~repro_torch.serve.cache.CompiledRunnerCache` of its own. The
reference shares one cache because a jaxpr has no address; a CUDA graph
and its arena are bound to one device's addresses and serve one sample at
a time, so a shared cache would run the shards one after another.

The steal and queue knobs (:data:`MESH_POLICY_FIELDS`) shape how work
reaches a shard, never what a step launches, so they stay out of
``cache_sig()``.

Testable without several cards: ``devices`` may name one device more than
once — ``(torch.device("cuda:0"),) * 2``, or ``(torch.device("cpu"),) *
4`` — the port's counterpart of XLA's forced host devices, which carve one
host into N logical devices. The reference's ``force_host_device_count``
(it sets ``XLA_FLAGS`` before JAX starts) has no meaning in PyTorch and
is not ported. ``devices=()`` means the first ``n_devices`` cards; when
fewer are visible the mesh raises: it never repeats a device, drops to the
CPU or shrinks to fewer shards on its own.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.ditto.plan import DittoPlan, PlanSchedule
from ..distributed.sharding import batch_sharding, constrain_batch

__all__ = ["DEFAULT_AXIS", "MESH_POLICY_FIELDS", "ServeMesh", "batch_sharding",
           "place_dispatch", "resolve_mesh"]

DEFAULT_AXIS = "data"

#: ServeMesh queue/steal policy knobs. None of them changes what a compiled
#: step launches, so none may appear in ``DittoPlan.cache_sig()`` (or in
#: ``MESH_SIG_FIELDS``): two meshes differing only in steal policy share
#: every runner key.
MESH_POLICY_FIELDS = ("steal", "steal_min_rows")


def _default_devices(n: int) -> tuple[torch.device, ...]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(
            f"ServeMesh needs {n} devices but only {have} CUDA device(s) are visible; "
            f"name them with devices=(...), which may repeat one, e.g. "
            f"devices=(torch.device('cuda:0'),) * {n}, or devices=(torch.device('cpu'),) "
            f"* {n} on the CPU")
    return tuple(torch.device("cuda", i) for i in range(n))


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """``n_devices`` devices carved into ``n_devices // dp`` shards.

    ``dp`` is the data-parallel width of ONE dispatch: each shard holds
    ``dp`` consecutive devices of ``devices``, and a bucket dispatched to it
    has its rows split over them. ``dp=1`` (the default) is shard-level
    parallelism only: N devices serve N concurrent single-device lanes;
    ``dp=n_devices`` is one lane whose every dispatch spans the mesh.

    ``steal`` / ``steal_min_rows`` are scheduler policy: an idle shard may
    steal due rows from a sibling that is mid-dispatch once the sibling's
    group holds at least ``steal_min_rows``.

    ``devices``: the concrete ``torch.device`` of each of the ``n_devices``
    (``()`` = ``cuda:0`` .. ``cuda:{n_devices - 1}``, which must exist). A
    device may repeat: two shards on one card, or N logical devices on the
    CPU.
    """

    n_devices: int
    dp: int = 1
    axis: str = DEFAULT_AXIS
    steal: bool = True
    steal_min_rows: int = 1
    devices: tuple = ()

    def __post_init__(self):
        if self.n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {self.n_devices}")
        if self.dp < 1 or self.dp & (self.dp - 1):
            # the stamped plans take dp as mesh_devices, which must be a power of two
            raise ValueError(f"dp must be a power of two >= 1, got {self.dp}")
        if self.n_devices % self.dp:
            raise ValueError(f"n_devices={self.n_devices} must be a multiple of the "
                             f"per-shard width dp={self.dp}")
        if not (isinstance(self.axis, str) and self.axis.isidentifier()):
            raise ValueError(f"axis must be an identifier string, got {self.axis!r}")
        if self.steal_min_rows < 1:
            raise ValueError(f"steal_min_rows must be >= 1, got {self.steal_min_rows}")
        if self.devices:
            devices = tuple(torch.device(d) for d in self.devices)
            devices = tuple(torch.device("cuda", 0) if d.type == "cuda" and d.index is None
                            else d for d in devices)
            if len(devices) < self.n_devices:
                raise ValueError(f"ServeMesh needs {self.n_devices} devices, devices= names "
                                 f"{len(devices)}")
            devices = devices[:self.n_devices]
            cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
            missing = [d for d in devices if d.type == "cuda" and (d.index or 0) >= cards]
            if missing:
                raise ValueError(f"devices= names {missing[0]}, but {cards} CUDA device(s) "
                                 f"are visible")
        else:
            devices = _default_devices(self.n_devices)
        object.__setattr__(self, "devices", devices)

    # ------------------------------------------------------------- identity
    @property
    def n_shards(self) -> int:
        return self.n_devices // self.dp

    def signature(self) -> tuple:
        """``(dp, axis)``: the plan-visible mesh identity. Every shard of
        this mesh shares it (and every runner key); the concrete devices
        stay out."""
        return (self.dp, self.axis)

    def plan_for(self, plan: DittoPlan | PlanSchedule):
        """``plan`` stamped with this mesh's signature (a schedule stamps its
        base; its segments inherit it)."""
        if isinstance(plan, PlanSchedule):
            return plan.replace(base=self.plan_for(plan.base))
        return plan.replace(mesh_devices=self.dp, mesh_axis=self.axis)

    # ------------------------------------------------------------ placement
    def shard_devices(self, shard: int) -> tuple[torch.device, ...]:
        """The ``dp`` devices of shard ``shard``."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard must be in [0, {self.n_shards}), got {shard}")
        return self.devices[shard * self.dp:(shard + 1) * self.dp]

    def row_split(self, batch: int) -> tuple[tuple[int, int], ...]:
        """Each shard device's rows ``[lo, hi)`` of a ``batch``-row dispatch:
        split when ``dp`` divides it, else the whole batch on each
        (replicated, as the reference's divisibility fallback)."""
        return batch_sharding(self.signature(), batch)


def resolve_mesh(plan: DittoPlan | PlanSchedule, devices=None) -> tuple | None:
    """The devices a plan's dispatch is placed on. An unsharded plan: None.
    A sharded one: ``devices`` when they match its width, else the first
    ``mesh_devices`` cards (raising when fewer are visible)."""
    sig = plan.mesh_sig()
    if sig is None:
        return None
    ndev = sig[0]
    if devices is not None and len(devices) == ndev:
        return tuple(torch.device(d) for d in devices)
    return _default_devices(ndev)


def place_dispatch(x, labels, devices, axis: str = DEFAULT_AXIS) -> tuple[tuple, tuple]:
    """The row groups of one dispatch, each moved to its device: ``(xs,
    labels_s)``, one entry a device, split over ``axis`` when the devices
    divide the batch, else the whole batch on each. ``devices=None`` is the
    unsharded dispatch: ``((x,), (labels,))``, untouched."""
    if devices is None:
        return (x,), (labels,)
    sig = (len(devices), axis)
    xs = tuple(g.to(d) for g, d in zip(constrain_batch(x, sig), devices))
    if labels is None:
        return xs, (None,) * len(devices)
    return xs, tuple(g.to(d) for g, d in zip(constrain_batch(labels, sig), devices))
