"""Logical-axis -> mesh layout rules, and the batch split of a mesh dispatch.

Mirror of ``src/repro/distributed/sharding.py``. Every parameter of the
port's models has a tuple of logical axis names (the initializers return
them under ``nn/core.py:tagged``; ``launch/steps.py:param_axes`` collects
them). A rule table maps logical names to mesh axes; :func:`spec_for`
resolves one axes tuple into a partition spec with the reference's two
safety passes:

  * divisibility — a dim that does not divide the mesh-axis product falls
    back to replication (e.g. qwen2-moe's 60 experts on a 16-way model
    axis);
  * no duplicates — a mesh axis may appear once per spec; the leftmost
    logical dim wins (e.g. MoE stacks ('expert', 'embed', 'mlp'): EP takes
    'model', the mlp dim stays unsharded).

The counterparts of the reference's types: a partition spec is a plain
tuple (``None``, an axis name, or a tuple of names for each dim) equal to
``tuple(PartitionSpec(...))``; a mesh is a ``DeviceMesh`` with
``mesh_dim_names``, or ``launch/mesh.py:AbstractMesh`` where no devices
stand behind it; a ``NamedSharding`` is a :class:`Layout`, DTensor
placements over a mesh: ``Shard(d)`` on each mesh dim that the spec names
at tensor dim ``d``, ``Replicate()`` on the rest. Where one tensor dim is
split over several mesh axes (``('pod', 'data')`` under ``multi_pod``),
DTensor splits it over them in mesh-dim order, the first the major, as the
reference's spec does when it names them in that order (the only order
:func:`make_rules` gives); another order is refused.

The batch split (``batch_sharding``, ``constrain_batch``): the reference
lays a dispatch's batch axis over an abstract ``(mesh_axis: mesh_devices)``
mesh and lets XLA split the step. The port's counterpart is the split
itself: which rows each of the ``dp`` devices holds. When ``dp`` divides
the batch the rows are split into ``dp`` equal, consecutive groups; when
it does not, every device holds the whole batch (replicated), as the
reference's divisibility fallback lays it out.

Inside a step (``shard=``, the reference's ``with_sharding_constraint``):
:class:`ShardFn` lays a tensor out by the rules; :func:`replicating`
runs a step's block under ``implicit_replication``; and where DTensor's
own rules fail or cost too much, a region runs on each rank's blocks
under ``local_map`` (:func:`row_local`, :func:`elementwise`), or a split
is gathered first (:func:`unflatten`). :func:`full` allocates a DTensor
block by block (the decode cache in :func:`cache_shardings_dict`'s
layout).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication, local_map

from .. import tree as tr
from ..configs.base import ArchConfig


def batch_sharding(mesh_sig: tuple, batch: int) -> tuple[tuple[int, int], ...]:
    """``((lo, hi), ...)``: the rows ``[lo, hi)`` each of the ``dp`` devices
    of a ``DittoPlan.mesh_sig()`` holds of a batch of ``batch`` rows; split
    when ``dp`` divides ``batch``, else the whole batch on every device."""
    ndev = int(mesh_sig[0])
    if batch % ndev:
        return ((0, batch),) * ndev
    per = batch // ndev
    return tuple((i * per, (i + 1) * per) for i in range(ndev))


def constrain_batch(x: torch.Tensor, mesh_sig: tuple | None) -> tuple[torch.Tensor, ...]:
    """The row groups of ``x`` under :func:`batch_sharding`, as views of
    ``x``; ``mesh_sig=None`` (an unsharded plan) is the one group ``x``."""
    if mesh_sig is None:
        return (x,)
    return tuple(x[lo:hi] for lo, hi in batch_sharding(mesh_sig, x.shape[0]))


def make_rules(arch: ArchConfig, *, multi_pod: bool = False) -> dict[str, Any]:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch_axes,
        "vocab": ("model",),
        "heads": ("model",),
        "kv": ("model",),
        "mlp": ("model",),
        "expert": ("model",),
        "moe_ff": ("data",),  # EP ff-over-data scheme
        "embed": ("data",) if arch.fsdp else None,
        "embed2": None,
        "layer": None,
        "super": None,
        "seq": None,
    }


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size of a DeviceMesh or an AbstractMesh, in mesh order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def spec_for(axes: tuple, shape: tuple, rules: dict, mesh) -> tuple:
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    out = []
    # an axes tag may be shorter than the rank when a stacked dim was added
    # without retagging; left-pad with None (stack dims lead)
    if len(axes) < len(shape):
        axes = (None,) * (len(shape) - len(axes)) + tuple(axes)
    for dim, name in zip(shape, axes):
        rule = rules.get(name) if name else None
        if not rule:
            out.append(None)
            continue
        want = tuple(a for a in rule if a in sizes and a not in used)
        size = math.prod(sizes[a] for a in want) if want else 1
        if want and dim % size == 0:
            out.append(want[0] if len(want) == 1 else want)
            used.update(want)
        else:
            out.append(None)
    return tuple(out)


class Layout(NamedTuple):
    """Where a tensor lives on a mesh: the counterpart of a NamedSharding."""

    mesh: Any
    placements: tuple


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of a partition spec over ``mesh``, one a mesh
    dim."""
    names = list(mesh_axes(mesh))
    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in group]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: {group} splits one dim over mesh axes out of mesh "
                             f"order {tuple(names)}; DTensor splits in mesh order only")
        dim_of.update((a, d) for a in group)
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate() for n in names)


def spec_layout(mesh, spec: tuple) -> Layout:
    """The :class:`Layout` of a partition spec over ``mesh``."""
    return Layout(mesh, placements(spec, mesh))


def batch_axes(mesh, rules: dict) -> tuple:
    """The mesh axes of ``rules``' batch axes that ``mesh`` has."""
    return tuple(a for a in (rules["batch"] or ()) if a in mesh_axes(mesh))


def cache_shardings_dict(arch, mesh, rules, cache_shapes: dict) -> dict[str, Layout]:
    """A :class:`Layout` for each tensor of an LM's decode cache (shapes as
    ``models/lm.py:init_cache`` makes them), as the reference's dry run lays
    it out: the batch dim over the batch axes where it divides them, and
    'model' on the kv heads (else the cache length), the recurrent states'
    heads or width, where it divides."""
    sizes = mesh_axes(mesh)
    batch_axis = batch_axes(mesh, rules)

    def div(n, axis="model"):
        return n % sizes[axis] == 0

    bprod = math.prod(sizes[a] for a in batch_axis)
    b_first = batch_axis[0] if len(batch_axis) == 1 else (batch_axis or None)
    out = {}
    for key, t in cache_shapes.items():
        shp = tuple(t.shape)

        def bat(dim):
            return b_first if (batch_axis and shp[dim] % bprod == 0) else None

        if key in ("k", "v", "a_k", "a_v"):
            if div(shp[3]):
                spec = (None, bat(1), None, "model", None)
            elif div(shp[2]):
                spec = (None, bat(1), "model", None, None)
            else:
                spec = (None, bat(1), None, None, None)
        elif key in ("m_C", "m_n", "m_m"):
            rest = [None] * (len(shp) - 3)
            if len(shp) > 3 and div(shp[3]):
                rest[0] = "model"
            elif len(shp) > 4 and div(shp[4]):
                rest[1] = "model"
            spec = (None, None, bat(2), *rest)
        elif key.startswith("s_"):
            rest = [None] * (len(shp) - 2)
            if div(shp[-1]):
                rest[-1] = "model"
            spec = (None, bat(1), *rest)
        elif key in ("m_h", "m_conv"):
            rest = [None] * (len(shp) - 3)
            if key == "m_h" and div(shp[3]):
                rest[0] = "model"
            if key == "m_conv" and div(shp[4]):
                rest[1] = "model"
            spec = (None, None, bat(2), *rest)
        elif key in ("t_h", "t_conv"):
            rest = [None] * (len(shp) - 2)
            if key == "t_h" and div(shp[2]):
                rest[0] = "model"
            if key == "t_conv" and div(shp[3]):
                rest[1] = "model"
            spec = (None, bat(1), *rest)
        else:  # a_p and friends: replicated
            spec = (None,) * len(shp)
        out[key] = spec_layout(mesh, spec)
    return out


def param_shardings(axes_tree, shape_tree, rules: dict, mesh):
    """A :class:`Layout` tree matching a (split) param tree; ``shape_tree``'s
    leaves have a ``.shape`` (tensors, meta tensors)."""
    axes, shapes = tr.leaves(axes_tree), tr.leaves(shape_tree)
    if len(axes) != len(shapes):
        raise ValueError(f"{len(axes)} axes tags for {len(shapes)} leaves")
    return tr.unflatten_like(shape_tree, [
        Layout(mesh, placements(spec_for(a, tuple(s.shape), rules, mesh), mesh))
        for a, s in zip(axes, shapes)])


def layout_bytes(a: torch.Tensor, lay: Layout) -> int:
    """Bytes one device of ``lay``'s mesh holds of ``a`` (a tensor or a
    meta tensor) laid out on ``lay``."""
    sizes = list(mesh_axes(lay.mesh).values())
    split = math.prod(n for n, p in zip(sizes, lay.placements) if isinstance(p, Shard))
    return a.numel() * a.element_size() // split


def sharded_bytes(axes_tree, shape_tree, rules: dict, mesh) -> int:
    """Parameter bytes one device of ``mesh`` holds under :func:`spec_for`."""
    lays = param_shardings(axes_tree, shape_tree, rules, mesh)
    return sum(layout_bytes(s, lay) for s, lay in zip(tr.leaves(shape_tree), tr.leaves(lays)))


def layout(a: torch.Tensor, lay: Layout) -> DTensor:
    """``a`` laid out on ``lay``: a plain tensor is distributed (the mesh's
    first rank holds the whole value), a DTensor redistributed."""
    if isinstance(a, DTensor):
        return a.redistribute(lay.mesh, lay.placements)
    return distribute_tensor(a, lay.mesh, list(lay.placements))


def reduced(a: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending sums (``Partial`` placements) reduced to
    ``Replicate``; anything else as it is."""
    if isinstance(a, DTensor) and any(p.is_partial() for p in a.placements):
        return a.redistribute(placements=[Replicate() if p.is_partial() else p
                                          for p in a.placements])
    return a


class ShardFn:
    """The reference's ``shard`` inside a step: ``shard(tensor, logical_axes)``
    lays the tensor out by :func:`spec_for` on ``mesh``. A DTensor is
    redistributed; a plain tensor is taken as a value that every rank
    holds (a tensor the step made itself, as a traced value is global in
    the reference) and sliced locally, with no communication. ``mesh`` and
    ``rules`` are kept for the layouts a step allocates in
    (``models/lm.py``'s cache)."""

    def __init__(self, rules: dict, mesh: DeviceMesh):
        self.rules, self.mesh = rules, mesh

    def layout_for(self, shape: tuple, axes: tuple) -> Layout:
        """The layout of :func:`spec_for`, a split over a mesh axis of one
        rank written ``Replicate`` (the same block: DTensor refuses to fold
        a dim of size 1 split over one rank into its neighbour, as a
        product of a decode's single MoE group does)."""
        pl = placements(spec_for(axes, tuple(shape), self.rules, self.mesh), self.mesh)
        return Layout(self.mesh, tuple(Replicate() if n == 1 else p
                                       for n, p in zip(self.mesh.shape, pl)))

    def __call__(self, a: torch.Tensor, axes: tuple) -> DTensor:
        lay = self.layout_for(tuple(a.shape), axes)
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, self.mesh, [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        return layout(a, lay)


def no_shard(a: torch.Tensor, axes: tuple) -> torch.Tensor:
    """The identity ``shard``: a step built without a mesh."""
    return a


def make_shard_fn(rules: dict, mesh: DeviceMesh | None):
    """fn(tensor, logical_axes) -> the tensor laid out by :func:`spec_for`
    on ``mesh`` (a :class:`ShardFn`); :func:`no_shard` for ``mesh=None``."""
    return no_shard if mesh is None else ShardFn(rules, mesh)


def elementwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn`` whose DTensor backward fails
    (``softplus_backward`` labels a block contiguous that follows a
    transposed gradient): on a DTensor, each rank applies it to its own
    block under ``local_map`` (a pending sum reduced first); on a plain
    tensor, ``fn(x)``."""
    if not isinstance(x, DTensor):
        return fn(x)
    x = reduced(x)
    pl = list(x.placements)
    return local_map(fn, out_placements=pl, in_placements=(pl,), device_mesh=x.device_mesh)(x)


def unflatten(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``; on a DTensor whose ``dim`` is split over
    mesh dims that do not divide ``sizes[0]`` (a width split finer than its
    heads: 8 kv heads over 16 ranks), that split gathered first. DTensor
    refuses to unflatten a dim split unevenly; the reference's GSPMD
    reshards there."""
    if isinstance(x, DTensor):
        d, pl, split = dim % x.dim(), list(x.placements), 1
        for i, p in enumerate(pl):
            if p.is_shard(d):
                if sizes[0] % (split * x.device_mesh.size(i)):
                    pl[i] = Replicate()
                else:
                    split *= x.device_mesh.size(i)
        if pl != list(x.placements):
            x = x.redistribute(placements=pl)
    return x.unflatten(dim, sizes)


def row_local(fn, n_out: int, rows: tuple, shared: tuple = ()):
    """``fn(*rows, *shared)``, whose work is local to each row of dim 0 of
    every ``rows`` tensor and of its ``n_out`` results (a batch row, an MoE
    group), ``shared`` the tensors every row reads (weights). On DTensors
    each rank runs it on its rows under ``local_map``: the rows split as the
    first DTensor among ``rows`` splits its dim 0 (gathered over any other
    split), ``shared`` whole, their gradients summed over the row split; a
    plain tensor is taken as replicated. DTensor's own rules inside such a
    region (a recurrence's thousands of small ops, an MoE's sort, scatter
    and gather) cost seconds of layout search, and may split the sequence
    in the backward where a later reshape cannot undo it."""
    args = rows + shared
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    whole = [Replicate()] * mesh.ndim
    lead = next((a for a in rows if isinstance(a, DTensor)), None)
    pl = whole if lead is None else [p if p == Shard(0) else Replicate() for p in lead.placements]
    summed = [Partial() if p == Shard(0) else Replicate() for p in pl]
    args = tuple(a if isinstance(a, DTensor) else
                 DTensor.from_local(a, mesh, whole, run_check=False) for a in args)
    return local_map(fn, out_placements=(pl,) * n_out if n_out > 1 else pl,
                     in_placements=(pl,) * len(rows) + (whole,) * len(shared),
                     in_grad_placements=(pl,) * len(rows) + (summed,) * len(shared),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


_REPLICATING = [0]


@contextlib.contextmanager
def replicating(shard):
    """The block of a step built with ``shard``: where ``shard`` lays tensors
    out on a mesh (a :class:`ShardFn`), under ``implicit_replication``, so
    that a plain tensor the step makes itself (positions, RoPE tables,
    recurrent carries, the loss's scalars) meets the step's DTensors as a
    replicated one, as a traced constant is global in the reference. Else,
    and inside a block already under it, nothing changes. Reentrant, unlike
    ``implicit_replication`` itself, whose exit clears the flag."""
    if getattr(shard, "mesh", None) is None or _REPLICATING[0]:
        yield
        return
    _REPLICATING[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _REPLICATING[0] -= 1


def full(shape: tuple, fill, dtype: torch.dtype, lay: Layout, device) -> DTensor:
    """A DTensor of ``shape`` filled with ``fill``, laid out on ``lay``: each
    rank allocates its own block on ``device`` and nothing else. Every
    sharded dim must divide its mesh axes."""
    local = list(shape)
    for n, p in zip(mesh_axes(lay.mesh).values(), lay.placements):
        if isinstance(p, Shard):
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide {n} ranks")
            local[p.dim] //= n
    return DTensor.from_local(torch.full(local, fill, dtype=dtype, device=device), lay.mesh,
                              list(lay.placements), run_check=False)


def replicated(mesh) -> Layout:
    return Layout(mesh, (Replicate(),) * len(mesh_axes(mesh)))
