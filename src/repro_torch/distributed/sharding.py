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
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

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


def make_shard_fn(rules: dict, mesh: DeviceMesh | None):
    """fn(tensor, logical_axes) -> the tensor laid out by :func:`spec_for`
    on ``mesh``; the identity for ``mesh=None``."""
    if mesh is None:
        return lambda a, axes: a

    def shard(a, axes):
        return layout(a, Layout(mesh, placements(spec_for(axes, tuple(a.shape), rules, mesh),
                                                 mesh)))

    return shard


def replicated(mesh) -> Layout:
    return Layout(mesh, (Replicate(),) * len(mesh_axes(mesh)))
