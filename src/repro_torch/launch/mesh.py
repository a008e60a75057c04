"""Production and test meshes, and the one-rank process group.

Mirror of ``src/repro/launch/mesh.py``. The reference's production mesh is
a ``jax.make_mesh`` over the dry run's 256 or 512 forced host devices. The
port's production mesh is an :class:`AbstractMesh`: the axis names and
sizes that ``distributed/sharding.py:spec_for`` reads, with no devices
behind them, which is all the layouts need. :func:`fake_mesh` makes it a
``DeviceMesh`` of 256 or 512 ranks in one process, over the ``fake``
backend of ``torch.testing._internal.distributed.fake_pg`` (collectives
that move nothing), for the dry run's step over DTensors.
``make_test_mesh`` is a real ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the current process group.

A process group is started by the caller (``torch.distributed`` reads no
cluster from the environment here); :func:`local_group` starts a one-rank
group for the duration of a block when none is up: NCCL on the card, gloo
on the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh with no devices behind it: ``axis_sizes`` over ``axis_names``,
    as ``jax.sharding.AbstractMesh(axis_sizes, axis_names)``."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in mesh order."""
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_test_mesh(n_devices: int | None = None, *, model: int = 1) -> DeviceMesh:
    """A ``(data, model)`` DeviceMesh over the first ``n_devices`` ranks of
    the current process group (default: all of them), on the group's
    device type (``cuda`` under NCCL, else ``cpu``)."""
    n = n_devices or dist.get_world_size()
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def local_group(device=None):
    """A one-rank process group for the block (NCCL on the card, the default;
    gloo for ``device="cpu"``), destroyed on leaving it. If a group is
    already up, the block runs in it and it stays."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_mesh(mesh: AbstractMesh):
    """A ``DeviceMesh`` of ``mesh``'s axes over a process group of that many
    ranks on the ``fake`` backend, this process its rank 0, for the block;
    the group is destroyed on leaving it. Refuses to start while another
    group is up: the fake one would stand in for it."""
    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()} process group is up: the fake "
                           f"{'x'.join(map(str, mesh.axis_sizes))} group starts only alone")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh.axis_sizes))
    try:
        yield init_device_mesh("cpu", mesh.axis_sizes, mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()
