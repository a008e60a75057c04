"""The batch split of a sharded dispatch.

Mirror of ``batch_sharding`` and ``constrain_batch`` of
``src/repro/distributed/sharding.py``; the rest of that module (the
logical-axis rules, ``spec_for``) and ``collectives.py`` / ``pipeline.py``
are still to be ported (ROADMAP.md, queue 1).

The reference lays a dispatch's batch axis over an abstract
``(mesh_axis: mesh_devices)`` mesh as a ``NamedSharding`` and lets XLA
split the step. PyTorch has no sharded tensor to hand the step, so the
port's counterpart is the split itself: which rows each of the ``dp``
devices holds. When ``dp`` divides the batch the rows are split into
``dp`` equal, consecutive groups; when it does not, every device holds the
whole batch (replicated), as the reference's divisibility fallback lays it
out.
"""
from __future__ import annotations

import torch


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
