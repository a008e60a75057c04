"""Op-level step analyzer: the FLOPs, HBM bytes, peak memory and collectives
of one step, counted from the aten ops it dispatches.

Counterpart of ``src/repro/launch/hlo_analysis.py``. The reference compiles
an XLA program and parses its HLO. The port has no compiler between a step
and the card: the step *is* the sequence of aten ops it dispatches. So
:func:`analyze` runs the step once under a ``TorchDispatchMode`` and
counts what it dispatches. By default the step runs on fake CUDA tensors
(``FakeTensorMode``, :func:`fake_mode` / :func:`fake_like`; on ``meta``
where no card is visible, :func:`fake_device`): the port takes its card
branches, and nothing is allocated or computed, at full width, on a
machine with no card. On real tensors the same counts come from the same
ops.

  * ``flops``: the matmul-like ops (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``convolution`` with ``groups`` and its backward, the
    attention ops of ``torch.utils.flop_counter``, ``_int_mm``), with the
    formulas of ``torch.utils.flop_counter``; ``flops_by_dtype`` splits
    them by the first operand's dtype. Eager PyTorch dispatches every loop
    iteration, so Python loops and ``nn/core.py:segmented_scan`` count as
    they run: no trip-count multiplier.
  * ``hbm_bytes``: the operand plus result bytes of each op, the
    reference's convention (each op is its own pass over memory: eager
    PyTorch fuses nothing). Views and metadata ops count 0, as the
    reference's ``_NO_TRAFFIC``; so does an allocation (``empty``), which
    writes nothing. Departure from the reference: where the port writes in
    place and the reference copies functionally (``copy_`` into a view,
    ``index_copy_``, ``index_put_``, ``scatter_``), the op counts what it
    reads and what it writes, not the whole buffer (the decode writes its
    cache in place; the reference's update slice reads and writes all of
    it).
  * ``peak_bytes``: live storage bytes. The arguments' storages are live
    from the start; each new storage an op returns is added, and taken off
    when it is freed (a weakref on the storage). Split as the reference's
    ``memory_analysis``: ``argument_bytes``, ``output_bytes`` (new storages
    the step returns), ``alias_bytes`` (returned argument storages),
    ``temp_bytes`` (the rest of the peak).
  * ``coll_by_op`` / ``collectives``: the ``_c10d_functional`` ops from the
    dispatch, and the in-place ``torch.distributed`` calls
    (``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single``) through wrappers installed for the analysis
    only: whether their ``c10d`` op reaches a dispatch mode depends on the
    backend and the version, so the wrapper counts the call and the mode
    skips the ``c10d`` ops inside it. A record holds the op, the
    group size and its ranks, the result bytes, the wire bytes (``roofline.py``'s ring
    factors) and the bandwidth of the link the group crosses.
  * ``kernels``: the hand-written kernels, which the dispatch cannot see
    (``int8_matmul`` reaches its kernel through ``ctypes``). A wrapper
    reports its work through ``kernels/common.py:record_work``, which the
    analysis installs; on fake and meta tensors the wrapper returns an
    empty result of the output's shape instead of launching.
"""
from __future__ import annotations

import contextlib
import inspect
import math
import weakref
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

from ..kernels import common
from .roofline import _DTYPE_BYTES, _wire_factor, ranks_bandwidth

aten = torch.ops.aten

# allocations and metadata: no traffic (views are found by their schema,
# metadata queries by their namespace, ``prim``)
_NO_TRAFFIC = {
    aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty, aten.new_empty_strided,
    aten._unsafe_view, aten._reshape_alias, aten.lift_fresh, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size, aten.resize_,
}
_FUNCTIONAL_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# the in-place torch.distributed calls and the argument each writes its result to
_DIST_CALLS = {
    "all_reduce": ("all-reduce", "tensor"),
    "all_gather_into_tensor": ("all-gather", "output_tensor"),
    "reduce_scatter_tensor": ("reduce-scatter", "output"),
    "all_to_all_single": ("all-to-all", "output"),
}


def nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` views: not its whole storage,
    and a broadcast (stride 0) dim once."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st) * _DTYPE_BYTES[t.dtype] \
        if t.numel() else 0


def _tensors(tree) -> list[torch.Tensor]:
    """The tensor leaves of ``tree``, a DTensor as the block this rank holds."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _int_mm_flop(a, b, **kwargs) -> int:
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _inplace_bytes(packet, args, kwargs) -> int | None:
    """What an in-place write reads and writes, or None for the general rule."""
    if packet is aten.copy_:  # read src, write the destination view
        return nbytes(args[1]) + nbytes(args[0])
    if packet is aten.index_copy_:  # (self, dim, index, source)
        return nbytes(args[2]) + 2 * nbytes(args[3])
    if packet is aten.scatter_:  # (self, dim, index, src | value)
        self, index = args[0], args[2]
        written = index.numel() * _DTYPE_BYTES[self.dtype]
        src = args[3] if len(args) > 3 else kwargs.get("src", kwargs.get("value"))
        return nbytes(index) + written * (2 if isinstance(src, torch.Tensor) else 1)
    if packet is aten.index_put_:  # (self, indices, values, accumulate)
        self, indices = args[0], args[1]
        idx = [i for i in indices if i is not None]
        bshape = torch.broadcast_shapes(*(i.shape for i in idx)) if idx else ()
        rest = [self.shape[d] for d in range(len(indices), self.dim())]
        rest += [self.shape[d] for d, i in enumerate(indices) if i is None]
        written = (torch.Size(bshape).numel() * torch.Size(rest).numel()
                   * _DTYPE_BYTES[self.dtype])
        accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        return (sum(nbytes(i) for i in idx) + nbytes(args[2])
                + written * (2 if accumulate else 1))
    return None


class _Counter(TorchDispatchMode):
    """The dispatch mode :func:`analyze` runs a step under."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: dict[torch.dtype, float] = {}
        self.hbm_bytes = 0.0
        self.collectives: list[dict] = []
        self.kernels: dict[str, dict] = {}
        self.by_op: dict[str, list] = {}  # op -> [calls, flops, bytes]
        self.in_dist_call = False  # a wrapped torch.distributed call counts itself
        # a step over DTensors: DTensor runs each op on the rank's blocks (which
        # this mode counts) after propagating its layouts on fake tensors of
        # the whole shapes (which it does not)
        self.per_rank = False
        self.live = self.peak = 0
        self._storages: dict[int, tuple[weakref.ref, int]] = {}

    # ---------------------------------------------------------------- memory
    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live if it is new; returns its bytes if
        it was new, else 0."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages and self._storages[key][0]() is st:
            return 0
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            if self._storages.get(key, (None,))[0] is _ref:
                del self._storages[key]
                self.live -= n

        self._storages[key] = (weakref.ref(st, freed), n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    # ------------------------------------------------------------- recording
    def add_flops(self, dtype: torch.dtype, flops: float) -> None:
        self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + flops

    def add_collective(self, op: str, result_bytes: int, ranks: list[int]) -> None:
        n = len(ranks)
        self.collectives.append({
            "op": op, "result_bytes": result_bytes, "group_size": n, "ranks": list(ranks),
            "wire_bytes": result_bytes * _wire_factor(op, n),
            "bandwidth": ranks_bandwidth(ranks)})

    def record_kernel(self, name: str, *, flops: float, nbytes: float,
                      dtype: torch.dtype) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.add_flops(dtype, flops)
        self.hbm_bytes += nbytes

    # -------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor dispatches the blocks' ops, which come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.in_dist_call and func.namespace == "c10d":
            return out
        if self.per_rank and any(isinstance(t, FakeTensor) for t in tree_leaves((args, out))):
            return out  # DTensor's layout propagation
        packet = func.overloadpacket
        row = self.by_op.setdefault(packet.__name__, [0, 0.0, 0.0])
        row[0] += 1
        if packet in flop_registry or packet is aten._int_mm:
            formula = _int_mm_flop if packet is aten._int_mm else flop_registry[packet]
            flops = float(formula(*args, **kwargs, out_val=out))
            self.add_flops(_tensors(args)[0].dtype, flops)
            row[1] += flops
        if func.namespace == "_c10d_functional" and packet.__name__ in _FUNCTIONAL_COLLECTIVES:
            group = dist.distributed_c10d._resolve_process_group(args[-1])
            self.add_collective(_FUNCTIONAL_COLLECTIVES[packet.__name__], nbytes(out),
                                dist.get_process_group_ranks(group))
        if not (func.is_view or packet in _NO_TRAFFIC or func.namespace == "prim"):
            moved = _inplace_bytes(packet, args, kwargs)
            if moved is None:
                moved = (sum(nbytes(t) for t in _tensors((args, kwargs)))
                         + sum(nbytes(t) for t in _tensors(out)))
            self.hbm_bytes += moved
            row[2] += moved
        for t in _tensors(out):
            self.track(t)
        return out


@contextlib.contextmanager
def _counting_dist_calls(counter: _Counter):
    """Wrap the in-place ``torch.distributed`` collectives for the block."""
    saved = {name: getattr(dist, name) for name in _DIST_CALLS}

    def wrap(name, orig):
        op, result_arg = _DIST_CALLS[name]
        sig = inspect.signature(orig)

        def counted(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            group = bound.arguments.get("group")
            result = bound.arguments[result_arg]
            ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
            counter.add_collective(op, nbytes(result), ranks)
            # the inputs read, the result written (an all-reduce reads it too)
            inputs = [t for k, t in bound.arguments.items()
                      if isinstance(t, torch.Tensor) and (k != result_arg or op == "all-reduce")]
            moved = sum(nbytes(t) for t in inputs) + nbytes(result)
            counter.hbm_bytes += moved
            row = counter.by_op.setdefault(f"dist.{name}", [0, 0.0, 0.0])
            row[0] += 1
            row[2] += moved
            counter.in_dist_call = True
            try:
                return orig(*args, **kwargs)
            finally:
                counter.in_dist_call = False

        return counted

    for name, orig in saved.items():
        setattr(dist, name, wrap(name, orig))
    try:
        yield
    finally:
        for name, orig in saved.items():
            setattr(dist, name, orig)


def fake_mode():
    """The mode fake arguments are made and analyzed in: enter it, make the
    step's arguments with :func:`fake_like` inside it, and analyze there. A
    ``FakeTensorMode`` for fake CUDA tensors; none for ``meta`` ones, which
    hold no data already (and dispatch twice as fast without it)."""
    return FakeTensorMode() if fake_device() == "cuda" else contextlib.nullcontext()


def fake_device() -> str:
    """The device of the fake tensors: ``cuda`` where a card is visible,
    else ``meta``. A CPU-only build cannot index a fake CUDA tensor from
    Python (``t[..., None]`` asks for CUDA's device guard, which it does
    not link). The port's code tells only the CPU from the rest, so both
    take its card branches."""
    return "cuda" if torch.cuda.is_available() else "meta"


def fake_like(tree, device=None):
    """``tree`` with each tensor leaf replaced by an uninitialized tensor of
    its shape and dtype on ``device`` (default :func:`fake_device`):
    inside :func:`fake_mode`, a fake tensor (no memory)."""
    device = device or fake_device()
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)
                    if isinstance(t, torch.Tensor) else t, tree)


def analyze(fn: Callable, *args, **kwargs) -> dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under the counting mode and return
    the reference's ``analyze`` keys (``flops``, ``hbm_bytes``,
    ``wire_bytes``, ``coll_by_op``) with ``flops_by_dtype``, the memory
    split (``argument_bytes``, ``output_bytes``, ``alias_bytes``,
    ``temp_bytes``, ``peak_bytes``), the collective records, the kernels'
    recorded work and ``out``, the step's result. The arguments may be
    fake tensors (call it inside the :func:`fake_mode` that made them) or
    real ones. A step over DTensors is counted for one rank: the ops on its
    blocks, its collectives, its blocks' bytes (the arguments' blocks on
    ``meta``, with no ``FakeTensorMode``: DTensor propagates layouts on
    fake tensors of its own, which the count leaves out)."""
    counter = _Counter()
    counter.per_rank = any(isinstance(t, DTensor) for t in tree_leaves((args, kwargs)))
    args_bytes = sum(counter.track(t) for t in _tensors((args, kwargs)))
    with counter, _counting_dist_calls(counter), common.recording(counter.record_kernel):
        out = fn(*args, **kwargs)
    outs = {id(t.untyped_storage()): t for t in _tensors(out)}
    arg_ids = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
    alias = sum(t.untyped_storage().nbytes() for k, t in outs.items() if k in arg_ids)
    output = sum(t.untyped_storage().nbytes() for k, t in outs.items() if k not in arg_ids)
    coll_by_op: dict[str, dict] = {}
    for r in counter.collectives:
        d = coll_by_op.setdefault(r["op"], {"count": 0, "wire_bytes": 0.0})
        d["count"] += 1
        d["wire_bytes"] += r["wire_bytes"]
    return {
        "flops": sum(counter.flops_by_dtype.values()),
        "hbm_bytes": counter.hbm_bytes,
        "wire_bytes": sum(r["wire_bytes"] for r in counter.collectives),
        "coll_by_op": coll_by_op,
        "flops_by_dtype": dict(counter.flops_by_dtype),
        "collectives": counter.collectives,
        "kernels": counter.kernels,
        "by_op": counter.by_op,
        "argument_bytes": args_bytes,
        "output_bytes": output,
        "alias_bytes": alias,
        "temp_bytes": max(counter.peak - args_bytes - output, 0),
        "peak_bytes": counter.peak,
        "out": out,
    }
