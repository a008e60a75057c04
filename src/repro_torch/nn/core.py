"""Minimal functional NN substrate.

Mirror of the parts of ``src/repro/nn/core.py`` that the DiT and the LM
reach (conv and group norm have no caller in the port).
Params are nested dicts of tensors. Every initializer returns plain
tensors, unless it is called inside :func:`tagged`: then each parameter
comes as a :class:`Param`, the tensor tagged with the reference's logical
axis names, and ``split(tree)`` separates the two so that
``distributed/sharding.py`` can map the names to a mesh layout
(``launch/steps.py:param_axes``). Apply functions accept a tagged tree as
well as a plain one — ``val`` normalizes.

Initializers draw from an explicit ``torch.Generator`` and create tensors
on its device.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..tree import map_tree


@dataclasses.dataclass
class Param:
    """A tensor tagged with logical sharding axes (one name or None per dim)."""

    value: torch.Tensor
    axes: tuple[str | None, ...]

    def to(self, *args, **kwargs) -> "Param":
        """``Tensor.to`` on the value; the tag stays."""
        return Param(self.value.to(*args, **kwargs), self.axes)


def val(x: Any) -> torch.Tensor:
    return x.value if isinstance(x, Param) else x


# The logical axes of the stacked leading dims an initializer's ``lead``
# adds: a stack of layers is 'layer', a stack of super-blocks of layers
# ('super', 'layer'), as the reference's stacking retags them.
STACK_AXES = ("super", "layer")
_TAGGING = contextvars.ContextVar("tagging", default=False)


@contextlib.contextmanager
def tagged():
    """Initializers called inside return every parameter as a
    :class:`Param` tagged with the reference's logical axes."""
    token = _TAGGING.set(True)
    try:
        yield
    finally:
        _TAGGING.reset(token)


def tag(value: torch.Tensor, axes: tuple, lead: tuple = ()):
    """A fresh parameter as an initializer returns it: under :func:`tagged`,
    ``Param(value, stack axes of lead + axes)``; else ``value`` itself."""
    if not _TAGGING.get():
        return value
    return Param(value, STACK_AXES[len(STACK_AXES) - len(lead):] + tuple(axes))


def split(tree: Any) -> tuple[Any, Any]:
    """A tree of Params split into (values, logical-axes) trees."""
    return map_tree(val, tree), map_tree(lambda p: p.axes, tree)


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true division in ``x``'s dtype on ``x``'s device.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can differ from the division in the last bit; the
    reference divides. The divisor is made with ``torch.full`` (a fill
    kernel) rather than ``torch.tensor`` (a host-to-device copy, which
    waits for the stream)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


# The initializers scale the float32 draw in place: one float32 temporary
# beside the result, not two (a stacked expert weight's draw is 16.6 GB).
def normal_init(gen: torch.Generator, shape, stddev=0.02, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=gen.device).mul_(stddev).to(dtype)


def lecun_init(gen: torch.Generator, shape, dtype=torch.float32, *, fan_in: int | None = None):
    """N(0, 1/fan_in) with fan_in = shape[-2], the input dim of a (in, out)
    weight (a leading dim is a stack of layers, not a receptive field),
    unless ``fan_in`` is given."""
    fan_in = shape[-2] if fan_in is None else fan_in
    return torch.randn(shape, generator=gen, device=gen.device).div_(
        math.sqrt(max(fan_in, 1))).to(dtype)


def zeros_init(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *, bias: bool = False,
               axes: tuple = (None, None), init: Callable = lecun_init, lead: tuple = (),
               dtype=torch.float32) -> dict:
    """``lead`` stacks that many independent layers on leading dims;
    ``axes`` names the (in, out) dims for :func:`tagged`."""
    p = {"w": tag(init(gen, lead + (in_dim, out_dim), dtype=dtype), axes, lead)}
    if bias:
        p["b"] = tag(torch.zeros(lead + (out_dim,), dtype=dtype, device=gen.device),
                     (axes[1],), lead)
    return p


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


# Rows of one 2-D product block (see ``dense``).
ROW_BLOCK = 16


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    w = val(params["w"]).to(x.dtype)
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        y = matmul_split(x, w)
    else:
        y = _matmul(x, w)
    if "b" in params:
        y = y + val(params["b"]).to(y.dtype)
    return y


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        # A BLAS picks its algorithm, and so its summation order, by the
        # shape: one row takes a matrix-vector path on the CPU and on the
        # card, and cuBLAS sums other row counts in other orders too. A 2-D
        # product (one row a sample: the conditioning products) therefore
        # runs as zero-padded blocks of ROW_BLOCK rows, each its own
        # (ROW_BLOCK, K) @ (K, N) product, so a row gets the same bits
        # whatever number of rows it came with.
        m = x.shape[0]
        blocks = F.pad(x, (0, 0, 0, -m % ROW_BLOCK)).split(ROW_BLOCK)
        return torch.cat([b @ w for b in blocks])[:m]
    return x @ w


def matmul_split(x: torch.Tensor, w: torch.Tensor) -> DTensor:
    """``_matmul`` of DTensors: each rank runs it on its blocks under
    ``local_map``, with the layouts a tensor-parallel product takes on each
    mesh dim: rows of x split (w gathered: an FSDP split), w split on its
    columns (x gathered; the output split on them), or both split on the
    contraction (the output a pending sum); a pending sum in x passes
    through a replicated w. (DTensor's own rules may split a replicated
    operand on any dim, a sequence included, which a later reshape then
    cannot undo.) A plain operand is taken as replicated."""
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    rep = [Replicate()] * mesh.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, rep, run_check=False)
    last = x.dim() - 1
    xp, wp, yp, gxp, gwp = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if a.is_partial() and b.is_shard():
            a = Replicate()  # the pending sum reduced before a split product
        if a.is_shard() and not a.is_shard(last) and b.is_shard():
            b = Replicate()  # rows split: the weight gathered
        if a.is_shard(last) and b.is_shard(1):
            a = Replicate()
        if a == Replicate() and b.is_shard(0):
            a = Shard(last)  # the contraction split alike: a local slice of x
        if a.is_shard(last) and b == Replicate():
            b = Shard(0)
        if a.is_partial():  # x's sum pending, w whole
            y, gx, gw = Partial(), Replicate(), Partial()
        elif a.is_shard(last):  # contraction split
            y, gx, gw = Partial(), a, b
        elif a.is_shard():  # rows split
            y, gx, gw = a, a, Partial()
        elif b.is_shard(1):  # columns split
            y, gx, gw = Shard(last), Partial(), b
        else:
            y = gx = gw = Replicate()
        xp.append(a)
        wp.append(b)
        yp.append(y)
        gxp.append(gx)
        gwp.append(gw)
    return local_map(_matmul, out_placements=yp, in_placements=(xp, wp),
                     in_grad_placements=(gxp, gwp), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


# ---------------------------------------------------------------------------
# Norms (float32 inside, the input's dtype out)
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, *, lead: tuple = (), dtype=torch.float32, device=None) -> dict:
    return {"scale": tag(torch.ones(lead + (dim,), dtype=dtype, device=device), (None,), lead)}


def rmsnorm(params: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * val(params["scale"]).to(torch.float32)).to(dtype)


def layernorm_init(dim: int, *, bias: bool = True, lead: tuple = (), dtype=torch.float32,
                   device=None) -> dict:
    p = {"scale": tag(torch.ones(lead + (dim,), dtype=dtype, device=device), (None,), lead)}
    if bias:
        p["b"] = tag(torch.zeros(lead + (dim,), dtype=dtype, device=device), (None,), lead)
    return p


def layernorm(params: dict, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with the population variance."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps) * val(params["scale"]).to(torch.float32)
    if "b" in params:
        y = y + val(params["b"]).to(torch.float32)
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Segmented (remat) scan — recurrent layers at long sequence length
# ---------------------------------------------------------------------------


def scan(cell: Callable, carry, xs: tuple):
    """A loop over time: ``cell(carry, x_t) -> (carry, y_t)`` for each t,
    the x_t the t-th rows of the time-leading tensors ``xs``; returns
    (carry, the y_t stacked along a new leading dim). Each input is unbound
    once: indexing it a step would make autograd build a zero tensor of
    its whole size for every step's backward."""
    ys = []
    for x_t in zip(*(a.unbind(0) for a in xs)):
        carry, y = cell(carry, x_t)
        ys.append(y)
    return carry, torch.stack(ys)


def segmented_scan(cell: Callable, init, xs: tuple, *, segment: int = 256):
    """:func:`scan` over time with gradient checkpointing at segment
    boundaries, as the reference's ``jax.checkpoint`` of each segment.

    With grad enabled each segment of ``gcd(segment, length)`` steps (of
    ``segment`` when it divides the length) runs through
    ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes a
    segment from its carry, with the same ops and so the same bits, and
    keeps O(S / segment * state) residuals instead of O(S * state). With
    grad disabled, or where the length is one segment or less, it is the
    plain loop."""
    length = xs[0].shape[0]
    seg = math.gcd(segment, length) if length % segment else segment
    if seg <= 1 or length <= seg or not torch.is_grad_enabled():
        return scan(cell, init, xs)
    carry, ys = init, []
    for seg_xs in zip(*(a.split(seg) for a in xs)):
        carry, y = checkpoint(scan, cell, carry, seg_xs, use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)


# ---------------------------------------------------------------------------
# Activations (the reference's jax.nn.gelu is the tanh form)
# ---------------------------------------------------------------------------

ACTIVATIONS: dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "identity": lambda x: x,
}
