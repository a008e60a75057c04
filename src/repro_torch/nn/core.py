"""Minimal functional NN substrate.

Mirror of the parts of ``src/repro/nn/core.py`` that the DiT reaches.
Params are nested dicts of tensors. :class:`Param` (an array tagged with
logical sharding axes in the reference) is kept so that apply functions
accept a tagged tree as well as a plain one — ``val`` normalizes — but
``init`` functions return plain tensors: a single card has no sharding.

Initializers draw from an explicit ``torch.Generator`` and create tensors
on its device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Param:
    """A tensor tagged with logical sharding axes (one name or None per dim)."""

    value: torch.Tensor
    axes: tuple[str | None, ...]


def val(x: Any) -> torch.Tensor:
    return x.value if isinstance(x, Param) else x


def map_tree(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict of params."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


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


def normal_init(gen: torch.Generator, shape, stddev=0.02, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=gen.device) * stddev).to(dtype)


def lecun_init(gen: torch.Generator, shape, dtype=torch.float32):
    """N(0, 1/fan_in) with fan_in = shape[-2], the input dim of a (in, out)
    weight (a leading dim is a stack of layers, not a receptive field)."""
    fan_in = shape[-2]
    return (torch.randn(shape, generator=gen, device=gen.device)
            / math.sqrt(max(fan_in, 1))).to(dtype)


def zeros_init(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *, bias: bool = False,
               init: Callable = lecun_init, lead: tuple = (), dtype=torch.float32) -> dict:
    """``lead`` stacks that many independent layers on leading dims."""
    p = {"w": init(gen, lead + (in_dim, out_dim), dtype=dtype)}
    if bias:
        p["b"] = torch.zeros(lead + (out_dim,), dtype=dtype, device=gen.device)
    return p


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


# Rows of one 2-D product block (see ``dense``).
ROW_BLOCK = 16


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    w = val(params["w"]).to(x.dtype)
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
        y = torch.cat([b @ w for b in blocks])[:m]
    else:
        y = x @ w
    if "b" in params:
        y = y + val(params["b"]).to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Activations (the reference's jax.nn.gelu is the tanh form)
# ---------------------------------------------------------------------------

ACTIVATIONS: dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}
