"""Grouped-query attention with optional qk-norm, RoPE and KV cache.

Mirror of ``src/repro/nn/attention.py``.

Shapes
------
x:        (B, S, D)
q:        (B, S, H, hd)     k/v: (B, S, KV, hd)
cache k/v:(B, S_max, KV, hd)   (decode: write at ``cache_pos``)

Every product is a ``torch.einsum`` / matmul, as the reference computes
it: the score einsum is rounded to the input dtype and then cast to
float32, masked with ``finfo(float32).min`` and soft-maxed in float32.
The DiT's bidirectional path (``causal=False``, no window, no cache) takes
no mask at all, as before.

One divergence, on purpose: the cached path writes the new k/v *into*
the given cache (``index_copy_`` at ``cache_pos``) and returns that cache,
where the reference returns an updated copy; at a 32k-slot decode cache
a copy a step would be the cache's size again. A caller must not read a
cache after passing it in expecting the old contents.

On DTensors (a step built with ``shard=``) the attention runs on each
rank's (row, head) block under ``local_map`` (``_sdpa``), and so does a
decode's cache write (``write_attend``), whose softmax runs over the
ranks where the cache is split over its slots.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed import sharding
from . import core
from .rotary import apply_rope


@dataclasses.dataclass(frozen=True)
class AttentionCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    bias: bool = False
    causal: bool = True
    # sliding window (tokens); None = full attention
    window: int | None = None


def init(gen: torch.Generator, cfg: AttentionCfg, *, lead: tuple = (),
         dtype=torch.float32) -> dict:
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    kw = dict(bias=cfg.bias, lead=lead, dtype=dtype)
    p = {
        "wq": core.dense_init(gen, cfg.d_model, qd, axes=("embed", "heads"), **kw),
        "wk": core.dense_init(gen, cfg.d_model, kvd, axes=("embed", "kv"), **kw),
        "wv": core.dense_init(gen, cfg.d_model, kvd, axes=("embed", "kv"), **kw),
        "wo": core.dense_init(gen, qd, cfg.d_model, axes=("heads", "embed"), **kw),
    }
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = core.rmsnorm_init(cfg.head_dim, lead=lead, dtype=dtype,
                                        device=gen.device)
    return p


def _headnorm(scale, x, eps=1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * core.val(scale).to(torch.float32)).to(dt)


def _sdpa(q, k, v, *, mask, scale):
    """q: (B,Sq,H,hd) k/v: (B,Sk,KV,hd). GQA via head grouping. ``mask``
    broadcasts against (B, KV, G, Sq, Sk); None attends everywhere.

    DTensors: each (row, kv-head group) attends on its own, so each rank
    runs the plain attention on its block under ``local_map``: a mesh dim
    that splits the batch (dim 0) or the heads (dim 2) of q, k and v alike
    stays split, any other is gathered first. (DTensor's own rules fold the
    split batch and head dims of the grouped einsums into strided splits,
    whose redistribution plans cost seconds a shape to search.)"""
    if isinstance(q, DTensor):
        pl = [p if p in (Shard(0), Shard(2)) and k.placements[i] == p == v.placements[i]
              else Replicate() for i, p in enumerate(q.placements)]
        if isinstance(mask, DTensor):  # a ring's, replicated
            mask = mask.full_tensor()
        return local_map(functools.partial(_sdpa, mask=mask, scale=scale), out_placements=pl,
                         in_placements=(pl, pl, pl), device_mesh=q.device_mesh,
                         redistribute_inputs=True)(q, k, v)
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    q = q.reshape(b, sq, kvh, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q, k).to(torch.float32) * scale
    if mask is not None:
        logits = logits.masked_fill_(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, hd)


def write_attend(q, k, v, ck, cv, slots, mask, scale):
    """A decode step's cache write and attention: the new k / v (B, S, KV,
    hd) written in place at ``slots`` (S,) of dim 1 of the cache ``ck`` /
    ``cv`` (B, S_max, KV, hd), then q attends over the cache under
    ``mask``, whose last dim runs over the S_max slots.

    A DTensor cache: each rank writes and attends on its own block under
    ``local_map`` (q, k and v laid out as the cache's batch and head
    splits). Where the cache is split over its slots (the reference's
    layout when the kv heads do not divide the 'model' axis), each rank
    writes the new slots it holds (one new token a step) and the softmax
    runs over the ranks: the global max and sum, then the sum of the
    ranks' weighted values (all-reduces over that mesh dim), equal to the
    whole softmax up to the order of its sums."""
    if not isinstance(ck, DTensor):
        ck.index_copy_(1, slots, k.to(ck.dtype))
        cv.index_copy_(1, slots, v.to(cv.dtype))
        return _sdpa(q, ck.to(q.dtype), cv.to(q.dtype), mask=mask, scale=scale)
    mesh, cpl = ck.device_mesh, list(ck.placements)
    qpl = [p if p in (Shard(0), Shard(2)) else Replicate() for p in cpl]
    split = [i for i, p in enumerate(cpl) if p == Shard(1)]
    if len(split) > 1 or (split and k.shape[1] != 1):
        raise NotImplementedError(f"a cache split over its slots by {cpl} takes one new token "
                                  f"on one mesh dim, not {k.shape[1]} on {len(split)}")
    if isinstance(mask, DTensor):  # made from the ring's replicated positions
        mask = mask.full_tensor()
    if isinstance(slots, DTensor):
        slots = slots.full_tensor()
    n = mesh.size(split[0]) if split else 1
    lo = mesh.get_coordinate()[split[0]] * (ck.shape[1] // n) if split else 0

    def body(q, k, v, ck, cv):
        width = ck.shape[1]
        local = mask[..., lo:lo + width]
        if not split:
            ck.index_copy_(1, slots, k.to(ck.dtype))
            cv.index_copy_(1, slots, v.to(cv.dtype))
            return _sdpa(q, ck.to(q.dtype), cv.to(q.dtype), mask=local, scale=scale)
        at = slots - lo
        inside = ((at >= 0) & (at < width))[None, :, None, None]
        at = at.clamp(0, width - 1)
        for c, new in ((ck, k), (cv, v)):  # the slot's old value where it is not this rank's
            c.index_copy_(1, at, torch.where(inside, new.to(c.dtype), c.index_select(1, at)))
        group = mesh.get_group(split[0])
        b, sq, h, hd = q.shape
        kvh = ck.shape[2]
        logits = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(b, sq, kvh, h // kvh, hd),
                              ck.to(q.dtype)).to(torch.float32) * scale
        logits = logits.masked_fill_(~local, torch.finfo(torch.float32).min)
        top = torch.amax(logits, dim=-1, keepdim=True)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - top)
        total = torch.sum(e, dim=-1, keepdim=True)
        dist.all_reduce(total, group=group)
        out = torch.einsum("bkgqs,bskh->bqkgh", (e / total).to(cv.dtype), cv.to(q.dtype))
        dist.all_reduce(out, group=group)
        return out.reshape(b, sq, h, hd)

    return local_map(body, out_placements=qpl, in_placements=(qpl, qpl, qpl, cpl, cpl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v, ck, cv)


# query-chunk size above which the full (Sq, Sk) score matrix is never
# materialized (prefill at 32k would need O(S^2) memory otherwise)
CHUNK_Q = 4096


def _causal_mask(qpos, kpos, window):
    """(Sq, Sk) bool: key at or before the query (and within ``window``)."""
    mask = qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    return mask


def _sdpa_chunked(q, k, v, *, qpos, kpos, window, scale, chunk=CHUNK_Q):
    """Query-chunked attention: peak memory O(chunk * Sk) instead of O(Sq*Sk).

    Equivalent math (softmax is per-query-row); one chunk's scores are
    live at a time."""
    b, sq, h, hd = q.shape
    out = torch.empty_like(q, dtype=v.dtype)
    for lo in range(0, sq, chunk):
        mask = _causal_mask(qpos[lo:lo + chunk], kpos, window)
        out[:, lo:lo + chunk] = _sdpa(q[:, lo:lo + chunk], k, v, mask=mask[None, None, None],
                                      scale=scale)
    return out


def apply(params: dict, cfg: AttentionCfg, x: torch.Tensor, *, positions: torch.Tensor,
          cache: dict | None = None, cache_pos=None):
    """Returns (y, new_cache). ``cache`` is None for training / prefill
    (causal, or bidirectional with ``causal=False``).

    Decode: x is (B, S, D), cache holds (B, S_max, KV, hd); the new k/v are
    written in place at ``cache_pos`` (a Python int or a 0-d integer
    tensor) and attention runs over positions <= the query's.
    """
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = sharding.unflatten(core.dense(params["wq"], x), -1, (h, hd))
    k = sharding.unflatten(core.dense(params["wk"], x), -1, (kvh, hd))
    v = sharding.unflatten(core.dense(params["wv"], x), -1, (kvh, hd))
    if cfg.qk_norm:
        q = _headnorm(params["q_norm"]["scale"], q)
        k = _headnorm(params["k_norm"]["scale"], k)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)

    if cache is None:
        qp = positions if positions.dim() else positions[None]
        if cfg.causal and qp.dim() == 1 and s > CHUNK_Q and s % CHUNK_Q == 0:
            y = _sdpa_chunked(q, k, v, qpos=qp, kpos=qp, window=cfg.window, scale=scale)
        elif not cfg.causal and cfg.window is None:  # bidirectional (DiT blocks)
            y = _sdpa(q, k, v, mask=None, scale=scale)
        else:
            if cfg.causal:
                mask = qp[..., :, None] >= qp[..., None, :]  # (S,S) or (B,S,S)
            else:
                mask = torch.ones(qp.shape[-1:] * 2, dtype=torch.bool, device=x.device)
            if cfg.window is not None:
                mask = mask & (qp[..., :, None] - qp[..., None, :] < cfg.window)
            # (S, S) -> (1, 1, 1, Sq, Sk); (B, S, S) -> (B, 1, 1, Sq, Sk)
            mask = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
            y = _sdpa(q, k, v, mask=mask, scale=scale)
        new_cache = {"k": k, "v": v}
    else:
        ck, cv = cache["k"], cache["v"]
        s_max = ck.shape[1]
        pos0 = 0 if cache_pos is None else cache_pos
        if not torch.is_tensor(pos0) or pos0.device.type == "cpu":
            # a device position is not read back: there the write's index
            # check fails on the device instead
            if not 0 <= int(pos0) <= s_max - s:
                raise ValueError(f"cache_pos {int(pos0)} + {s} new positions past the cache "
                                 f"length {s_max}")
        qpos = torch.arange(s, dtype=torch.int32, device=x.device) + pos0
        kpos = torch.arange(s_max, dtype=torch.int32, device=x.device)
        mask = _causal_mask(qpos, kpos, cfg.window)[None, None, None]  # (1,1,1,Sq,Sk)
        y = write_attend(q, k, v, ck, cv, qpos.to(torch.int64), mask, scale)
        new_cache = {"k": ck, "v": cv}

    y = y.reshape(b, s, h * hd)
    return core.dense(params["wo"], y), new_cache
