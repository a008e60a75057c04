"""Mixture-of-Experts layer (top-k routing, grouped capacity dispatch).

Mirror of ``src/repro/nn/moe.py``: a float32 router, softmax, top-k
renormalised, the switch-style load-balancing aux loss, then a
group-local capacity dispatch (one group per sequence when ``s >= 64``,
else one group: decode) into an (E, C, D) buffer a group, the expert FFNs
on stacked weights, the combine, and the optional shared expert (with its
sigmoid gate, qwen2-moe) and parallel dense FFN (arctic).

Dispatch and combine, laid out for the card:

* Each kept (token, choice) goes to its own slot ``eid * cap + pos``, so
  no slot is written twice; a dropped one goes to a spill row past the
  last slot, which is cut off (the reference adds a zero into slot
  ``cap - 1`` instead: the same buffer). The scatter needs no host sync
  (no ``nonzero``, no ``.item()``), and its backward is a gather.
* A token's k copies are an ``expand`` of the token (its backward sums
  them), and the combine gathers each (token, choice)'s slot, dropped ones
  read at ``cap - 1`` with weight 0 as in the reference, and adds a
  token's k slots in order 0..k-1 as an (N, k, D) tensor, where the
  reference scatter-adds them onto zeros. No step adds with atomics into
  a row that holds a non-zero value from another token.

``w8_gather`` (the reference's int8 FSDP gather with a straight-through
gradient) is a :class:`torch.autograd.Function`: its forward is the
per-(expert, column) int8 round trip, its backward the identity.
``ep_ff_data`` only changes the reference's sharding axes: accepted, no
math changes.

On DTensors (``shard=``): the routing, the dispatch and the combine are
group-local and run on each rank's groups (``sharding.row_local``), the
expert FFNs on each rank's (groups, experts) block (:func:`_experts`),
both under ``local_map``; the aux loss averages over every group.

Ties: ``lax.top_k`` puts the lower expert id first among equal router
probabilities; ``torch.topk`` does not (on the CPU it picked the higher
ids), so the top k are taken from a stable descending sort, which orders
ties as the reference does.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed import sharding
from . import core, mlp


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    d_model: int
    d_ff_expert: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # shared experts (qwen2-moe): ff dim of the always-on expert, 0 = none
    d_ff_shared: int = 0
    shared_gate: bool = True
    # arctic-style dense residual FFN running in parallel, 0 = none
    d_ff_dense: int = 0
    act: str = "swiglu"
    # int8 weight round trip with a straight-through gradient
    w8_gather: bool = False
    # the reference's sharding choice for the expert ff dim: no math
    ep_ff_data: bool = False


def init(gen: torch.Generator, cfg: MoeCfg, *, lead: tuple = (), dtype=torch.float32) -> dict:
    """``lead`` stacks that many layers on leading dims. The router is
    float32 whatever ``dtype`` is."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert

    def stacked(shape, axes):
        # the reference's lecun fan-in counts the expert axis as a
        # receptive field: e * (input dim)
        return core.tag(core.lecun_init(gen, lead + shape, dtype=dtype, fan_in=e * shape[1]),
                        axes, lead)

    if cfg.ep_ff_data:  # EP + the expert ff dim over 'data'
        up_axes, down_axes = ("expert", None, "moe_ff"), ("expert", "moe_ff", None)
    else:  # EP + FSDP over embed
        up_axes, down_axes = ("expert", "embed", "mlp"), ("expert", "mlp", "embed")
    p = {
        "router": core.dense_init(gen, d, e, axes=("embed", None), lead=lead,
                                  dtype=torch.float32),
        "wg": stacked((e, d, f), up_axes),
        "wu": stacked((e, d, f), up_axes),
        "wd": stacked((e, f, d), down_axes),
    }
    if cfg.d_ff_shared:
        p["shared"] = mlp.init(gen, mlp.MlpCfg(d, cfg.d_ff_shared, act=cfg.act), lead=lead,
                               dtype=dtype)
        if cfg.shared_gate:
            p["shared_gate"] = core.dense_init(gen, d, 1, axes=("embed", None), lead=lead,
                                               dtype=dtype)
    if cfg.d_ff_dense:
        p["dense"] = mlp.init(gen, mlp.MlpCfg(d, cfg.d_ff_dense, act=cfg.act), lead=lead,
                              dtype=dtype)
    return p


def _choose_groups(b: int, s: int) -> int:
    # one group per sequence for long inputs; single group for decode
    return b if s >= 64 else 1


def capacity(cfg: MoeCfg, n: int) -> int:
    """Slots an expert has in a group of ``n`` tokens."""
    return max(int(cfg.capacity_factor * n * cfg.top_k / cfg.n_experts), 1)


def route(params: dict, cfg: MoeCfg, xg: torch.Tensor):
    """Route the groups' tokens ``xg`` (G, N, D).

    Returns (top_p (G, N, k) float32 renormalised, flat_e (G, N*k) expert
    ids, pos (G, N*k) slots in the expert's buffer, clamped to ``cap - 1``
    where dropped, keep (G, N*k) bool, the aux loss, cap)."""
    w = core.val(params["router"]["w"])
    top_p, flat_e, pos, keep, probs, top1 = sharding.row_local(
        functools.partial(_route_groups, cfg=cfg), 6, (xg,), (w,))
    # ---- load-balancing aux (switch-style), over every group ----
    density = torch.mean(top1, dim=(0, 1))
    mean_probs = torch.mean(probs, dim=(0, 1))
    aux = cfg.n_experts * torch.sum(density * mean_probs)
    return top_p, flat_e, pos, keep, aux, capacity(cfg, xg.shape[1])


def _route_groups(xg, w, *, cfg: MoeCfg):
    """Each group's routing: (top_p, flat_e, pos, keep) as :func:`route`
    returns them, the router's probs (G, N, E) and the one-hot top choice
    (G, N, E) float32, which the aux loss averages over every group."""
    e, k = cfg.n_experts, cfg.top_k
    g, n, _ = xg.shape
    logits = xg.to(torch.float32) @ w
    probs = torch.softmax(logits, dim=-1)  # (G, N, E)
    # a stable sort: ties to the lower expert id, as lax.top_k
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]  # (G, N, k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    top1 = F.one_hot(top_i[..., 0], e).to(torch.float32)

    # ---- group-local capacity: a (token, choice)'s place in its expert's queue
    cap = capacity(cfg, n)
    flat_e = top_i.reshape(g, n * k)
    onehot = F.one_hot(flat_e, e)  # (G, N*k, E)
    pos = torch.gather(torch.cumsum(onehot, dim=1) - 1, 2, flat_e[..., None])[..., 0]
    keep = pos < cap
    pos = torch.where(keep, pos, cap - 1)
    return top_p, flat_e, pos, keep, probs, top1


def _dispatch_groups(xg, flat_e, pos, keep, *, cap: int, e: int):
    """Each group's dispatch buffer (G, E, C, D): a kept (token, choice) in
    its own slot, a dropped one in the spill row (cut off)."""
    g, n, d = xg.shape
    k = flat_e.shape[1] // n
    slot = flat_e * cap + pos  # (G, N*k)
    spill = e * cap
    dest = torch.where(keep, slot, spill)[..., None].expand(g, n * k, d)
    copies = xg[:, :, None, :].expand(g, n, k, d).reshape(g, n * k, d)
    buf = xg.new_zeros((g, spill + 1, d)).scatter(1, dest, copies)
    return buf[:, :spill].reshape(g, e, cap, d)


def _expert_ffn(buf, wg, wu, wd):
    """Each expert's gated FFN on its slots of every group (G, E, C, D)."""
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, wg))
    h = h * torch.einsum("gecd,edf->gecf", buf, wu)
    return torch.einsum("gecf,efd->gecd", h, wd)


def _experts(buf, wg, wu, wd):
    """:func:`_expert_ffn`; on DTensors each rank runs it on its block under
    ``local_map``: the groups split as ``buf`` splits them (the weights
    whole there, their gradients summed), the experts split as ``buf``
    splits them (the weights' expert dim alike); any other split gathered.
    (DTensor's rules for the einsums' backward give a block whose strides
    its own views then misread.)"""
    if not isinstance(buf, DTensor):
        return _expert_ffn(buf, wg, wu, wd)
    # per mesh dim: (buf, the weights, the weights' gradients)
    rows = [(p, Replicate(), Partial()) if p == Shard(0)  # groups
            else (p, Shard(0), Shard(0)) if p == Shard(1)  # experts
            else (Replicate(),) * 3 for p in buf.placements]
    bp, wp, gp = (list(col) for col in zip(*rows))
    return local_map(_expert_ffn, out_placements=bp, in_placements=(bp, wp, wp, wp),
                     in_grad_placements=(bp, gp, gp, gp), device_mesh=buf.device_mesh,
                     redistribute_inputs=True)(buf, wg, wu, wd)


def _combine_groups(out_buf, top_p, flat_e, pos, keep, *, cap: int):
    """Each group's tokens (G, N, D): each (token, choice)'s slot, weighted;
    a token's k in order."""
    g, e, _, d = out_buf.shape
    n, k = top_p.shape[1], top_p.shape[2]
    slot = flat_e * cap + pos
    wts = (top_p.reshape(g, n * k) * keep).to(out_buf.dtype)
    y_slots = torch.gather(out_buf.reshape(g, e * cap, d), 1,
                           slot[..., None].expand(g, n * k, d))
    y_slots = (y_slots * wts[..., None]).reshape(g, n, k, d)
    y = y_slots[:, :, 0]
    for j in range(1, k):
        y = y + y_slots[:, :, j]
    return y


class _W8Gather(torch.autograd.Function):
    """Per-(expert, column) int8 round trip; straight-through gradient.
    ``shard`` lays the int8 payload out on ('expert', None, None), the
    reference's int8 all-gather site; the backward is the identity."""

    @staticmethod
    def forward(ctx, w, shard):
        w32 = w.to(torch.float32)
        scale = core.divide(torch.amax(torch.abs(w32), dim=1, keepdim=True), 127.0)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
        q = shard(q, ("expert", None, None))
        return q.to(w.dtype) * scale.to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def w8_gather(w: torch.Tensor, shard=None) -> torch.Tensor:
    return _W8Gather.apply(w, shard or sharding.no_shard)


def apply(params: dict, cfg: MoeCfg, x: torch.Tensor, *,
          shard=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss).

    ``shard``: fn(tensor, logical_axes) -> tensor laying it out
    (``distributed/sharding.py:make_shard_fn``), applied where the
    reference constrains: the groups on 'batch', the dispatch buffer on
    ('batch', 'expert'), the experts' output gathered back to its groups,
    and the int8 payload of ``w8_gather``; the identity if None."""
    shard = shard or sharding.no_shard
    b, s, d = x.shape
    g = _choose_groups(b, s)
    n = b * s // g  # tokens per group
    xg = shard(x.reshape(g, n, d), ("batch", None, None))
    top_p, flat_e, pos, keep, aux, cap = route(params, cfg, xg)

    # ---- dispatch: kept (token, choice) -> its own slot, dropped -> the spill row
    buf = sharding.row_local(functools.partial(_dispatch_groups, cap=cap, e=cfg.n_experts), 1,
                             (xg, flat_e, pos, keep))
    buf = shard(buf, ("batch", "expert", None, None))

    # ---- expert FFNs on stacked weights
    wg, wu, wd = core.val(params["wg"]), core.val(params["wu"]), core.val(params["wd"])
    if cfg.w8_gather:
        wg, wu, wd = w8_gather(wg, shard), w8_gather(wu, shard), w8_gather(wd, shard)
    out_buf = _experts(buf, wg.to(x.dtype), wu.to(x.dtype), wd.to(x.dtype))  # (G, E, C, D)
    out_buf = shard(out_buf, ("batch", None, None, None))  # gather experts per group

    # ---- combine: each (token, choice)'s slot, weighted; a token's k in order
    y = sharding.row_local(functools.partial(_combine_groups, cap=cap), 1,
                           (out_buf, top_p, flat_e, pos, keep))
    y = y.reshape(b, s, d)

    if "shared" in params:
        sh_out = mlp.apply(params["shared"], mlp.MlpCfg(d, cfg.d_ff_shared, act=cfg.act), x)
        if "shared_gate" in params:
            gate = torch.sigmoid(core.dense(params["shared_gate"], x).to(torch.float32))
            sh_out = sh_out * gate.to(x.dtype)
        y = y + sh_out
    if "dense" in params:
        y = y + mlp.apply(params["dense"], mlp.MlpCfg(d, cfg.d_ff_dense, act=cfg.act), x)
    return y, aux
