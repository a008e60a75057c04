"""Mamba2-style selective state-space block (recurrent formulation).

Mirror of ``src/repro/nn/ssm.py``. State h (B, H, P, N) with H heads, P
the head dim and N the state dim. Per step t:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t outer x_t)
    y_t = (h_t @ C_t) + D * x_t
The projections are separate (wz / wx / wB / wC / wdt) and a depthwise
causal conv precedes x / B / C. The full sequence runs the chunked SSD
form where the length is a multiple of the chunk (each chunk checkpointed
under grad, as the reference's ``jax.checkpoint``), else the cell through
``core.segmented_scan``; decode is the cell with carried state, O(1) a
token.

Numerics kept from the reference: the SSD keeps its streaming tensors in
the activation dtype and forms every product in float32 (the reference's
``preferred_element_type=float32``): the operands are cast to float32
first, which is exact, so no product is rounded to bfloat16; ``scores`` is
rounded to the activation dtype before its product with x, as there; the
decay exponent is masked before ``exp``; the conv adds its taps in order
from 0, tap 0 first.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed import sharding
from . import core
from .core import val


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    # 'ssd' (chunked matmul form) | 'recurrent' (the cell)
    impl: str = "ssd"
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init(gen: torch.Generator, cfg: MambaCfg, *, lead: tuple = (), dtype=torch.float32) -> dict:
    """``lead`` stacks that many layers on leading dims. ``A_log``, ``D``
    and ``dt_bias`` are float32 whatever ``dtype`` is, as the reference's."""
    d, di = cfg.d_model, cfg.d_inner
    gn = cfg.n_groups * cfg.d_state
    conv_dim = di + 2 * gn
    kw = dict(lead=lead, dtype=dtype)
    dev = gen.device

    def heads(a):  # one a layer, stacked
        return core.tag(a.expand(lead + a.shape).clone(), (None,), lead)

    return {
        "wz": core.dense_init(gen, d, di, axes=("embed", "mlp"), **kw),
        "wx": core.dense_init(gen, d, di, axes=("embed", "mlp"), **kw),
        "wB": core.dense_init(gen, d, gn, axes=("embed", None), **kw),
        "wC": core.dense_init(gen, d, gn, axes=("embed", None), **kw),
        "wdt": core.dense_init(gen, d, cfg.n_heads, axes=("embed", None), **kw),
        "conv_w": core.tag(core.lecun_init(gen, lead + (cfg.conv_width, conv_dim), dtype=dtype),
                           (None, "mlp"), lead),
        "conv_b": core.tag(torch.zeros(lead + (conv_dim,), dtype=dtype, device=dev), ("mlp",),
                           lead),
        "A_log": heads(torch.log(torch.linspace(1.0, 16.0, cfg.n_heads, device=dev))),
        "D": heads(torch.ones((cfg.n_heads,), device=dev)),
        "dt_bias": heads(torch.zeros((cfg.n_heads,), device=dev)),
        "norm": core.rmsnorm_init(di, lead=lead, dtype=dtype, device=dev),
        "wo": core.dense_init(gen, di, d, axes=("mlp", "embed"), **kw),
    }


def _causal_depthwise_conv(w, b, x, conv_state=None):
    """x: (B, S, C); w: (W, C). Returns (y, new_conv_state (B, W-1, C))."""
    width = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+W-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :].to(x.dtype) for i in range(width))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(width - 1):, :] if width > 1 else pad
    return y, new_state


def _cell(h, inputs, *, A, D, n_heads, head_dim):
    """One recurrence step. h: (B,H,P,N); inputs: per-step tensors."""
    x_t, b_t, c_t, dt_t = inputs  # (B,DI) (B,N) (B,N) (B,H)
    bsz = x_t.shape[0]
    xh = x_t.reshape(bsz, n_heads, head_dim).to(torch.float32)
    dt_t = dt_t.to(torch.float32)
    decay = torch.exp(dt_t * A)[..., None, None]  # (B,H,1,1), A < 0
    upd = dt_t[..., None, None] * xh[..., None] * b_t.to(torch.float32)[:, None, None, :]
    h = h * decay + upd
    y = torch.einsum("bhpn,bn->bhp", h, c_t.to(torch.float32))
    y = y + D[None, :, None] * xh
    return h, y.reshape(bsz, n_heads * head_dim)


def apply(params, cfg: MambaCfg, x, *, state=None, conv_state=None):
    """x: (B, S, D). Returns (y, (ssm_state, conv_state))."""
    b, s, _ = x.shape
    z = core.dense(params["wz"], x)
    xi = core.dense(params["wx"], x)
    bb = core.dense(params["wB"], x)
    cc = core.dense(params["wC"], x)
    dt = core.dense(params["wdt"], x)

    conv_in = torch.cat([xi, bb, cc], dim=-1)
    conv_out, new_conv = _causal_depthwise_conv(val(params["conv_w"]), val(params["conv_b"]),
                                                conv_in, conv_state)
    conv_out = F.silu(conv_out)
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    xi, bb, cc = conv_out[..., :di], conv_out[..., di:di + gn], conv_out[..., di + gn:]

    # each rank's own block for a DTensor: DTensor's softplus_backward labels
    # its output contiguous where the local result follows a transposed grad
    dt = sharding.elementwise(F.softplus, dt.to(torch.float32) + val(params["dt_bias"]))
    A = -torch.exp(val(params["A_log"]))  # (H,), negative
    D = val(params["D"])

    if state is None:
        state = torch.zeros((b, cfg.n_heads, cfg.head_dim, cfg.d_state), dtype=torch.float32,
                            device=x.device)

    y, new_state = sharding.row_local(functools.partial(_scan_rows, cfg=cfg), 2,
                                      (xi, bb, cc, dt, state), (A, D))
    y = y.to(x.dtype)

    y = y * F.silu(z)
    y = core.rmsnorm(params["norm"], y)
    return core.dense(params["wo"], y), (new_state, new_conv)


def _scan_rows(xi, bb, cc, dt, state, A, D, *, cfg: MambaCfg):
    """The selective scan of each batch row from ``state``: the chunked SSD
    where the length is whole chunks, else the cell a step. -> (y (B, S,
    DI), state)."""
    s = xi.shape[1]
    if cfg.impl == "ssd" and s % cfg.chunk == 0 and s > 1:
        return _ssd_chunked(xi, bb, cc, dt, state, A=A, D=D, cfg=cfg)
    step = functools.partial(_cell, A=A, D=D, n_heads=cfg.n_heads, head_dim=cfg.head_dim)
    xs = tuple(a.transpose(0, 1) for a in (xi, bb, cc, dt))  # time leading
    new_state, ys = core.segmented_scan(step, state, xs)
    return ys.transpose(0, 1), new_state  # (B, S, DI)


def _ssd_chunk(h_prev, xck, bck, cck, dck, *, A, D, mask):
    """One SSD chunk: xck (b,c,h,p), bck / cck (b,c,n) in the activation
    dtype, dck (b,c,h) float32; h_prev (b,h,p,n) float32 -> (h_new, y (b, c,
    h*p) in the activation dtype)."""
    b, c, hh, p = xck.shape
    sdt = xck.dtype
    f32 = torch.float32
    x32, b32, c32 = xck.to(f32), bck.to(f32), cck.to(f32)
    a_log = dck * A  # (b,c,h) fp32, negative
    cum = torch.cumsum(a_log, dim=1)  # (b,c,h)
    # inter-chunk: decayed read of the carried state
    y_inter = torch.einsum("bcn,bhpn->bchp", c32, h_prev)
    y_inter = y_inter * torch.exp(cum)[..., None]
    # intra-chunk: causal decayed attention-like mix, the exponent masked
    # before exp (for j > i it is positive and overflows)
    cb = torch.einsum("bin,bjn->bij", c32, b32)
    expo = cum[:, :, None, :] - cum[:, None, :, :]  # (b,i,j,h)
    ldecay = torch.where(mask, expo, -math.inf).exp()
    scores = (cb[..., None] * ldecay * dck[:, None, :, :]).to(sdt)
    y_intra = torch.einsum("bijh,bjhp->bihp", scores.to(f32), x32)
    # carry update (fp32)
    w = torch.exp(cum[:, -1:, :] - cum) * dck  # (b,c,h)
    h_new = (torch.exp(cum[:, -1])[..., None, None] * h_prev
             + torch.einsum("bch,bcn,bchp->bhpn", w, b32, x32))
    y = y_inter + y_intra + D[None, None, :, None] * x32
    return h_new, y.to(sdt).reshape(b, c, hh * p)


def _ssd_chunked(xi, bb, cc, dt, h0, *, A, D, cfg: MambaCfg):
    """Chunked SSD (Mamba2), numerically equal to the recurrence.

    Within a chunk the causal mix is a masked matmul (C_i . B_j decayed);
    states materialize only at chunk boundaries. All decay exponents are
    <= 0 (A < 0, dt > 0)."""
    b, s, _ = xi.shape
    hh, p, n = cfg.n_heads, cfg.head_dim, cfg.d_state
    c = cfg.chunk
    nch = s // c
    xs = (xi.reshape(b, nch, c, hh, p).unbind(1), bb.reshape(b, nch, c, n).unbind(1),
          cc.reshape(b, nch, c, n).unbind(1),
          dt.to(torch.float32).reshape(b, nch, c, hh).unbind(1))
    mask = torch.ones((c, c), dtype=torch.bool, device=xi.device).tril()[None, :, :, None]
    body = functools.partial(_ssd_chunk, A=A, D=D, mask=mask)
    if torch.is_grad_enabled():
        body = functools.partial(checkpoint, body, use_reentrant=False)
    h, ys = h0, []
    for ins in zip(*xs):
        h, y = body(h, *ins)
        ys.append(y)
    return torch.cat(ys, dim=1), h
