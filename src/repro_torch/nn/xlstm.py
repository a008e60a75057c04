"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Mirror of ``src/repro/nn/xlstm.py``: stabilized exponential gating, a
recurrent cell over time (decode is the same cell with carried state,
O(1) a token) and, for the mLSTM, a chunked (linear-attention) form.

mLSTM state: C (B,H,P,P), n (B,H,P), m (B,H)    [P = head dim]
sLSTM state: c,n,h (B,H*P), m (B,H)             [h feeds back recurrently]

Numerics kept from the reference: the cells and the chunked form run in
float32 whatever the activation dtype; ``-softplus(-f)`` is
``F.logsigmoid(f)``; the query and key scale is a true division by
``sqrt(head_dim)`` (``core.divide``); the chunked form masks its exponent
before ``exp`` (``torch.where(mask, e, -inf).exp()``), so no masked entry
overflows and the backward has no ``0 * inf``; ``lax.cummax`` is
:func:`cummax` (``torch.cummax``'s values from element-wise maxima, whose
backward adds with no atomics); the sLSTM's stabilizer is an ``amax``
over the head dim, which splits a tie's gradient as ``jnp.max`` does.

Under grad the chunked form runs each chunk through
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
chunk body) and the cells run through ``core.segmented_scan``. Two
launch savings, both exact: the sLSTM's recurrent weights are cast to
float32 once a call, not once a step, and its four recurrent products
run as one product against the four weights side by side.
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
class XlstmCfg:
    d_model: int
    n_heads: int = 4
    proj_factor: float = 2.0  # mLSTM up-projection
    slstm_ffn_factor: float = 1.3333  # sLSTM post-FFN
    # mLSTM execution: 'chunked' (matmul form, state at chunk boundaries
    # only) or 'recurrent' (the cell). Decode always uses the cell.
    impl: str = "chunked"
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def s_head_dim(self) -> int:
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, cfg: XlstmCfg, *, lead: tuple = (),
               dtype=torch.float32) -> dict:
    """``lead`` stacks that many layers on leading dims."""
    d, di = cfg.d_model, cfg.d_inner
    kw = dict(lead=lead, dtype=dtype)
    return {
        "w_up": core.dense_init(gen, d, di, axes=("embed", "mlp"), **kw),
        "w_gate": core.dense_init(gen, d, di, axes=("embed", "mlp"), **kw),
        "wq": core.dense_init(gen, di, di, axes=("mlp", "heads"), **kw),
        "wk": core.dense_init(gen, di, di, axes=("mlp", "heads"), **kw),
        "wv": core.dense_init(gen, di, di, axes=("mlp", "heads"), **kw),
        "wi": core.dense_init(gen, di, cfg.n_heads, axes=("mlp", None), **kw),
        "wf": core.dense_init(gen, di, cfg.n_heads, axes=("mlp", None), **kw),
        "norm": core.rmsnorm_init(di, lead=lead, dtype=dtype, device=gen.device),
        "w_down": core.dense_init(gen, di, d, axes=("mlp", "embed"), **kw),
    }


def _mlstm_cell(state, ins, *, n_heads, head_dim):
    C, n, m = state
    q, k, v, it, ft = ins  # (B,DI) (B,DI) (B,DI) (B,H) (B,H)
    bsz = q.shape[0]
    qh = core.divide(q.reshape(bsz, n_heads, head_dim).to(torch.float32), math.sqrt(head_dim))
    kh = core.divide(k.reshape(bsz, n_heads, head_dim).to(torch.float32), math.sqrt(head_dim))
    vh = v.reshape(bsz, n_heads, head_dim).to(torch.float32)
    it = it.to(torch.float32)
    ft = ft.to(torch.float32)
    # stabilized exponential gating
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_g = torch.exp(it - m_new)[..., None, None]
    f_g = torch.exp(log_f + m - m_new)[..., None, None]
    C = f_g * C + i_g * (vh[..., :, None] * kh[..., None, :])  # (B,H,P,P)
    n = f_g[..., 0] * n + i_g[..., 0] * kh
    num = torch.einsum("bhpq,bhq->bhp", C, qh)
    den = torch.abs(torch.einsum("bhp,bhp->bh", n, qh)).clamp_min(1.0)[..., None]
    y = (num / den).reshape(bsz, n_heads * head_dim)
    return (C, n, m_new), y


def mlstm_apply(params, cfg: XlstmCfg, x, *, state=None):
    """x: (B,S,D) -> (y, state)."""
    b, s, _ = x.shape
    h, p = cfg.n_heads, cfg.head_dim
    up = core.dense(params["w_up"], x)
    gate = F.silu(core.dense(params["w_gate"], x))
    q = core.dense(params["wq"], up)
    k = core.dense(params["wk"], up)
    v = core.dense(params["wv"], up)
    it = core.dense(params["wi"], up)
    ft = core.dense(params["wf"], up)
    if state is None:
        kw = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((b, h, p, p), **kw), torch.zeros((b, h, p), **kw),
                 torch.full((b, h), -1e30, **kw))
    y, *new_state = sharding.row_local(functools.partial(_mlstm_rows, cfg=cfg), 4,
                                       (q, k, v, it, ft) + tuple(state))
    y = y.to(x.dtype)
    y = core.rmsnorm(params["norm"], y) * gate
    return core.dense(params["w_down"], y), tuple(new_state)


def _mlstm_rows(q, k, v, it, ft, C, n, m, *, cfg: XlstmCfg):
    """The mLSTM recurrence of each batch row from state (C, n, m): the
    chunked form where the length is whole chunks, else the cell a step.
    -> (y (B, S, H*P), C, n, m)."""
    h, p, s = cfg.n_heads, cfg.head_dim, q.shape[1]
    if cfg.impl == "chunked" and s % cfg.chunk == 0 and s > 1:
        y, new_state = _mlstm_chunked(q, k, v, it, ft, (C, n, m), n_heads=h, head_dim=p,
                                      chunk=cfg.chunk)
        return (y, *new_state)
    xs = tuple(a.transpose(0, 1) for a in (q, k, v, it, ft))
    new_state, ys = core.segmented_scan(
        functools.partial(_mlstm_cell, n_heads=h, head_dim=p), (C, n, m), xs)
    return (ys.transpose(0, 1), *new_state)


def cummax(a: torch.Tensor) -> torch.Tensor:
    """The running maximum along dim 1 (the reference's ``lax.cummax``),
    from element-wise maxima over log2(n) doublings: ``torch.cummax``'s
    values, bit for bit, with a backward of element-wise selects.
    ``torch.cummax``'s backward scatter-adds into the argmax indices, which
    runs on atomics on the card, so its gradient's bits varied from run to
    run (remat on / off differed by a bf16 ulp)."""
    n, shift = a.shape[1], 1
    while shift < n:
        a = torch.cat([a[:, :shift], torch.maximum(a[:, shift:], a[:, :-shift])], dim=1)
        shift *= 2
    return a


def _mlstm_chunk(carry, qc, kc, vc, ic, fc, *, mask):
    """One chunk of the chunked mLSTM: qc / kc / vc (b,c,h,p) (q and k
    scaled), ic / fc (b,c,h); carry (C, n, m) -> (carry, y (b, c, h*p))."""
    C_prev, n_prev, m_prev = carry
    b, c, hh, p = qc.shape
    lf = F.logsigmoid(fc)  # log sigmoid(f)
    bcum = torch.cumsum(lf, dim=1)  # (b,c,h)
    a_rel = ic - bcum  # (b,c,h)
    g = torch.maximum(cummax(a_rel), m_prev[:, None, :])  # (b,c,h)
    # inter-chunk: C[p, r] = v_p k_r, so q contracts the k-index r
    inter_w = torch.exp(m_prev[:, None, :] - g)  # (b,c,h)
    y_inter = torch.einsum("bchr,bhpr->bchp", qc, C_prev) * inter_w[..., None]
    nq_inter = torch.einsum("bchp,bhp->bch", qc, n_prev) * inter_w
    # intra-chunk (causal): the exponent is masked before exp
    w_ij = torch.where(mask, a_rel[:, None, :, :] - g[:, :, None, :], -math.inf).exp()
    qk = torch.einsum("bihp,bjhp->bijh", qc, kc)  # (b,i,j,h)
    y_intra = torch.einsum("bijh,bjhp->bihp", qk * w_ij, vc)
    nq_intra = torch.einsum("bijh->bih", qk * w_ij)
    num = y_inter + y_intra
    den = torch.abs(nq_inter + nq_intra).clamp_min(1.0)[..., None]
    y = num / den
    # carry update at chunk end
    g_last = g[:, -1, :]  # (b,h)
    w_j = torch.exp(a_rel - g_last[:, None, :])  # (b,j,h)
    C_new = torch.exp(m_prev - g_last)[..., None, None] * C_prev + torch.einsum(
        "bjh,bjhp,bjhr->bhpr", w_j, vc, kc)
    n_new = torch.exp(m_prev - g_last)[..., None] * n_prev + torch.einsum(
        "bjh,bjhp->bhp", w_j, kc)
    m_new = bcum[:, -1, :] + g_last  # absolute stabilizer, as the cell carries
    return (C_new, n_new, m_new), y.reshape(b, c, hh * p)


def _mlstm_chunked(q, k, v, it, ft, state, *, n_heads, head_dim, chunk):
    """Chunked (linear-attention) mLSTM, numerically equal to the cell.

    With per-chunk cumulative log-forget b_j and absolute log-input a_j,
    the running stabilizer is m_i = b_i + g_i, g_i = max(m_prev,
    cummax_{j<=i}(a_j - b_j)), so every exponent is <= 0. The state
    materializes only at chunk boundaries."""
    b, s, _ = q.shape
    hh, p, c = n_heads, head_dim, chunk
    nch = s // c

    def resh(a, *tail):
        return a.to(torch.float32).reshape((b, nch, c, hh) + tail).unbind(1)

    qs = core.divide(q.to(torch.float32), math.sqrt(p)).reshape(b, nch, c, hh, p).unbind(1)
    ks = core.divide(k.to(torch.float32), math.sqrt(p)).reshape(b, nch, c, hh, p).unbind(1)
    vs = resh(v, p)  # unscaled, as in the recurrent cell
    its, fts = resh(it), resh(ft)
    mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    body = functools.partial(_mlstm_chunk, mask=mask)
    if torch.is_grad_enabled():
        body = functools.partial(checkpoint, body, use_reentrant=False)
    carry, ys = state, []
    for ins in zip(qs, ks, vs, its, fts):
        carry, y = body(carry, *ins)
        ys.append(y)
    return torch.cat(ys, dim=1), carry


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

GATES = ("i", "f", "z", "o")


def slstm_init(gen: torch.Generator, cfg: XlstmCfg, *, lead: tuple = (),
               dtype=torch.float32) -> dict:
    """``lead`` stacks that many layers on leading dims. The recurrent
    weights ``ri``, ``rf``, ``rz``, ``ro`` are bare (H, hd, hd) leaves, as
    the reference's head-local ``Param``s."""
    d = cfg.d_model
    hd, nh = cfg.s_head_dim, cfg.n_heads
    p = {"norm": core.rmsnorm_init(d, lead=lead, dtype=dtype, device=gen.device)}
    for g in GATES:
        p[f"w{g}"] = core.dense_init(gen, d, d, axes=("embed", "heads"), lead=lead, dtype=dtype)
    for g in GATES:
        p[f"r{g}"] = core.tag(core.normal_init(gen, lead + (nh, hd, hd),
                                               stddev=1.0 / math.sqrt(hd), dtype=dtype),
                              (None, "heads", None), lead)
    f_ff = int(cfg.slstm_ffn_factor * d)
    p["ffn_up"] = core.dense_init(gen, d, f_ff, axes=("embed", "mlp"), lead=lead, dtype=dtype)
    p["ffn_down"] = core.dense_init(gen, f_ff, d, axes=("mlp", "embed"), lead=lead,
                                    dtype=dtype)
    return p


def _slstm_cell(state, ins, *, r_all, n_heads, head_dim):
    """One step. ``ins``: the four input projections (B, H, hd) in float32;
    ``r_all``: (H, hd, 4 hd) float32, the recurrent weights of i, f, z, o
    side by side (each output column is the reference's per-gate product)."""
    c, n, hprev, m = state
    xi, xf, xz, xo = ins
    bsz = xi.shape[0]
    hd = head_dim
    rec = torch.einsum("bhp,hpq->bhq", hprev.reshape(bsz, n_heads, hd), r_all)
    it = xi + rec[..., :hd]
    ft = xf + rec[..., hd:2 * hd]
    zt = xz + rec[..., 2 * hd:3 * hd]
    ot = xo + rec[..., 3 * hd:]
    # stabilized exp gating (per head, scalar stabilizer over head dims)
    log_f = F.logsigmoid(ft)
    m_new = torch.amax(torch.maximum(log_f + m[..., None], it), dim=-1)  # (B,H)
    i_g = torch.exp(it - m_new[..., None])
    f_g = torch.exp(log_f + m[..., None] - m_new[..., None])
    c = f_g * c.reshape(bsz, n_heads, hd) + i_g * torch.tanh(zt)
    n = f_g * n.reshape(bsz, n_heads, hd) + i_g
    h_new = torch.sigmoid(ot) * c / n.clamp_min(1.0)
    flat = lambda a: a.reshape(bsz, n_heads * hd)  # noqa: E731
    return (flat(c), flat(n), flat(h_new), m_new), flat(h_new)


def slstm_apply(params, cfg: XlstmCfg, x, *, state=None):
    """x: (B,S,D) -> (y, state)."""
    b, s, d = x.shape
    nh, hd = cfg.n_heads, cfg.s_head_dim
    xs = tuple(sharding.unflatten(core.dense(params[f"w{g}"], x).to(torch.float32), -1, (nh, hd))
               for g in GATES)
    r_all = torch.cat([val(params[f"r{g}"]).to(torch.float32) for g in GATES], dim=-1)
    if state is None:
        z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = (z, z, z, torch.full((b, nh), -1e30, dtype=torch.float32, device=x.device))
    y, *new_state = sharding.row_local(functools.partial(_slstm_rows, n_heads=nh, head_dim=hd),
                                       5, xs + tuple(state), (r_all,))
    y = y.to(x.dtype)
    y = core.rmsnorm(params["norm"], y)
    y = core.dense(params["ffn_down"], core.ACTIVATIONS["gelu"](core.dense(params["ffn_up"], y)))
    return y, tuple(new_state)


def _slstm_rows(xi, xf, xz, xo, c, n, h, m, r_all, *, n_heads, head_dim):
    """The sLSTM recurrence of each batch row over its (B, S, H, hd) input
    projections from state (c, n, h, m) -> (y (B, S, D), c, n, h, m)."""
    xs = tuple(a.transpose(0, 1) for a in (xi, xf, xz, xo))  # time leading
    new_state, ys = core.segmented_scan(
        functools.partial(_slstm_cell, r_all=r_all, n_heads=n_heads, head_dim=head_dim),
        (c, n, h, m), xs)
    return (ys.transpose(0, 1), *new_state)
