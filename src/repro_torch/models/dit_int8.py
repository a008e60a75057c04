"""W8A8 int8 DiT serving step: the paper's plain A8W8 baseline, no Ditto.

Mirror of ``src/repro/models/dit_int8.py``. Weights are quantized per
output channel (int8 + float32 scales), activations per tensor,
dynamically; every linear runs as an int8 x int8 -> int32 product, and the
norms, softmax, modulation and activations stay float32. On the card the
product is the port's hand-written Hopper kernel,
``kernels/ops.py:int8_act_matmul`` -> ``csrc/int8_matmul.cu``, the kernel
the Ditto engine's act layers run; on the CPU its plain version. The
product is exact either way, so the two devices differ only where the
float32 glue does.

On DTensors (the sharded step: the batch split over the batch axes, the
int8 weights whole, as ``launch/steps.py:param_axes(int8=True)`` lays them
out) the float32 glue runs under DTensor's own rules, which keep the
batch split; each product runs on each rank's rows (:func:`int8_product`),
and each activation's per-tensor scale stays the whole batch's
(:func:`quantize_act`), so every rank computes the unsharded step's int8
operands and int32 products for its rows.

Kept from the reference: attention here applies no RoPE (``nn/dit.py``'s
``apply`` does), ``amax / 127`` and ``x / scale`` are true divisions
(``nn/core.py:divide``), rounding is half to even.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed import sharding
from ..kernels import ops
from ..nn import core as nncore
from ..nn import dit as dit_mod
from ..tree import map_tree


def quantize_params(params, cfg: dit_mod.DiTCfg):
    """bf16/fp32 DiT param tree -> int8 weights + scales (+fp bias/tables)."""

    def q(w):
        # per-output-channel scales; dim -2 is the input dim (weights may
        # carry a leading stacked-layer dim)
        w = w.to(torch.float32)
        scale = nncore.divide(torch.amax(torch.abs(w), dim=-2, keepdim=True), 127.0)
        scale = torch.where(scale > 0, scale, 1.0)
        qw = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return {"q": qw, "scale": scale}

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                if "w" in v:  # dense layer {w, b?}
                    out[k] = {"w8": q(nncore.val(v["w"]))}
                    if "b" in v:
                        out[k]["w8"]["b"] = nncore.val(v["b"]).to(torch.float32)
                else:
                    out[k] = walk(v)
            else:
                out[k] = nncore.val(v)
        return out

    with torch.no_grad():
        return walk(params)


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor dynamic int8 quantization: (x_q int8, scale float32).

    The scale is the whole tensor's, as ``jnp.max`` is global in the
    reference: on a DTensor whose rows are split, each rank's max is a
    pending max that one all-reduce of 4 bytes resolves (exact: a max does
    not depend on its order), and every rank rounds its rows with the same
    scale."""
    xf = x.to(torch.float32)
    amax = sharding.reduced(torch.amax(torch.abs(xf)))
    xs = torch.where(amax > 0, nncore.divide(amax, 127.0), 1.0)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def _product_rows(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    lead = xq.shape[:-1]
    y = ops.int8_act_matmul(xq.reshape(-1, xq.shape[-1]), wq)
    return y.reshape(lead + (wq.shape[-1],))


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int32, exact, through
    ``ops.int8_act_matmul`` (the kernel on the card). On DTensors (x's
    batch rows split over the batch axes, the weights whole, as
    ``param_axes(int8=True)`` lays them out) each rank multiplies its own
    rows under ``sharding.row_local``: it pads them to the tile, the
    wrapper sees plain tensors, and the result keeps x's row split."""
    return sharding.row_local(_product_rows, 1, rows=(xq,), shared=(wq,))


def _qdense(w8: dict, x: torch.Tensor) -> torch.Tensor:
    xq, xs = quantize_act(x)
    y = int8_product(xq, w8["q"])
    y = y.to(torch.float32) * xs * w8["scale"].reshape(-1)
    if "b" in w8:
        y = y + w8["b"]
    return y


def block(bp: dict, x: torch.Tensor, c_act: torch.Tensor, cfg: dit_mod.DiTCfg) -> torch.Tensor:
    """One DiT block on the int8 path: ``bp`` one layer's quantized params
    (a slice of ``quantize_params(...)["blocks"]``), x (B, T, d) float32,
    c_act (B, d) the activated conditioning. Every activation is quantized
    per tensor, so the result depends on the rows ``x`` holds."""
    b = x.shape[0]
    nh, hd = cfg.n_heads, cfg.head_dim
    # 1 / sqrt(hd) in float32 ops, as the reference computes it
    scale = float(1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))
    mod = _qdense(bp["mod"]["w8"], c_act)
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(mod, 6, dim=-1)
    h = dit_mod._modulate(dit_mod._ln(x), sh_a, sc_a)
    q = _qdense(bp["attn"]["wq"]["w8"], h).reshape(b, cfg.n_tokens, nh, hd)
    k = _qdense(bp["attn"]["wk"]["w8"], h).reshape(b, cfg.n_tokens, nh, hd)
    v = _qdense(bp["attn"]["wv"]["w8"], h).reshape(b, cfg.n_tokens, nh, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s, dim=-1)
    a = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, cfg.n_tokens, nh * hd)
    a = _qdense(bp["attn"]["wo"]["w8"], a)
    x = x + g_a[:, None, :] * a
    h = dit_mod._modulate(dit_mod._ln(x), sh_m, sc_m)
    hmid = nncore.ACTIVATIONS["gelu"](_qdense(bp["mlp"]["wi"]["w8"], h))
    return x + g_m[:, None, :] * _qdense(bp["mlp"]["wo"]["w8"], hmid)


def apply(qparams, cfg: dit_mod.DiTCfg, latents, t, labels=None):
    """Mirrors nn.dit.apply with every linear on the int8 path."""
    b, hh, ww, ch = latents.shape
    pp = cfg.patch
    x = latents.reshape(b, hh // pp, pp, ww // pp, pp, ch)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, cfg.n_tokens, cfg.patch_dim)
    x = _qdense(qparams["patch_embed"]["w8"], x) + qparams["pos_embed"].to(torch.float32)[None]

    c = dit_mod.timestep_embedding(t, 256)
    c = _qdense(qparams["t_mlp2"]["w8"], F.silu(_qdense(qparams["t_mlp1"]["w8"], c)))
    if labels is not None and "label_embed" in qparams:
        c = c + qparams["label_embed"].to(torch.float32)[labels]
    c_act = F.silu(c)

    layers = map_tree(lambda a: a.unbind(0), qparams["blocks"])
    x = x.to(torch.float32)
    for i in range(cfg.n_layers):  # the reference scans over the stacked blocks
        x = block(map_tree(lambda a: a[i], layers), x, c_act, cfg)

    modf = _qdense(qparams["final_mod"]["w8"], c_act)
    shift, scl = torch.chunk(modf, 2, dim=-1)
    x = dit_mod._modulate(dit_mod._ln(x), shift, scl)
    x = _qdense(qparams["final_out"]["w8"], x)
    x = x.reshape(b, hh // pp, ww // pp, pp, pp, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hh, ww, ch)
