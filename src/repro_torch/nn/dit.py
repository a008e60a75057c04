"""DiT (Diffusion Transformer) building blocks — the paper's own arch family.

Mirror of ``src/repro/nn/dit.py``: adaLN-Zero conditioning per Peebles &
Xie. Each block receives a conditioning vector c (timestep [+ class]) and
produces shift/scale/gate for both branches; the final layer is adaLN +
a linear to patch pixels. ``apply`` is the fp32 oracle of the quantized
serving path. Layouts follow the reference: latents (B, H, W, C), dense
weights (in, out), per-block params stacked on a leading layer axis.

Numerics kept from the reference: ``_ln`` uses the population variance
(``correction=0``), GELU is the tanh form, and ``timestep_embedding``
concatenates ``[cos, sin]``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels.common import resolve_device
from ..tree import map_tree
from . import attention as attn
from . import core, mlp
from .core import val


@dataclasses.dataclass(frozen=True)
class DiTCfg:
    d_model: int
    n_layers: int
    n_heads: int
    patch: int = 2
    in_channels: int = 4
    input_size: int = 32  # latent H=W
    mlp_ratio: float = 4.0
    n_classes: int = 0  # 0 = unconditional

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_tokens(self) -> int:
        return (self.input_size // self.patch) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * self.in_channels


#: DiT-XL/2 (Peebles & Xie; the dims of ``src/repro/configs/dit_xl2.py``):
#: 28 blocks, d = 1152, 16 heads of 72, MLP 4608, patch 2 over 32x32x4
#: latents (256 tokens), 1000 classes.
DIT_XL2 = DiTCfg(d_model=1152, n_layers=28, n_heads=16, patch=2, in_channels=4,
                 input_size=32, n_classes=1000)


def _attn_cfg(cfg: DiTCfg) -> attn.AttentionCfg:
    return attn.AttentionCfg(cfg.d_model, cfg.n_heads, cfg.n_heads, cfg.head_dim,
                             causal=False, bias=True)


def _mlp_cfg(cfg: DiTCfg) -> mlp.MlpCfg:
    return mlp.MlpCfg(cfg.d_model, int(cfg.mlp_ratio * cfg.d_model), act="gelu", bias=True)


def timestep_embedding(t: torch.Tensor, dim: int, *, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of (B,) timesteps -> (B, dim). float32."""
    half = dim // 2
    freqs = torch.exp(core.divide(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device),
        float(half)))
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def init(gen: torch.Generator, cfg: DiTCfg, *, device=None, dtype=torch.float32) -> dict:
    """Random DiT params drawn from ``gen`` (on its device), moved to
    ``device`` (default: the card). adaLN-Zero: every block's ``mod``
    projection starts at zero, as in the reference."""
    dev = resolve_device(device)
    d = cfg.d_model
    p: dict = {
        "patch_embed": core.dense_init(gen, cfg.patch_dim, d, bias=True, axes=(None, "embed"),
                                       dtype=dtype),
        "pos_embed": core.tag(core.normal_init(gen, (cfg.n_tokens, d), stddev=0.02, dtype=dtype),
                              (None, "embed")),
        "t_mlp1": core.dense_init(gen, 256, d, bias=True, axes=(None, "embed"), dtype=dtype),
        "t_mlp2": core.dense_init(gen, d, d, bias=True, axes=("embed", "embed2"), dtype=dtype),
        "final_mod": core.dense_init(gen, d, 2 * d, bias=True, axes=("embed", None),
                                     dtype=dtype),
        "final_out": core.dense_init(gen, d, cfg.patch_dim, bias=True, axes=("embed", None),
                                     dtype=dtype),
    }
    if cfg.n_classes:
        p["label_embed"] = core.tag(core.normal_init(gen, (cfg.n_classes + 1, d), stddev=0.02,
                                                     dtype=dtype), (None, "embed"))
    lead = (cfg.n_layers,)  # stacked per-layer params
    p["blocks"] = {
        "attn": attn.init(gen, _attn_cfg(cfg), lead=lead, dtype=dtype),
        "mlp": mlp.init(gen, _mlp_cfg(cfg), lead=lead, dtype=dtype),
        "mod": core.dense_init(gen, d, 6 * d, bias=True, axes=("embed", None),
                               init=core.zeros_init, lead=lead, dtype=dtype),
    }
    return map_tree(lambda a: a.to(dev), p)


def label_rows(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``table[labels]`` as a one-hot product. The product has the gather's
    bits (one term of each sum is not zero; TF32 stays off, PyTorch's
    default), and its backward is a product too, where the gather's
    backward adds rows with atomics, in an order that changes from run to
    run on the card. The one-hot rows are a comparison with ``arange``:
    ``F.one_hot`` runs other ops on the card than on fake tensors, so the
    step analyzer's dry run would not count the card's ops."""
    classes = torch.arange(table.shape[0], device=labels.device)
    return (labels.to(torch.int64)[..., None] == classes).to(table.dtype) @ table


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _ln(x, eps=1e-6):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def block_apply(bp: dict, cfg: DiTCfg, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One DiT block. x: (B,T,D), c: (B,D)."""
    mod = core.dense(bp["mod"], F.silu(c))
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(mod, 6, dim=-1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    h = _modulate(_ln(x), sh_a, sc_a)
    a, _ = attn.apply(bp["attn"], _attn_cfg(cfg), h, positions=positions)
    x = x + g_a[:, None, :] * a
    h = _modulate(_ln(x), sh_m, sc_m)
    return x + g_m[:, None, :] * mlp.apply(bp["mlp"], _mlp_cfg(cfg), h)


def apply(params: dict, cfg: DiTCfg, latents: torch.Tensor, t: torch.Tensor,
          labels: torch.Tensor | None = None) -> torch.Tensor:
    """latents: (B, H, W, C) -> predicted noise (B, H, W, C). t: (B,)."""
    b, hh, ww, ch = latents.shape
    pp = cfg.patch
    x = latents.reshape(b, hh // pp, pp, ww // pp, pp, ch)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, cfg.n_tokens, cfg.patch_dim)
    x = core.dense(params["patch_embed"], x) + val(params["pos_embed"]).to(latents.dtype)[None]

    c = timestep_embedding(t, 256)
    c = core.dense(params["t_mlp2"], F.silu(core.dense(params["t_mlp1"], c.to(latents.dtype))))
    if labels is not None and "label_embed" in params:
        c = c + label_rows(val(params["label_embed"]).to(latents.dtype), labels)

    # the reference scans over the stacked blocks; each stacked leaf is
    # unbound once (indexing it per layer would make autograd build a
    # zero tensor the size of the whole stack for every layer's backward)
    layers = map_tree(lambda a: val(a).unbind(0), params["blocks"])
    for i in range(cfg.n_layers):
        x = block_apply(map_tree(lambda a: a[i], layers), cfg, x, c)

    mod = core.dense(params["final_mod"], F.silu(c))
    shift, scale = torch.chunk(mod, 2, dim=-1)
    x = _modulate(_ln(x), shift, scale)
    x = core.dense(params["final_out"], x)  # (B, T, patch_dim)
    x = x.reshape(b, hh // pp, ww // pp, pp, pp, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hh, ww, ch)
