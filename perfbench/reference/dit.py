"""Plain PyTorch reference of quantised DiT serving: the DiT forward
(Peebles & Xie, arXiv:2212.09748) with every linear layer and both
attention products run as symmetric integer products, and the DDIM loop.

It stands alone: it imports torch and nothing of the program under test,
and it takes only the float weights, noise and labels the benchmark made.
Whatever the program derives from them (quantised weights, scales, modes,
temporal state) is worked out again here.

Quantisation (Ditto, arXiv:2406.06620 §IV, with ``bits`` = 8):

* weights: per output channel, scale = max|w| / qmax, q = round(w / s)
  (half to even), clipped to +-qmax;
* activations of a linear layer: one scale a sample, max|x| / qmax over
  the sample's rows, fixed at the first denoising step and held for the
  rest of the sample (values beyond it clip);
* attention products (Q K^T and P V): one scale a (sample, head) for each
  operand, fixed at the first step as well;
* integer products are exact (float64 sums of integers far below 2**53);
  the product is rescaled in float32, (y * s_x) * s_w, plus the bias.

A temporal-difference step computes y_prev + dq @ W, which is W @ q
exactly, so the reference needs no temporal state, no Defo mode and no
tile classes: only the held scales. Everything else (patch embedding,
timestep and label conditioning, layer norm, modulation, softmax, GELU,
residuals, DDIM) runs in float32 with TF32 off.

``bits=4`` is the control: the same model with every product in int4
(qmax 7), the precision below the configuration's int8.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# Rows of one conditioning product block: a matrix product with one row a
# sample is run in zero-padded blocks of this many rows, so a row's float32
# bits do not depend on how many rows came with it.
ROW_BLOCK = 16


def linear_schedule_alpha_bars(T: int, beta_start: float, beta_end: float, device) -> torch.Tensor:
    """cumprod(1 - beta) of the linear schedule, float32."""
    betas = torch.linspace(beta_start, beta_end, T, dtype=torch.float32).to(device)
    return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps(T: int, steps: int) -> list[int]:
    stride = max(T // steps, 1)
    return list(range(0, T, stride))[:steps][::-1]


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """A true division by a scalar (CUDA multiplies by the reciprocal for a
    Python scalar divisor, which can differ in the last bit)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _scale(x: torch.Tensor, qmax: int, dim) -> torch.Tensor:
    amax = x.to(torch.float32).abs().amax(dim=dim, keepdim=True)
    return torch.where(amax > 0, _div(amax, float(qmax)), torch.ones_like(amax))


def _quant(x: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """Integer values as float64 (exact products follow)."""
    return torch.round(x.to(torch.float32) / scale).clamp(-qmax, qmax).to(torch.float64)


def _per_sample_scale(x: torch.Tensor, n: int, qmax: int) -> torch.Tensor:
    """(rows, 1, ...) scale from each of ``n`` equal row groups of ``x``."""
    s = _scale(x.reshape(n, -1), qmax, 1)
    return s.repeat_interleave(x.shape[0] // n, dim=0).reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def _dense(w: torch.Tensor, b: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """Float32 x @ w (+ b); a 2-D x in ROW_BLOCK-row blocks."""
    if x.dim() == 2:
        m = x.shape[0]
        blocks = F.pad(x, (0, 0, 0, -m % ROW_BLOCK)).split(ROW_BLOCK)
        y = torch.cat([blk @ w for blk in blocks])[:m]
    else:
        y = x @ w
    return y if b is None else y + b


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(_div(-math.log(max_period)
                           * torch.arange(half, dtype=torch.float32, device=t.device), float(half)))
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class QuantDiT:
    """The quantised DiT over one batch of samples, scales held from its
    first call (the first denoising step). ``model`` is the benchmark's
    config (hidden_size, depth, num_heads, patch_size, in_channels,
    input_size); ``weights`` the float weights tree."""

    def __init__(self, weights: dict, model: dict, bits: int = 8):
        self.w = weights
        self.d = model["hidden_size"]
        self.depth = model["depth"]
        self.heads = model["num_heads"]
        self.patch = model["patch_size"]
        self.size = model["input_size"]
        self.ch = model["in_channels"]
        self.tokens = (self.size // self.patch) ** 2
        self.qmax = 2 ** (bits - 1) - 1
        self.wq: dict[str, tuple] = {}  # layer -> (float64 int weight, scale)
        self.scales: dict[str, tuple] = {}  # layer -> held activation scales

    def _weight(self, name: str, w: torch.Tensor):
        hit = self.wq.get(name)
        if hit is None:
            s = _scale(w, self.qmax, 0)  # (1, N)
            hit = self.wq[name] = (_quant(w, s, self.qmax), s.reshape(-1))
        return hit

    def linear(self, name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
        x2 = x.reshape(-1, x.shape[-1])
        if name not in self.scales:
            self.scales[name] = (_per_sample_scale(x2, x.shape[0], self.qmax),)
        (sx,) = self.scales[name]
        wq, sw = self._weight(name, w)
        y = (_quant(x2, sx, self.qmax) @ wq).to(torch.float32) * sx * sw[None, :] + b
        return y.reshape(x.shape[:-1] + (w.shape[1],))

    def product(self, name: str, a: torch.Tensor, b: torch.Tensor):
        """a @ b^T over (n, M, D) x (n, N, D), a scale a leading element."""
        if name not in self.scales:
            self.scales[name] = (_per_sample_scale(a, a.shape[0], self.qmax),
                                 _per_sample_scale(b, b.shape[0], self.qmax))
        sa, sb = self.scales[name]
        y = _quant(a, sa, self.qmax) @ _quant(b, sb, self.qmax).transpose(-1, -2)
        return y.to(torch.float32) * sa * sb

    def __call__(self, latents: torch.Tensor, t: torch.Tensor, labels: torch.Tensor):
        w, d, nh = self.w, self.d, self.heads
        hd = d // nh
        b, hh, ww, ch = latents.shape
        p, n = self.patch, self.tokens
        x = latents.reshape(b, hh // p, p, ww // p, p, ch).permute(0, 1, 3, 2, 4, 5)
        x = _dense(w["patch_embed"]["w"], w["patch_embed"]["b"], x.reshape(b, n, p * p * ch))
        x = x + w["pos_embed"][None]
        c = timestep_embedding(t)
        c = _dense(w["t_mlp1"]["w"], w["t_mlp1"]["b"], c)
        c = _dense(w["t_mlp2"]["w"], w["t_mlp2"]["b"], F.silu(c))
        c = c + w["label_embed"][labels]
        c_act = F.silu(c)
        blk = w["blocks"]
        att, mlp = blk["attn"], blk["mlp"]
        scale = 1.0 / math.sqrt(hd)
        for i in range(self.depth):
            pre = f"blk{i}"
            mod = self.linear(f"{pre}.mod", c_act, blk["mod"]["w"][i], blk["mod"]["b"][i])
            sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(mod, 6, dim=-1)
            h = _modulate(_ln(x), sh_a, sc_a)
            heads = []
            for nm in ("wq", "wk", "wv"):
                y = self.linear(f"{pre}.{nm}", h, att[nm]["w"][i], att[nm]["b"][i])
                heads.append(y.reshape(b, n, nh, hd).permute(0, 2, 1, 3).reshape(b * nh, n, hd))
            q, k, v = heads
            probs = torch.softmax(self.product(f"{pre}.qk", q, k) * scale, dim=-1)
            av = self.product(f"{pre}.pv", probs, v.transpose(-1, -2))
            av = av.reshape(b, nh, n, hd).permute(0, 2, 1, 3).reshape(b, n, d)
            x = x + g_a[:, None, :] * self.linear(f"{pre}.wo", av, att["wo"]["w"][i],
                                                  att["wo"]["b"][i])
            h = _modulate(_ln(x), sh_m, sc_m)
            hmid = F.gelu(self.linear(f"{pre}.wi", h, mlp["wi"]["w"][i], mlp["wi"]["b"][i]),
                          approximate="tanh")
            x = x + g_m[:, None, :] * self.linear(f"{pre}.wd", hmid, mlp["wo"]["w"][i],
                                                  mlp["wo"]["b"][i])
        modf = _dense(w["final_mod"]["w"], w["final_mod"]["b"], c_act)
        shift, scl = torch.chunk(modf, 2, dim=-1)
        x = _modulate(_ln(x), shift, scl)
        x = self.linear("final.out", x, w["final_out"]["w"], w["final_out"]["b"])
        x = x.reshape(b, hh // p, ww // p, p, p, ch).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, hh, ww, ch)


def sample(weights: dict, model: dict, schedule: dict, steps: int, x_T: torch.Tensor,
           labels: torch.Tensor, *, bits: int = 8) -> torch.Tensor:
    """DDIM (eta = 0) from ``x_T`` over ``steps`` steps: the final latents."""
    dev = x_T.device
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        abars = linear_schedule_alpha_bars(schedule["T"], schedule["beta_start"],
                                           schedule["beta_end"], dev)
        net = QuantDiT(weights, model, bits)
        ts = ddim_timesteps(schedule["T"], steps)
        x = x_T
        for i, t in enumerate(ts):
            t_prev = ts[i + 1] if i + 1 < len(ts) else -1
            eps = net(x, torch.full((x.shape[0],), t, dtype=torch.int32, device=dev), labels)
            abar_t = abars[t]
            abar_p = abars[t_prev] if t_prev >= 0 else torch.ones((), dtype=abars.dtype,
                                                                   device=dev)
            x0 = (x - torch.sqrt(1 - abar_t) * eps) / torch.sqrt(abar_t)
            x = torch.sqrt(abar_p) * x0 + torch.sqrt(1 - abar_p) * eps
        return x
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev_tf32
