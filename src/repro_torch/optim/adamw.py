"""AdamW with decoupled weight decay, global-norm clipping, configurable
moment dtype, and an optional *factored second moment* (Adafactor-style).

Mirror of ``src/repro/optim/adamw.py``, with its float32 arithmetic op for
op: the gradient cast to float32 and scaled by the clip factor, the bias
corrections ``1 - b ** step`` in float32, weight decay on every leaf, the
new parameter rounded to its own dtype. The factored mode stores row/col
running means instead of a full-size v.

State layout: m and v are flat lists in params-leaf order (``tree.leaves``:
dict keys sorted, as JAX orders them; v leaves are a tensor or a
{"row", "col"} dict in factored mode); ``step`` is an int32 tensor on the
params' device and the lr a function of it, so an update runs as tensor ops
on the device and reads nothing back to the host.

``update`` writes the new parameters and moments into the tensors it was
given, under ``torch.no_grad()`` (the counterpart of the reference's
``donate_argnums``: the old values are not kept), and returns the params
tree, a new state dict holding the same moment tensors and the new step,
and the stats.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import tree as tr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable  # step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32
    factored: bool = False  # Adafactor-style second moment for ndim>=2

    # ------------------------------------------------------------------ init
    def _is_factored(self, p) -> bool:
        return self.factored and p.ndim >= 2

    def _zeros(self, shape, p):
        return torch.zeros(shape, dtype=self.moment_dtype, device=p.device)

    def _v_init(self, p):
        if self._is_factored(p):
            return {"row": self._zeros(p.shape[:-1], p),
                    "col": self._zeros(p.shape[:-2] + p.shape[-1:], p)}
        return self._zeros(p.shape, p)

    def init(self, params):
        leaves = tr.leaves(params)
        return {
            "m": [self._zeros(p.shape, p) for p in leaves],
            "v": [self._v_init(p) for p in leaves],
            "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        }

    # ---------------------------------------------------------------- update
    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        g_leaves, p_leaves = tr.leaves(grads), tr.leaves(params)
        if len(g_leaves) != len(p_leaves):
            raise ValueError(f"{len(g_leaves)} gradients for {len(p_leaves)} params")
        gnorm = global_norm(grads)
        if self.clip_norm:
            clip = torch.full((), self.clip_norm, dtype=torch.float32, device=gnorm.device)
            scale = torch.clamp(clip / (gnorm + 1e-12), max=1.0)
        else:
            scale = 1.0
        b1, b2 = self.b1, self.b2
        lr = self.lr(step)
        step_f = step.to(torch.float32)
        bc1 = 1 - b1 ** step_f
        bc2 = 1 - b2 ** step_f

        for g, m, v, p in zip(g_leaves, state["m"], state["v"], p_leaves):
            g = g.to(torch.float32) * scale
            m2 = b1 * m.to(torch.float32) + (1 - b1) * g
            if isinstance(v, dict):  # factored second moment
                g2 = torch.square(g)
                row = b2 * v["row"].to(torch.float32) + (1 - b2) * torch.mean(g2, dim=-1)
                col = b2 * v["col"].to(torch.float32) + (1 - b2) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(row, dim=-1, keepdim=True), min=1e-30)
                vhat = (row / denom)[..., None] * col[..., None, :]
                v["row"].copy_(row)
                v["col"].copy_(col)
            else:
                vhat = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
                v.copy_(vhat)
            mhat = m2 / bc1
            vhat = vhat / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
            m.copy_(m2)

        new_state = {"m": state["m"], "v": state["v"], "step": step}
        return params, new_state, {"grad_norm": gnorm, "lr": lr}


def global_norm(tree) -> torch.Tensor:
    leaves = tr.leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32))) for l in leaves))
