"""Decoder LM assembled from an ArchConfig: the homogeneous stack.

Mirror of ``src/repro/models/lm.py`` for the families that run the
(attention + FFN) stack: ``dense``, ``moe`` (the FFN an ``nn/moe.py``
layer, whose aux losses ``forward`` sums), ``vlm`` (a precomputed
patch-embedding prefix) and ``audio`` (frame embeddings in place of the
token embedding). The ``ssm`` (xLSTM) and ``hybrid`` (Zamba2) families
raise ``NotImplementedError`` naming their ROADMAP.md item; the hybrid's
ring-buffer attention comes with them.

With ``cfg.remat`` (the reference's ``jax.checkpoint`` of each block),
``forward`` under autograd runs each block through
``torch.utils.checkpoint`` (non-reentrant): the backward recomputes a
block's activations from its input, with the same ops and so the same
bits.

API (plain functions of a params tree of tensors, blocks stacked on a
leading layer axis as the reference's ``_stack``):
  init(gen, device=)                              -> params
  forward(params, tokens=None, embeds=None,
          frontend_embeds=None)                   -> (logits, aux)
  init_cache(batch, cache_len, dtype, device=)    -> cache (zeros)
  prefill(params, ..., )                          -> (last logits, cache)
  decode_step(params, cache, tokens/embeds, pos)  -> (logits, cache)

``decode_step`` writes the step's k/v into ``cache`` in place and
returns it (``nn/attention.py``); a ``pos`` at or past the cache length
raises ``ValueError`` where the reference's ``dynamic_update_slice``
would clamp it onto the last slot. ``pos`` is a Python int or a 0-d
integer tensor, which is never read back to the host when it lives on
the card.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, torch_dtype
from ..kernels.common import resolve_device
from ..nn import attention as attn_mod
from ..nn import core, embedding, mlp, moe
from ..tree import map_tree

STACK = ("dense", "moe", "vlm", "audio")
# the families whose layers are not ported yet, and where ROADMAP.md queues them
NOT_PORTED = {
    "ssm": "nn/xlstm.py (ROADMAP.md, queue 1, item 8c)",
    "hybrid": "nn/ssm.py and the ring-buffer attention (ROADMAP.md, queue 1, item 8d)",
}


def _norm_init(cfg: ArchConfig, dim: int, dtype, device):
    if cfg.norm == "rmsnorm":
        return core.rmsnorm_init(dim, dtype=dtype, device=device)
    return core.layernorm_init(dim, dtype=dtype, device=device)


def _norm(cfg: ArchConfig, p, x):
    return core.rmsnorm(p, x) if cfg.norm == "rmsnorm" else core.layernorm(p, x)


def _pad_vocab(v: int) -> int:
    """Pad the vocab to a 256 multiple, as the reference does for its
    sharded 'vocab' dim (e.g. minicpm's 122753 -> 122880). Pad logits are
    masked to -1e9 in ``_logits``; pad embedding rows are never gathered."""
    return ((v + 255) // 256) * 256


class LM:
    def __init__(self, cfg: ArchConfig):
        if cfg.family in NOT_PORTED:
            raise NotImplementedError(f"the {cfg.family} family's LM needs "
                                      f"{NOT_PORTED[cfg.family]}, not ported yet")
        if cfg.family not in STACK:
            raise ValueError(f"family {cfg.family} not built by LM")
        self.cfg = cfg
        self.vocab_padded = _pad_vocab(cfg.vocab_size) if cfg.vocab_size else 0
        self.pdtype = torch_dtype(cfg.param_dtype)
        self.adtype = torch_dtype(cfg.activation_dtype)
        self.attn_cfg = attn_mod.AttentionCfg(
            d_model=cfg.d_model,
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            qk_norm=cfg.qk_norm,
            rope_theta=cfg.rope_theta,
            bias=cfg.attn_bias,
            window=cfg.attn_window,
        )
        self.mlp_cfg = mlp.MlpCfg(cfg.d_model, cfg.d_ff, act=cfg.act, bias=cfg.attn_bias)
        self.moe_cfg = moe.MoeCfg(
            cfg.d_model,
            cfg.d_ff,
            n_experts=cfg.n_experts,
            top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
            d_ff_shared=cfg.d_ff_shared,
            d_ff_dense=cfg.d_ff_dense,
            act=cfg.act,
            w8_gather=cfg.w8_gather,
            ep_ff_data=cfg.ep_ff_data,
        ) if cfg.n_experts else None

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, *, device=None) -> dict:
        """Random params drawn from ``gen`` (on its device), moved to
        ``device`` (default: the card)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt, lead = self.pdtype, (cfg.n_layers,)
        p: dict = {"final_norm": _norm_init(cfg, cfg.d_model, dt, gen.device)}
        if cfg.vocab_size:
            p["embed"] = embedding.embed_init(gen, self.vocab_padded, cfg.d_model, dtype=dt)
            if not cfg.tie_embeddings:
                p["head"] = embedding.head_init(gen, cfg.d_model, self.vocab_padded, dtype=dt)

        def norm():  # one a layer, stacked
            return map_tree(lambda a: a.expand(lead + a.shape).clone(),
                            _norm_init(cfg, cfg.d_model, dt, gen.device))

        p["blocks"] = {
            "ln1": norm(),
            "attn": attn_mod.init(gen, self.attn_cfg, lead=lead, dtype=dt),
            "ln2": norm(),
        }
        if self.moe_cfg:
            p["blocks"]["moe"] = moe.init(gen, self.moe_cfg, lead=lead, dtype=dt)
        else:
            p["blocks"]["mlp"] = mlp.init(gen, self.mlp_cfg, lead=lead, dtype=dt)
        return map_tree(lambda a: a.to(dev), p)

    # ------------------------------------------------------------- embedding
    def _embed_in(self, params, tokens, embeds, frontend_embeds):
        if embeds is not None:  # audio stub: frame embeddings in
            x = embeds.to(self.adtype)
        else:
            x = embedding.embed(params["embed"], tokens).to(self.adtype)
        if frontend_embeds is not None:  # vlm stub: patch embeddings prefix
            x = torch.cat([frontend_embeds.to(self.adtype), x], dim=1)
        return x

    def _logits(self, params, x):
        """float32 logits (against a float32 copy of the head or the tied
        table), pad columns set to -1e9."""
        cfg = self.cfg
        x = x.to(torch.float32)
        if cfg.tie_embeddings:
            logits = embedding.logits(None, x, tied_table=params["embed"]["table"])
        else:
            logits = embedding.logits(params["head"], x)
        if self.vocab_padded != cfg.vocab_size:  # mask pad columns
            pad = torch.arange(self.vocab_padded, device=x.device) >= cfg.vocab_size
            logits = logits.masked_fill_(pad, -1e9)
        return logits

    def _layers(self, params) -> list[dict]:
        """The stacked blocks as one tree a layer (views). Each stacked leaf
        is unbound once: indexing it per layer would make autograd build a
        zero tensor the size of the whole stack for every layer's backward."""
        layers = map_tree(lambda a: a.unbind(0), params["blocks"])
        return [map_tree(lambda t, i=i: t[i], layers) for i in range(self.cfg.n_layers)]

    def _block(self, bp, x, positions, cache=None, pos=None):
        """One (attention + FFN) block -> (x, the attention's cache, the
        FFN's aux loss: an MoE layer's load-balancing loss, else None)."""
        cfg = self.cfg
        a, nc = attn_mod.apply(bp["attn"], self.attn_cfg, _norm(cfg, bp["ln1"], x),
                               positions=positions, cache=cache, cache_pos=pos)
        x = x + a
        h = _norm(cfg, bp["ln2"], x)
        if self.moe_cfg:
            f, aux = moe.apply(bp["moe"], self.moe_cfg, h)
        else:
            f, aux = mlp.apply(bp["mlp"], self.mlp_cfg, h), None
        return x + f, nc, aux

    # --------------------------------------------------------------- forward
    def forward(self, params, *, tokens=None, embeds=None, frontend_embeds=None):
        """Full-sequence forward (train / prefill math). -> (logits, aux);
        aux is the sum of the MoE layers' load-balancing losses (0 for a
        dense FFN)."""
        x = self._embed_in(params, tokens, embeds, frontend_embeds)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        block = self._block
        if self.cfg.remat and torch.is_grad_enabled():
            block = functools.partial(checkpoint, self._block, use_reentrant=False)
        for bp in self._layers(params):
            x, _, a_loss = block(bp, x, positions)
            if a_loss is not None:
                aux = aux + a_loss
        x = _norm(self.cfg, params["final_norm"], x)
        return self._logits(params, x), aux

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, cache_len: int, dtype=None, *, device=None) -> dict:
        """Zero k / v caches of (n_layers, batch, cache_len, n_kv_heads,
        head_dim) in ``dtype`` (default: the activation dtype) on
        ``device`` (default: the card)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        kw = dict(dtype=dtype or self.adtype, device=resolve_device(device))
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}

    # ----------------------------------------------------------- decode step
    def decode_step(self, params, cache: dict, *, tokens=None, embeds=None, pos=None):
        """One decode step. tokens: (B, S) (or embeds (B, S, D)), usually
        S = 1; ``pos``: the first new position. Writes into ``cache`` and
        returns (logits, cache)."""
        if pos is None:
            raise TypeError("decode_step needs pos")
        x = self._embed_in(params, tokens, embeds, None)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device) + pos
        for i, bp in enumerate(self._layers(params)):
            x, _, _ = self._block(bp, x, positions, {"k": cache["k"][i], "v": cache["v"][i]},
                                  pos)
        x = _norm(self.cfg, params["final_norm"], x)
        return self._logits(params, x), cache

    # --------------------------------------------------------------- prefill
    def prefill(self, params, *, tokens=None, embeds=None, frontend_embeds=None):
        """Process a full prompt; returns (last-position logits, live cache).

        The cache length equals the prompt length (callers append decode
        budget by padding the cache before stepping, or re-init a longer
        cache)."""
        x = self._embed_in(params, tokens, embeds, frontend_embeds)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        cache = self.init_cache(b, s, device=x.device)
        for i, bp in enumerate(self._layers(params)):
            x, nc, _ = self._block(bp, x, positions)
            cache["k"][i] = nc["k"]
            cache["v"][i] = nc["v"]
        x = _norm(self.cfg, params["final_norm"], x[:, -1:])
        return self._logits(params, x), cache
