"""Decoder LM assembled from an ArchConfig.

Mirror of ``src/repro/models/lm.py``. Families:

* ``dense``, ``moe``, ``vlm``, ``audio``: the homogeneous (attention +
  FFN) stack. ``moe``'s FFN is an ``nn/moe.py`` layer, whose aux losses
  ``forward`` sums; ``vlm`` takes a precomputed patch-embedding prefix;
  ``audio`` takes frame embeddings in place of the token embedding.
* ``ssm`` (xLSTM): super-blocks of ``per_super`` mLSTM layers and one
  sLSTM layer (``nn/xlstm.py``), stacked on (n_super, per_super) and
  (n_super,) leading dims.
* ``hybrid`` (Zamba2): super-blocks of ``per_super`` Mamba2 layers
  (``nn/ssm.py``) and one application of a *shared* attention + MLP
  block (one set of weights, whose gradients autograd sums over its
  applications), then ``n_trailing`` Mamba2 layers. Its decode attends
  over a ring buffer of ``min(attn_window, cache_len)`` slots.

With ``cfg.remat`` (the reference's ``jax.checkpoint``), ``forward``
under autograd runs each block (each super-block; in the hybrid each
Mamba2 layer too) through ``torch.utils.checkpoint`` (non-reentrant):
the backward recomputes a block's activations from its input, with the
same ops and so the same bits.

API (plain functions of a params tree of tensors, layers stacked on
leading dims as the reference's ``_stack``):
  init(gen, device=)                              -> params
  forward(params, tokens=None, embeds=None,
          frontend_embeds=None)                   -> (logits, aux)
  init_cache(batch, cache_len, dtype, device=)    -> cache (zeros; the
                                                     recurrent states' m at -1e30,
                                                     the ring's positions at -1)
  prefill(params, ..., )                          -> (last logits, cache)
  decode_step(params, cache, tokens/embeds, pos)  -> (logits, cache)

``LM(cfg, shard=)`` takes the reference's sharding constraint (the
identity by default): ``forward`` lays the embedded tokens out on
('batch', None, None) and every MoE layer takes it (``nn/moe.py``). With a
``distributed/sharding.py:ShardFn`` the params and inputs are DTensors:
each method runs under ``sharding.replicating`` (a tensor the model makes
itself is replicated), and ``init_cache`` allocates each cache tensor in
its layout of ``cache_shardings_dict``, block by block.

``decode_step`` writes the step into ``cache`` in place and returns it:
the stack's k / v (``nn/attention.py``), the recurrent states, and the
ring's k / v and positions at slot ``pos % W``. In the stack a ``pos`` at
or past the cache length raises ``ValueError`` where the reference's
``dynamic_update_slice`` would clamp it onto the last slot; the ring and
the recurrent states have no end, so their decode never raises. ``pos`` is
a Python int or a 0-d integer tensor, which is never read back to the
host when it lives on the card.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, torch_dtype
from ..distributed import sharding
from ..kernels.common import resolve_device
from ..nn import attention as attn_mod
from ..nn import core, embedding, mlp, moe, ssm, xlstm
from ..nn.rotary import apply_rope
from ..tree import map_tree

STACK = ("dense", "moe", "vlm", "audio")
RECURRENT = ("ssm", "hybrid")
# the cache's recurrent states: an mLSTM's (C, n, m), an sLSTM's (c, n, h, m)
M_KEYS, S_KEYS = ("m_C", "m_n", "m_m"), ("s_c", "s_n", "s_h", "s_m")


def _norm_init(cfg: ArchConfig, dim: int, dtype, device, lead: tuple = ()):
    if cfg.norm == "rmsnorm":
        return core.rmsnorm_init(dim, lead=lead, dtype=dtype, device=device)
    return core.layernorm_init(dim, lead=lead, dtype=dtype, device=device)


def _norm(cfg: ArchConfig, p, x):
    return core.rmsnorm(p, x) if cfg.norm == "rmsnorm" else core.layernorm(p, x)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a tree stacked on its leading dim, one tree a
    layer (views). Each stacked leaf is unbound once: indexing it per layer
    would make autograd build a zero tensor the size of the whole stack for
    every layer's backward. Applied again to each layer's tree, it unbinds
    a second leading dim (super-block, then layer)."""
    layers = map_tree(lambda a: a.unbind(0), tree)
    return [map_tree(lambda t, i=i: t[i], layers) for i in range(n)]


def _write(olds, news) -> None:
    """Copy each layer's new state tensors into the cache views they replace."""
    for old, new in zip(olds, news):
        for o, n in zip(old, new):
            o.copy_(n)


def _maybe_remat(fn, remat: bool):
    return functools.partial(checkpoint, fn, use_reentrant=False) if remat else fn


def _pad_vocab(v: int) -> int:
    """Pad the vocab to a 256 multiple, as the reference does for its
    sharded 'vocab' dim (e.g. minicpm's 122753 -> 122880). Pad logits are
    masked to -1e9 in ``_logits``; pad embedding rows are never gathered."""
    return ((v + 255) // 256) * 256


class LM:
    def __init__(self, cfg: ArchConfig, *, shard=None):
        if cfg.family not in STACK + RECURRENT:
            raise ValueError(f"family {cfg.family} not built by LM")
        self.cfg = cfg
        self.shard = shard or sharding.no_shard
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
        self.xl_cfg = xlstm.XlstmCfg(cfg.d_model, n_heads=cfg.n_heads) if cfg.family == "ssm" \
            else None
        self.mamba_cfg = ssm.MambaCfg(cfg.d_model, d_state=cfg.ssm_state,
                                      head_dim=cfg.ssm_head_dim) if cfg.family == "hybrid" else None

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, *, device=None) -> dict:
        """Random params drawn from ``gen`` (on its device), moved to
        ``device`` (default: the card)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = self.pdtype
        p: dict = {"final_norm": _norm_init(cfg, cfg.d_model, dt, gen.device)}
        if cfg.vocab_size:
            p["embed"] = embedding.embed_init(gen, self.vocab_padded, cfg.d_model, dtype=dt)
            if not cfg.tie_embeddings:
                p["head"] = embedding.head_init(gen, cfg.d_model, self.vocab_padded, dtype=dt)

        def norm(lead):  # one a layer, stacked
            return _norm_init(cfg, cfg.d_model, dt, gen.device, lead)

        if cfg.family in STACK:
            lead = (cfg.n_layers,)
            p["blocks"] = {
                "ln1": norm(lead),
                "attn": attn_mod.init(gen, self.attn_cfg, lead=lead, dtype=dt),
                "ln2": norm(lead),
            }
            if self.moe_cfg:
                p["blocks"]["moe"] = moe.init(gen, self.moe_cfg, lead=lead, dtype=dt)
            else:
                p["blocks"]["mlp"] = mlp.init(gen, self.mlp_cfg, lead=lead, dtype=dt)
        elif cfg.family == "ssm":  # supers of (per_super mLSTM + 1 sLSTM)
            ms, ss = (cfg.n_super, cfg.per_super), (cfg.n_super,)
            p["mlstm"] = {"ln": norm(ms),
                          "cell": xlstm.mlstm_init(gen, self.xl_cfg, lead=ms, dtype=dt)}
            p["slstm"] = {"ln": norm(ss),
                          "cell": xlstm.slstm_init(gen, self.xl_cfg, lead=ss, dtype=dt)}
        else:  # hybrid: supers of (per_super Mamba2 + the shared block), then trailing
            ms = (cfg.n_super, cfg.per_super)
            p["mamba"] = {"ln": norm(ms), "cell": ssm.init(gen, self.mamba_cfg, lead=ms, dtype=dt)}
            if cfg.n_trailing:
                ts = (cfg.n_trailing,)
                p["trailing"] = {"ln": norm(ts),
                                 "cell": ssm.init(gen, self.mamba_cfg, lead=ts, dtype=dt)}
            p["shared_attn"] = {
                "ln1": norm(()),
                "attn": attn_mod.init(gen, self.attn_cfg, dtype=dt),
                "ln2": norm(()),
                "mlp": mlp.init(gen, self.mlp_cfg, dtype=dt),
            }
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
        """The stacked blocks as one tree a layer (views)."""
        return _unstack(params["blocks"], self.cfg.n_layers)

    def _block(self, bp, x, positions, cache=None, pos=None):
        """One (attention + FFN) block -> (x, the attention's cache, the
        FFN's aux loss: an MoE layer's load-balancing loss, else None)."""
        cfg = self.cfg
        a, nc = attn_mod.apply(bp["attn"], self.attn_cfg, _norm(cfg, bp["ln1"], x),
                               positions=positions, cache=cache, cache_pos=pos)
        x = x + a
        h = _norm(cfg, bp["ln2"], x)
        if self.moe_cfg:
            f, aux = moe.apply(bp["moe"], self.moe_cfg, h, shard=self.shard)
        else:
            f, aux = mlp.apply(bp["mlp"], self.mlp_cfg, h), None
        return x + f, nc, aux

    # ------------------------------------------------- the recurrent stacks
    def _xlstm(self, params, x, cache=None, remat=False):
        """The xLSTM super-blocks over x -> x. With ``cache``, each layer
        starts from the cache's state and its final state is written back
        into the cache (prefill: the zero states of ``init_cache``; decode:
        the live ones)."""
        cfg, xc = self.cfg, self.xl_cfg

        def super_body(x, mps, sp, m_states, s_state):
            new = []
            for bp, st in zip(mps, m_states):
                y, st = xlstm.mlstm_apply(bp["cell"], xc, _norm(cfg, bp["ln"], x), state=st)
                x = x + y
                new.append(st)
            y, st = xlstm.slstm_apply(sp["cell"], xc, _norm(cfg, sp["ln"], x), state=s_state)
            return x + y, new, st

        body = _maybe_remat(super_body, remat)
        for i, (mps, sp) in enumerate(zip(
                [_unstack(t, cfg.per_super) for t in _unstack(params["mlstm"], cfg.n_super)],
                _unstack(params["slstm"], cfg.n_super))):
            if cache is None:
                x, _, _ = body(x, mps, sp, [None] * cfg.per_super, None)
                continue
            m_old = [tuple(cache[k][i, j] for k in M_KEYS) for j in range(cfg.per_super)]
            s_old = tuple(cache[k][i] for k in S_KEYS)
            x, m_new, s_new = body(x, mps, sp, m_old, s_old)
            _write(m_old + [s_old], m_new + [s_new])
        return x

    def _zamba(self, params, x, positions, cache=None, pos=None, remat=False):
        """The Zamba2 super-blocks and trailing layers over x -> x. Without
        ``cache``: the forward (the shared attention causal over ``positions``,
        within the window). With ``cache`` and no ``pos``: the prefill, which
        writes the final Mamba2 states and the last ``W`` keys / values
        (``_ring_from_full``) into the cache. With ``pos``: a decode step over
        the ring (``_ring_attend``)."""
        cfg, mc, sa = self.cfg, self.mamba_cfg, params["shared_attn"]

        def m_body(x, bp, st):
            y, new = ssm.apply(bp["cell"], mc, _norm(cfg, bp["ln"], x),
                               state=None if st is None else st[0],
                               conv_state=None if st is None else st[1])
            return x + y, new

        m_fn = _maybe_remat(m_body, remat)

        def super_body(x, mps, states, ring):
            new = []
            for bp, st in zip(mps, states):
                x, st = m_fn(x, bp, st)
                new.append(st)
            h = _norm(cfg, sa["ln1"], x)
            if pos is None:
                a, kv = attn_mod.apply(sa["attn"], self.attn_cfg, h, positions=positions)
            else:
                a, kv = _ring_attend(sa["attn"], self.attn_cfg, h, *ring, pos), None
            x = x + a
            x = x + mlp.apply(sa["mlp"], self.mlp_cfg, _norm(cfg, sa["ln2"], x))
            return x, new, kv

        body = _maybe_remat(super_body, remat)
        for i, mps in enumerate(_unstack(params["mamba"], cfg.n_super)):
            mps = _unstack(mps, cfg.per_super)
            if cache is None:
                x, _, _ = body(x, mps, [None] * cfg.per_super, None)
                continue
            old = [(cache["m_h"][i, j], cache["m_conv"][i, j]) for j in range(cfg.per_super)]
            ring = (cache["a_k"][i], cache["a_v"][i], cache["a_p"][i])
            x, new, kv = body(x, mps, old, ring)
            _write(old, new)
            if kv is not None:  # prefill: the ring of the prompt's last W positions
                _write([ring], [_ring_from_full(kv["k"].to(self.adtype), kv["v"].to(self.adtype),
                                               ring[0].shape[1])])
        if cfg.n_trailing:
            for j, bp in enumerate(_unstack(params["trailing"], cfg.n_trailing)):
                if cache is None:
                    x, _ = m_fn(x, bp, None)
                    continue
                old = (cache["t_h"][j], cache["t_conv"][j])
                x, new = m_fn(x, bp, old)
                _write([old], [new])
        return x

    # --------------------------------------------------------------- forward
    def forward(self, params, *, tokens=None, embeds=None, frontend_embeds=None):
        """Full-sequence forward (train / prefill math). -> (logits, aux);
        aux is the sum of the MoE layers' load-balancing losses (0 for a
        dense FFN and the recurrent families)."""
        with sharding.replicating(self.shard):
            return self._forward(params, tokens, embeds, frontend_embeds)

    def _forward(self, params, tokens, embeds, frontend_embeds):
        cfg = self.cfg
        x = self._embed_in(params, tokens, embeds, frontend_embeds)
        x = self.shard(x, ("batch", None, None))
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        if cfg.family == "ssm":
            x = self._xlstm(params, x, remat=remat)
        elif cfg.family == "hybrid":
            x = self._zamba(params, x, positions, remat=remat)
        else:
            block = _maybe_remat(self._block, remat)
            for bp in self._layers(params):
                x, _, a_loss = block(bp, x, positions)
                if a_loss is not None:
                    aux = aux + a_loss
        x = _norm(cfg, params["final_norm"], x)
        return self._logits(params, x), aux

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, cache_len: int, dtype=None, *, device=None) -> dict:
        """The decode cache on ``device`` (default: the card), as the
        reference lays it out. The stack: zero k / v of (n_layers, batch,
        cache_len, n_kv_heads, head_dim) in ``dtype`` (default: the
        activation dtype). ``ssm``: the float32 mLSTM / sLSTM states, their
        stabilizers ``m`` at -1e30. ``hybrid``: the float32 Mamba2 and conv
        states, and a ring of ``W = min(attn_window, cache_len)`` slots for
        each super-block's shared attention (k / v in ``dtype``, ``a_p`` the
        position a slot holds, -1 when empty, one row a super-block shared
        by the batch). Where ``shard`` lays tensors out on a mesh, each is a
        DTensor allocated in its layout of
        ``distributed/sharding.py:cache_shardings_dict``."""
        dev = resolve_device(device)
        specs = self._cache_specs(batch, cache_len, dtype or self.adtype)
        mesh = getattr(self.shard, "mesh", None)
        if mesh is None:
            return {k: torch.full(shape, fill, dtype=dt, device=dev)
                    for k, (shape, fill, dt) in specs.items()}
        lays = sharding.cache_shardings_dict(
            self.cfg, mesh, self.shard.rules,
            {k: torch.empty(shape, device="meta") for k, (shape, _, _) in specs.items()})
        return {k: sharding.full(shape, fill, dt, lays[k], dev)
                for k, (shape, fill, dt) in specs.items()}

    def _cache_specs(self, batch: int, cache_len: int, dt) -> dict:
        """(shape, fill, dtype) of each tensor of the cache."""
        cfg = self.cfg
        hd, kvh, f32 = cfg.resolved_head_dim, cfg.n_kv_heads, torch.float32
        if cfg.family == "ssm":
            xc, ns, ps = self.xl_cfg, cfg.n_super, cfg.per_super
            return {
                "m_C": ((ns, ps, batch, xc.n_heads, xc.head_dim, xc.head_dim), 0.0, f32),
                "m_n": ((ns, ps, batch, xc.n_heads, xc.head_dim), 0.0, f32),
                "m_m": ((ns, ps, batch, xc.n_heads), -1e30, f32),
                "s_c": ((ns, batch, cfg.d_model), 0.0, f32),
                "s_n": ((ns, batch, cfg.d_model), 0.0, f32),
                "s_h": ((ns, batch, cfg.d_model), 0.0, f32),
                "s_m": ((ns, batch, xc.n_heads), -1e30, f32),
            }
        if cfg.family == "hybrid":
            mc, ns, ps = self.mamba_cfg, cfg.n_super, cfg.per_super
            w = min(cfg.attn_window or cache_len, cache_len)
            conv_dim = mc.d_inner + 2 * mc.n_groups * mc.d_state
            specs = {
                "m_h": ((ns, ps, batch, mc.n_heads, mc.head_dim, mc.d_state), 0.0, f32),
                "m_conv": ((ns, ps, batch, mc.conv_width - 1, conv_dim), 0.0, f32),
                "a_k": ((ns, batch, w, kvh, hd), 0.0, dt),
                "a_v": ((ns, batch, w, kvh, hd), 0.0, dt),
                "a_p": ((ns, w), -1, torch.int32),
            }
            if cfg.n_trailing:
                nt = cfg.n_trailing
                specs["t_h"] = ((nt, batch, mc.n_heads, mc.head_dim, mc.d_state), 0.0, f32)
                specs["t_conv"] = ((nt, batch, mc.conv_width - 1, conv_dim), 0.0, f32)
            return specs
        shape = (cfg.n_layers, batch, cache_len, kvh, hd)
        return {"k": (shape, 0.0, dt), "v": (shape, 0.0, dt)}

    # ----------------------------------------------------------- decode step
    def decode_step(self, params, cache: dict, *, tokens=None, embeds=None, pos=None):
        """One decode step. tokens: (B, S) (or embeds (B, S, D)), usually
        S = 1; ``pos``: the first new position. Writes into ``cache`` and
        returns (logits, cache)."""
        if pos is None:
            raise TypeError("decode_step needs pos")
        with sharding.replicating(self.shard):
            return self._decode_step(params, cache, tokens, embeds, pos)

    def _decode_step(self, params, cache, tokens, embeds, pos):
        cfg = self.cfg
        x = self._embed_in(params, tokens, embeds, None)
        if cfg.family == "ssm":
            x = self._xlstm(params, x, cache)
        elif cfg.family == "hybrid":
            x = self._zamba(params, x, None, cache, pos)
        else:
            positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device) + pos
            for i, bp in enumerate(self._layers(params)):
                x, _, _ = self._block(bp, x, positions,
                                      {"k": cache["k"][i], "v": cache["v"][i]}, pos)
        x = _norm(cfg, params["final_norm"], x)
        return self._logits(params, x), cache

    # --------------------------------------------------------------- prefill
    def prefill(self, params, *, tokens=None, embeds=None, frontend_embeds=None):
        """Process a full prompt; returns (last-position logits, live cache).

        The cache length equals the prompt length (callers append decode
        budget by padding the cache before stepping, or re-init a longer
        cache; the hybrid's ring is ``min(attn_window, prompt)`` wide)."""
        with sharding.replicating(self.shard):
            return self._prefill(params, tokens, embeds, frontend_embeds)

    def _prefill(self, params, tokens, embeds, frontend_embeds):
        cfg = self.cfg
        x = self._embed_in(params, tokens, embeds, frontend_embeds)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        cache = self.init_cache(b, s, device=x.device)
        if cfg.family == "ssm":
            x = self._xlstm(params, x, cache)
        elif cfg.family == "hybrid":
            x = self._zamba(params, x, positions, cache)
        else:
            for i, bp in enumerate(self._layers(params)):
                x, nc, _ = self._block(bp, x, positions)
                cache["k"][i] = nc["k"]
                cache["v"][i] = nc["v"]
        x = _norm(cfg, params["final_norm"], x[:, -1:])
        return self._logits(params, x), cache


def _ring_attend(attn_params, acfg, h, ak, av, ap, pos):
    """Windowed decode attention over one super-block's ring buffer.

    ak / av: (B, W, KV, hd); ap: (W,) the absolute position a slot holds
    (-1 = empty). Writes the new tokens' k / v and positions at slots
    ``(pos + i) % W`` in place (``index_copy_``; for one token, the
    reference's slot ``pos % W``) and attends over the slots holding a
    position in [0, pos]. Returns the block's output."""
    b, s, _ = h.shape
    w, hd = ak.shape[1], acfg.head_dim
    q = sharding.unflatten(core.dense(attn_params["wq"], h), -1, (acfg.n_heads, hd))
    k = sharding.unflatten(core.dense(attn_params["wk"], h), -1, (acfg.n_kv_heads, hd))
    v = sharding.unflatten(core.dense(attn_params["wv"], h), -1, (acfg.n_kv_heads, hd))
    if acfg.qk_norm:
        q = attn_mod._headnorm(attn_params["q_norm"]["scale"], q)
        k = attn_mod._headnorm(attn_params["k_norm"]["scale"], k)
    positions = torch.arange(s, dtype=torch.int32, device=h.device) + pos
    q = apply_rope(q, positions, theta=acfg.rope_theta)
    k = apply_rope(k, positions, theta=acfg.rope_theta)
    slots = torch.remainder(positions, w).to(torch.int64)
    ap.index_copy_(0, slots, positions.to(ap.dtype))
    mask = ((ap >= 0) & (ap <= pos))[None, None, None, None, :]  # (B,KV,G,Sq,W)
    y = attn_mod.write_attend(q, k, v, ak, av, slots, mask, 1.0 / math.sqrt(hd))
    return core.dense(attn_params["wo"], y.reshape(b, s, acfg.n_heads * hd))


def _ring_from_full(k_full, v_full, w: int):
    """The full prefill k / v (B, S, KV, hd) in ring layout of width ``w``:
    (k, v, positions), the last ``min(S, w)`` positions at slot ``p % w``:
    a rotation of the last ``w`` positions, or positions 0..S-1 at slots
    0..S-1 and the rest zero. Data movement only (``roll``, ``pad``), which
    keeps a DTensor's layout."""
    s = k_full.shape[1]
    take = min(s, w)
    positions = torch.arange(s - take, s, dtype=torch.int32, device=k_full.device)
    slots = torch.remainder(positions, w).to(torch.int64)
    if s >= w:
        nk, nv = (torch.roll(a[:, -w:], (s - w) % w, 1) for a in (k_full, v_full))
    else:
        nk, nv = (F.pad(a, (0, 0, 0, 0, 0, w - s)) for a in (k_full, v_full))
    np_ = torch.full((w,), -1, dtype=torch.int32, device=k_full.device).index_copy_(
        0, slots, positions)
    return nk, nv, np_
