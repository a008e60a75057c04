"""Defo static graph analysis (paper §IV-B, Fig. 9 "static time").

Port of ``src/repro/core/ditto/defo.py`` (pure Python, copied unchanged).

A denoiser is declared as a small op graph; the analysis finds, for every
linear node, whether a *non-linear* op sits on the paths into / out of it:

  boundary_in=False  : the input differs from the previous linear output
                       only through diff-transparent ops (add / concat /
                       split / constant-scale / nearest-upsample) -> the
                       stored previous-step DIFFERENCE can be reused and
                       the difference-calculation load of x_prev is
                       bypassed;
  boundary_out=False : all consumers up to the next linear are
                       diff-transparent -> the summation with y_prev can
                       be deferred (no y reconstruction write).

Non-linear ops (norms, SiLU/GELU, softmax, elementwise products of two
activations) always force reconstruction — this is why Cambricon-D's
sign-mask trick (SiLU/GroupNorm only) does not generalize to transformer
blocks, and why Defo is a *runtime* choice per layer (§VII).
"""
from __future__ import annotations

import dataclasses

from .engine import LayerMeta

# ops through which the difference domain passes unchanged
TRANSPARENT = {"add", "concat", "split", "scale_const", "upsample_nearest", "identity", "input"}
LINEAR_OPS = {"linear", "conv", "attn_qk", "attn_pv"}
NONLINEAR = {"norm", "groupnorm", "layernorm", "silu", "gelu", "softmax", "mul_act", "modulate", "quantize"}


@dataclasses.dataclass
class GNode:
    name: str
    op: str
    inputs: tuple = ()


def _producers(graph: dict[str, GNode], node: GNode):
    return [graph[i] for i in node.inputs if i in graph]


def _consumers(graph: dict[str, GNode], name: str):
    return [n for n in graph.values() if name in n.inputs]


def _reaches_nonlinear_back(graph, node, seen=None) -> bool:
    """True if a non-linear op sits between this node and the previous
    linear op (searching backwards through transparent ops)."""
    seen = seen or set()
    for p in _producers(graph, node):
        if p.name in seen:
            continue
        seen.add(p.name)
        if p.op in NONLINEAR:
            return True
        if p.op in LINEAR_OPS:
            continue  # clean linear source: no boundary on this path
        if p.op in TRANSPARENT:
            if _reaches_nonlinear_back(graph, p, seen):
                return True
        else:  # unknown op: be conservative
            return True
    return False


def _reaches_nonlinear_fwd(graph, name, seen=None) -> bool:
    seen = seen or set()
    for c in _consumers(graph, name):
        if c.name in seen:
            continue
        seen.add(c.name)
        if c.op in NONLINEAR:
            return True
        if c.op in LINEAR_OPS:
            continue
        if c.op in TRANSPARENT:
            if _reaches_nonlinear_fwd(graph, c.name, seen):
                return True
        else:
            return True
    return False


def analyze(nodes: list[GNode]) -> dict[str, LayerMeta]:
    """Returns LayerMeta (with boundary flags) for every linear node."""
    graph = {n.name: n for n in nodes}
    out: dict[str, LayerMeta] = {}
    for n in nodes:
        if n.op not in LINEAR_OPS:
            continue
        kind = {"linear": "dense", "conv": "dense"}.get(n.op, n.op)
        out[n.name] = LayerMeta(
            name=n.name,
            kind=kind,
            boundary_in=_reaches_nonlinear_back(graph, n),
            boundary_out=_reaches_nonlinear_fwd(graph, n.name),
        )
    return out


# ---------------------------------------------------------------------------
# graph builders for the bundled denoisers
# ---------------------------------------------------------------------------


def dit_graph(n_layers: int) -> list[GNode]:
    """Op graph of one DiT forward (linear call sites named as in
    DittoDiT). Every linear in a DiT block is fenced by non-linear ops —
    the analysis proves it rather than assuming it."""
    nodes = [GNode("x0", "input"), GNode("c_silu", "silu", ("x0",))]
    prev = "x0"
    for i in range(n_layers):
        b = f"blk{i}"
        nodes += [
            GNode(f"{b}.mod", "linear", ("c_silu",)),
            GNode(f"{b}.ln1", "norm", (prev,)),
            GNode(f"{b}.modulate1", "modulate", (f"{b}.ln1", f"{b}.mod")),
            GNode(f"{b}.wq", "linear", (f"{b}.modulate1",)),
            GNode(f"{b}.wk", "linear", (f"{b}.modulate1",)),
            GNode(f"{b}.wv", "linear", (f"{b}.modulate1",)),
            GNode(f"{b}.qk", "attn_qk", (f"{b}.wq", f"{b}.wk")),
            GNode(f"{b}.softmax", "softmax", (f"{b}.qk",)),
            GNode(f"{b}.pv", "attn_pv", (f"{b}.softmax", f"{b}.wv")),
            GNode(f"{b}.wo", "linear", (f"{b}.pv",)),
            GNode(f"{b}.gate1", "mul_act", (f"{b}.wo", f"{b}.mod")),
            GNode(f"{b}.res1", "add", (prev, f"{b}.gate1")),
            GNode(f"{b}.ln2", "norm", (f"{b}.res1",)),
            GNode(f"{b}.modulate2", "modulate", (f"{b}.ln2", f"{b}.mod")),
            GNode(f"{b}.wi", "linear", (f"{b}.modulate2",)),
            GNode(f"{b}.gelu", "gelu", (f"{b}.wi",)),
            GNode(f"{b}.wd", "linear", (f"{b}.gelu",)),
            GNode(f"{b}.gate2", "mul_act", (f"{b}.wd", f"{b}.mod")),
            GNode(f"{b}.res2", "add", (f"{b}.res1", f"{b}.gate2")),
        ]
        prev = f"{b}.res2"
    nodes += [
        GNode("final.ln", "norm", (prev,)),
        GNode("final.out", "linear", ("final.ln",)),
    ]
    return nodes


def ddpm_tiny_graph(n_blocks: int) -> list[GNode]:
    """Conv ResNet denoiser: skip connections / residual adds are
    diff-transparent, so some convs get boundary_in/out = False — the conv
    counterpart of Cambricon-D's target, handled generically by Defo."""
    nodes = [GNode("x0", "input"), GNode("conv_in", "conv", ("x0",))]
    prev = "conv_in"
    for i in range(n_blocks):
        b = f"res{i}"
        nodes += [
            GNode(f"{b}.gn1", "groupnorm", (prev,)),
            GNode(f"{b}.silu1", "silu", (f"{b}.gn1",)),
            GNode(f"{b}.conv1", "conv", (f"{b}.silu1",)),
            GNode(f"{b}.gn2", "groupnorm", (f"{b}.conv1",)),
            GNode(f"{b}.silu2", "silu", (f"{b}.gn2",)),
            GNode(f"{b}.conv2", "conv", (f"{b}.silu2",)),
            # skip path: 1x1 conv straight off the (linear) block input
            GNode(f"{b}.skip", "conv", (prev,)),
            GNode(f"{b}.add", "add", (f"{b}.conv2", f"{b}.skip")),
        ]
        prev = f"{b}.add"
    nodes += [
        GNode("gn_out", "groupnorm", (prev,)),
        GNode("silu_out", "silu", ("gn_out",)),
        GNode("conv_out", "conv", ("silu_out",)),
    ]
    return nodes
