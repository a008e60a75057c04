"""What a run feeds both the program and the reference, made from ``--seed``:
the float weights of a configuration and each request's noise and labels.

Weights are drawn on the device in one ``torch.randn`` call and split into
leaves, in the tree layout the program's DiT takes (``blocks`` stacked on a
leading layer axis, dense weights (in, out)). The distributions are the
configuration's ``assumed`` ones: dense weights N(0, 1/fan_in), the adaLN
``mod`` projections, biases and embeddings N(0, 0.02).
"""
from __future__ import annotations

import numpy as np
import torch

#: Standard deviation of the leaves that are not fan-in scaled.
SMALL_STD = 0.02


def _leaf_specs(model: dict) -> list[tuple[tuple, tuple, str]]:
    """(path, shape, init) of every leaf: init "fan_in" or "small"."""
    d, depth = model["hidden_size"], model["depth"]
    p, ch = model["patch_size"], model["in_channels"]
    tokens = (model["input_size"] // p) ** 2
    ff = int(model["mlp_ratio"] * d)
    out = p * p * ch
    specs = []

    def dense(path, k, n, lead=(), init="fan_in"):
        specs.append((path + ("w",), lead + (k, n), init))
        specs.append((path + ("b",), lead + (n,), "small"))

    dense(("patch_embed",), out, d)
    specs.append((("pos_embed",), (tokens, d), "small"))
    dense(("t_mlp1",), 256, d)
    dense(("t_mlp2",), d, d)
    specs.append((("label_embed",), (model["num_classes"] + 1, d), "small"))
    lead = (depth,)
    for nm in ("wq", "wk", "wv", "wo"):
        dense(("blocks", "attn", nm), d, d, lead)
    dense(("blocks", "mlp", "wi"), d, ff, lead)
    dense(("blocks", "mlp", "wo"), ff, d, lead)
    dense(("blocks", "mod"), d, 6 * d, lead, init="small")
    dense(("final_mod",), d, 2 * d)
    dense(("final_out",), d, out)
    return specs


def make_weights(model: dict, seed: int, device) -> dict:
    """The float32 weights tree of ``model`` from ``seed``, on ``device``."""
    specs = _leaf_specs(model)
    sizes = [int(np.prod(shape)) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    tree: dict = {}
    for (path, shape, init), leaf in zip(specs, flat.split(sizes)):
        leaf = leaf.view(shape)
        leaf.mul_(SMALL_STD if init == "small" else shape[-2] ** -0.5)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def request_seed(seed: int, index: int, stream: int = 0) -> int:
    """A 63-bit seed of request ``index`` of a run seeded ``seed``."""
    a, b = np.random.SeedSequence([seed, index, stream]).generate_state(2)
    return (int(a) << 31 | int(b) >> 1) % 2**63


def make_request(model: dict, seed: int, index: int, images: int, device):
    """(x_T, labels) of one request: noise on ``device`` and uniform labels."""
    size, ch = model["input_size"], model["in_channels"]
    gen = torch.Generator(device=device).manual_seed(request_seed(seed, index))
    x = torch.randn((images, size, size, ch), generator=gen, device=device)
    rng = np.random.default_rng(request_seed(seed, index, 1))
    labels = torch.as_tensor(rng.integers(0, model["num_classes"], images), device=device)
    return x, labels
