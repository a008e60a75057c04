"""The DiT family (Peebles & Xie, arXiv:2212.09748): class-conditional
latent diffusion transformers served by ``repro_torch`` under Ditto, with a
linear-beta noise schedule.

A configuration file names its family (``"family": "dit"``) and the
harness loads ``families/<family>.py`` by path. A family module exposes:

* ``build_scheduler(config, weights, device)``: the async ``ServeScheduler``
  of the configuration's model, noise schedule and plan;
* ``make_weights(model, seed, device)``: the float weights tree;
* ``make_request(model, seed, index, images, device)``: ``(x, cond)``, the
  noise and a dict of conditioning tensors, each with the request's images
  on dim 0;
* ``submit(sched, x, cond, **kw)``: the request's ``Ticket``;
* ``reference_sample(weights, config, x, cond, bits=8)``: the plain
  reference's final latents, ``bits`` the width of its integer products;
* ``model_macs(model)``: dense multiply-accumulates of one forward of one
  image;
* ``int8_matmul_launches(model, modes, bucket)``: (batch, M, K, N, w_batch)
  of every ``int8_matmul`` launch of one replayed step.

DiT's conditioning is ``{"labels": ...}``, one class label an image.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.inputs import request_seed, tree_from_specs
from perfbench.reference import dit as ref


# --------------------------------------------------------------- program
def build_scheduler(config: dict, weights: dict, device):
    from repro_torch.core import diffusion
    from repro_torch.core.ditto import DittoPlan
    from repro_torch.nn.dit import DiTCfg
    from repro_torch.serve import ServeScheduler

    m, s = config["model"], config["schedule"]
    cfg = DiTCfg(d_model=m["hidden_size"], n_layers=m["depth"], n_heads=m["num_heads"],
                 patch=m["patch_size"], in_channels=m["in_channels"],
                 input_size=m["input_size"], mlp_ratio=m["mlp_ratio"],
                 n_classes=m["num_classes"])
    noise = diffusion.linear_schedule(s["T"], s["beta_start"], s["beta_end"])
    return ServeScheduler(weights, cfg, noise, DittoPlan(**config["plan"]), device=device,
                          async_mode=True)


def submit(sched, x, cond: dict, **kw):
    return sched.submit(x, cond["labels"], **kw)


# ---------------------------------------------------------------- inputs
def _leaf_specs(model: dict) -> list[tuple[tuple, tuple, str]]:
    """(path, shape, init) of every leaf, in the tree layout the program's
    DiT takes (``blocks`` stacked on a leading layer axis, dense weights
    (in, out)). The configuration's ``assumed`` distributions: dense weights
    fan-in scaled; the adaLN ``mod`` projections, biases and embeddings
    small."""
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
    return tree_from_specs(_leaf_specs(model), seed, device)


def make_request(model: dict, seed: int, index: int, images: int, device):
    """(x_T, {"labels"}) of one request: noise on ``device`` and uniform
    labels."""
    size, ch = model["input_size"], model["in_channels"]
    gen = torch.Generator(device=device).manual_seed(request_seed(seed, index))
    x = torch.randn((images, size, size, ch), generator=gen, device=device)
    rng = np.random.default_rng(request_seed(seed, index, 1))
    labels = torch.as_tensor(rng.integers(0, model["num_classes"], images), device=device)
    return x, {"labels": labels}


# ------------------------------------------------------------- reference
def reference_sample(weights: dict, config: dict, x, cond: dict, bits: int = 8):
    return ref.sample(weights, config["model"], config["schedule"], config["plan"]["steps"],
                      x, cond["labels"], bits=bits)


# ------------------------------------------------------------- yardstick
def model_macs(model: dict) -> int:
    """Dense multiply-accumulates of one DiT forward of one image: every
    linear layer (per token, and the per-image adaLN, timestep and final
    modulation products), attention's Q K^T and P V, patch embedding and
    the output projection."""
    d, depth, p, ch = (model["hidden_size"], model["depth"], model["patch_size"],
                       model["in_channels"])
    n = (model["input_size"] // p) ** 2
    ff = int(model["mlp_ratio"] * d)
    per_token = 4 * d * d + 2 * d * ff
    block = n * per_token + 2 * n * n * d + d * 6 * d
    head = n * p * p * ch * d + 256 * d + d * d + d * 2 * d + n * d * p * p * ch
    return depth * block + head


def int8_matmul_launches(model: dict, modes: dict[str, str], bucket: int) -> list[tuple]:
    """(batch, M, K, N, w_batch) of every ``int8_matmul`` launch of one
    compiled step over ``bucket`` samples whose layers run in ``modes``
    (layer -> "act" / "diff" / "spatial"): the act and spatial linear layers
    and the act attention products."""
    d, nh, p, ch = (model["hidden_size"], model["num_heads"], model["patch_size"],
                    model["in_channels"])
    n = (model["input_size"] // p) ** 2
    ff = int(model["mlp_ratio"] * d)
    hd = d // nh
    shapes = {"mod": (1, bucket, d, 6 * d, 1), "wq": (1, bucket * n, d, d, 1),
              "wk": (1, bucket * n, d, d, 1), "wv": (1, bucket * n, d, d, 1),
              "wo": (1, bucket * n, d, d, 1), "wi": (1, bucket * n, d, ff, 1),
              "wd": (1, bucket * n, ff, d, 1),
              "qk": (bucket * nh, n, hd, n, bucket * nh),
              "pv": (bucket * nh, n, n, hd, bucket * nh)}
    out = []
    for layer, mode in modes.items():
        attention = layer.endswith((".qk", ".pv"))
        if mode == "act" or (mode == "spatial" and not attention):
            if layer == "final.out":
                out.append((1, bucket * n, d, p * p * ch, 1))
            else:
                out.append(shapes[layer.rsplit(".", 1)[1]])
    return out
