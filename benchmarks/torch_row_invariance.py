"""Does a sample row get the same bits alone as in a batch? (fp32 glue)

    python3 benchmarks/torch_row_invariance.py

The scheduler's rows equal a per-request serve bit for bit only if no op
of the DiT forward changes a row's bits with the number of rows beside
it. The integer products are exact; the fp32 glue's row-wise ops are
checked here at DiT-XL/2 width: the conditioning products with one row a
sample (``t_mlp1`` (M, 256) @ (256, 1152), ``t_mlp2`` (M, 1152) @ (1152,
1152), ``final_mod`` (M, 1152) @ (1152, 2304)), ``patch_embed`` on
(M, 256, 16) tokens, LayerNorm over 1152 and softmax over 256 (256 and
16 x 256 rows a sample); and ``final_out`` on (M, 256, 1152) tokens, the
float DiT's head (``nn/dit.py``), which the served path does not run: it
runs ``final.out`` as an exact int8 layer. For each sample count M up to
MAX_ROWS it lists the M at which some sample's bits differ from the same
sample computed alone, for the products once as a plain ``x @ w + b`` and
once through ``nn.core.dense`` (which runs a 2-D product as zero-padded
blocks of ``ROW_BLOCK`` rows). It prints one JSON line and the card's
name and power limit.
"""
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.kernels.common import resolve_device  # noqa: E402
from repro_torch.nn import core as nncore  # noqa: E402
from repro_torch.nn import dit  # noqa: E402

# the largest bucket of the default ladder (plan.DEFAULT_MAX_BATCH)
MAX_ROWS = 64

# name -> (K, N, rows a sample)
SHAPES = {"t_mlp1": (256, 1152, 1), "t_mlp2": (1152, 1152, 1), "final_mod": (1152, 2304, 1),
          "patch_embed": (16, 1152, 256), "final_out": (1152, 32, 256)}


def differing(fn, rows: torch.Tensor, per: int = 1) -> list[int]:
    """Sample counts M (samples of ``per`` rows) at which some sample's
    bits differ from the same sample's computed alone."""
    def sample(y, i):
        return y[i:i + 1] if y.dim() == 3 else y[i * per:(i + 1) * per]

    alone = [fn(rows[i * per:(i + 1) * per]) for i in range(MAX_ROWS)]
    out = []
    for m in range(1, MAX_ROWS + 1):
        y = fn(rows[:m * per])
        if not all(torch.equal(sample(y, i), alone[i]) for i in range(m)):
            out.append(m)
    return out


def main() -> dict:
    dev = resolve_device(None)  # the card
    g = torch.Generator(device=dev).manual_seed(0)
    out: dict = {"device": torch.cuda.get_device_name(dev)}
    for name, (k, n, per) in SHAPES.items():
        params = {"w": torch.randn((k, n), generator=g, device=dev),
                  "b": torch.randn((n,), generator=g, device=dev)}
        x = torch.randn((MAX_ROWS * per, k), generator=g, device=dev)
        shaped = (lambda r: r) if per == 1 else (lambda r: r.reshape(-1, per, k))
        out[name] = {
            "plain": differing(lambda r: shaped(r) @ params["w"] + params["b"], x, per),
            "dense": differing(lambda r: nncore.dense(params, shaped(r)), x, per)}
    x = torch.randn((MAX_ROWS * 256, 1152), generator=g, device=dev)
    out["layernorm"] = differing(dit._ln, x, per=256)
    s = torch.randn((MAX_ROWS * 16 * 256, 256), generator=g, device=dev)
    out["softmax"] = differing(lambda r: torch.softmax(r, dim=-1), s, per=16 * 256)
    print(json.dumps({"samples_whose_bits_differ_from_alone": out}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return out


if __name__ == "__main__":
    main()
