"""The yardstick's arithmetic: the card's peaks, a kernel launch's work and
bound, the model's dense operations and the union of device intervals.

Frozen copies, so that a change to the program cannot move them:
``int8_matmul_work`` is ``chip_smoke.py:work()``'s int8_matmul branch and
``launch_bound`` its bound; ``union_s`` is
``benchmarks/torch_step_profile.py:union_ms`` over (start, end) pairs.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def int8_matmul_work(batch: int, m: int, k: int, n: int, w_batch: int) -> tuple[float, float]:
    """(operations, bytes) of one int8 x int8 -> int32 product at its
    unpadded (M, K, N): each input read once, the output written once."""
    return 2.0 * batch * m * n * k, float(batch * m * k + w_batch * k * n + 4 * batch * m * n)


def launch_bound(ops: float, nbytes: float) -> float:
    """The least seconds a launch can take on the card."""
    return max(ops / PEAK_INT8_OPS, nbytes / HBM_BYTES_PER_S)


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
    d, nh, p, ch = model["hidden_size"], model["num_heads"], model["patch_size"], model["in_channels"]
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


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in seconds, so
    activities that ran at once count once."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total
