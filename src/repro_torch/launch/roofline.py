"""Roofline terms of a step on one NVIDIA H100 SXM5 80GB HBM3 (700 W).

Mirror of ``src/repro/launch/roofline.py``, with the H100's data-sheet
constants in place of the reference's chip. Terms (seconds, per step, per
card):

    compute    = sum over dtypes of FLOPs_dtype / PEAKS[dtype]
                 (or FLOPs / peak_flops, the reference's single peak)
    memory     = HBM bytes / HBM_BW
    collective = sum over collectives of wire bytes / the bandwidth of the
                 link its group crosses

Wire bytes apply the ring-algorithm factor per collective kind with the
group size n (as the reference):
    all-gather          result_bytes * (n-1)/n
    all-reduce          result_bytes * 2(n-1)/n
    reduce-scatter      result_bytes * (n-1)        (result is the shard)
    all-to-all          result_bytes * (n-1)/n
    collective-permute  result_bytes

A group lies inside one node of ``NODE_GPUS`` cards, joined by NVLink 4,
when its ranks lie in one block of 8: for a group along a mesh dim (dims
laid out row-major over the ranks), when the product of the dim's size
and all inner dims' sizes is at most 8; else it crosses nodes over
InfiniBand NDR.

Peaks are dense (no sparsity) and assume the card's full 700 W power
limit. Float32 is the rate outside the tensor cores: the port keeps TF32
off, so the DiT's float32 products run there.
"""
from __future__ import annotations

from typing import Any

import torch

#: The card these constants describe.
CARD = "NVIDIA H100 SXM5 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12  # bf16 / fp16 dense tensor-core FLOP/s
PEAK_FLOPS_INT8 = 1979e12  # int8 dense tensor-core op/s
PEAK_FLOPS_FP32 = 67e12  # float32 outside the tensor cores (TF32 off)
PEAK_FLOPS_FP64 = 34e12  # float64 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way a GPU, NVLink 4 inside an 8-GPU node
IB_BW = 50e9  # bytes/s each way a GPU, InfiniBand NDR (400 Gb/s) across nodes
NODE_GPUS = 8
#: ``torch.cuda.get_device_properties(0).total_memory`` of the card
#: (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's launch phase prints it).
HBM_BYTES = 85_017_493_504

#: Peak rate of a product by its operands' dtype.
PEAKS = {
    torch.bfloat16: PEAK_FLOPS,
    torch.float16: PEAK_FLOPS,
    torch.int8: PEAK_FLOPS_INT8,
    torch.float32: PEAK_FLOPS_FP32,
    torch.float64: PEAK_FLOPS_FP64,
}

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2, torch.uint16: 2,
    torch.float16: 2, torch.bfloat16: 2, torch.int32: 4, torch.uint32: 4, torch.float32: 4,
    torch.int64: 8, torch.uint64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}


def _wire_factor(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-gather":
        return (n - 1) / n
    if op == "all-reduce":
        return 2 * (n - 1) / n
    if op == "reduce-scatter":
        return float(n - 1)
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute


def ranks_bandwidth(ranks) -> float:
    """Bytes/s a card of a group of global ``ranks`` sends each way: NVLink
    when they all lie in one node of ``NODE_GPUS`` consecutive ranks, else
    InfiniBand. For a group along one dim of a mesh laid out row-major over
    the ranks, that is when the dim's size times all inner dims' sizes is
    at most ``NODE_GPUS``."""
    ranks = list(ranks)
    return NVLINK_BW if max(ranks) // NODE_GPUS == min(ranks) // NODE_GPUS else IB_BW


def collective_summary(records: list[dict]) -> dict[str, Any]:
    """Totals of the analyzer's collective records
    (``launch/op_analysis.py``: op, result_bytes, group_size, wire_bytes)."""
    by_op: dict[str, dict] = {}
    for r in records:
        d = by_op.setdefault(r["op"], {"count": 0, "result_bytes": 0, "wire_bytes": 0.0})
        d["count"] += 1
        d["result_bytes"] += r["result_bytes"]
        d["wire_bytes"] += r["wire_bytes"]
    return {
        "total_wire_bytes": sum(r["wire_bytes"] for r in records),
        "total_result_bytes": sum(r["result_bytes"] for r in records),
        "count": len(records),
        "by_op": by_op,
    }


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    wire_bytes_per_device: float | None,
    *,
    model_flops_global: float,
    n_chips: int,
    peak_flops: float | None = None,
    flops_by_dtype: dict | None = None,
    collectives: list[dict] | None = None,
    hbm_bw: float = HBM_BW,
    link_bw: float = NVLINK_BW,
) -> dict[str, Any]:
    """The reference's roofline dict. The compute term is
    ``flops_per_device / peak_flops`` when ``peak_flops`` is given, else
    each dtype's FLOPs of ``flops_by_dtype`` over its peak. The collective
    term is the sum over ``collectives`` (records with ``wire_bytes`` and
    ``bandwidth``) when given, else ``wire_bytes_per_device / link_bw``;
    ``None`` wire bytes (no per-device program) leave it ``None``."""
    if peak_flops is not None:
        compute = flops_per_device / peak_flops
    elif flops_by_dtype is not None:
        compute = sum(f / PEAKS[dt] for dt, f in flops_by_dtype.items())
    else:
        raise ValueError("roofline_terms needs peak_flops or flops_by_dtype")
    # the rate the counted FLOPs ran at, for the model FLOPs' ideal time
    eff_peak = peak_flops or (flops_per_device / compute if compute else PEAK_FLOPS)
    memory = bytes_per_device / hbm_bw
    if collectives is not None:
        collective = sum(r["wire_bytes"] / r["bandwidth"] for r in collectives)
    elif wire_bytes_per_device is None:
        collective = None
    else:
        collective = wire_bytes_per_device / link_bw
    terms = [("compute", compute), ("memory", memory)]
    if collective is not None:
        terms.append(("collective", collective))
    dominant = max(terms, key=lambda kv: kv[1])[0]
    hlo_global = flops_per_device * n_chips
    useful = model_flops_global / hlo_global if hlo_global else 0.0
    bound = max(t for _, t in terms)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "model_flops_global": model_flops_global,
        "hlo_flops_global": hlo_global,
        "useful_flops_ratio": useful,
        # fraction of roofline-ideal time: the model FLOPs at the counted
        # FLOPs' rate over the dominant term
        "roofline_fraction": (model_flops_global / n_chips / eff_peak) / bound if bound else 0.0,
    }


def model_flops(arch, shape) -> float:
    """6·N·D (train) or 2·N_active·tokens (prefill/decode forward).

    Diffusion cells process (batch x patch-token) tokens per denoiser
    forward regardless of the LM seq_len; decode cells process one new
    token per sequence."""
    n_active = arch.n_active_params()
    if arch.family == "diffusion":
        tokens = shape.global_batch * (arch.input_size // arch.patch) ** 2
        return (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n_active * tokens
