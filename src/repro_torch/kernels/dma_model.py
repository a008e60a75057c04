"""Tile-DMA and HBM-byte model of the diff-step kernels ON THE TPU.

Mirror of ``src/repro/kernels/dma_model.py``, ported as it is: numpy over
the port's own :func:`fused_step.hold_maps`. It models the TPU lowering of
the reference's Pallas kernels, not the port's Hopper kernels: Pallas' TPU
pipeline issues one HBM->VMEM copy per grid step for every operand whose
block index changed since the previous step (revisit elision), and the
reference's fused kernel keeps the block index of every unneeded operand
constant through its prefetched hold maps, so skipped tiles issue no copy.
This module counts those copies by replaying the same ``hold_maps`` and
prices both flows in HBM bytes.

A Hopper kernel has no such pipeline: a block skips a load by branching
on the tile's class. What the port's kernels move on the card is counted
in ``chip_smoke.py``'s bounds; a byte model of the Hopper kernels would be
a separate module.
"""
from __future__ import annotations

import numpy as np
import torch

from .fused_step import hold_maps

__all__ = ["count_copies", "fused_tile_dma", "two_pass_tile_dma", "model_hbm_bytes"]


def count_copies(index_seq: np.ndarray, cls_seq: np.ndarray) -> dict:
    """Copies issued for one operand over a flattened grid traversal.

    ``index_seq``: (T, 2) block index presented at each grid step;
    ``cls_seq``: (T,) tile class at each step. A copy is issued at every
    step whose index differs from the previous step's; step 0 is the
    unconditional pipeline-start fetch (counted separately as
    ``startup`` — with hold maps it prefetches the first *needed* block,
    so it is never wasted motion attributable to a skipped tile).
    ``by_class[c]`` = post-startup copies issued at steps whose tile has
    class c."""
    index_seq = np.asarray(index_seq)
    cls_seq = np.asarray(cls_seq).reshape(-1)
    changed = np.any(index_seq[1:] != index_seq[:-1], axis=1)
    by_class = np.bincount(cls_seq[1:][changed], minlength=3)
    return {
        "copies": int(changed.sum()) + 1,
        "startup": 1,
        "by_class": [int(v) for v in by_class],
    }


def _flat_classes(classes: np.ndarray, gn: int) -> np.ndarray:
    gm, gk = classes.shape
    return np.broadcast_to(classes[:, None, :], (gm, gn, gk)).reshape(-1)


def fused_tile_dma(classes, gn: int, *, w_transposed: bool = False) -> dict:
    """Per-operand copy counts of ``ditto_fused_matmul`` on this class
    map: replays :func:`fused_step.hold_maps` and applies revisit
    elision. Guarantees encoded here (asserted in the property tests):
    Δ-nibble (dc) and W copies only at class>=1 steps, Δ-high (dh)
    copies only at class-2 steps, and NO x_t/x_prev operand exists —
    zero-class tiles issue no copy of anything."""
    classes = np.ascontiguousarray(classes)
    cls_flat = _flat_classes(classes, gn)
    kd, kh, kw = (h.numpy() for h in hold_maps(torch.from_numpy(classes), gn,
                                               w_transposed=w_transposed))
    return {
        "dc": count_copies(kd, cls_flat),
        "dh": count_copies(kh, cls_flat),
        "w": count_copies(kw, cls_flat),
        "grid_steps": int(cls_flat.size),
    }


def two_pass_tile_dma(classes, gn: int) -> dict:
    """The two-pass ``ditto_diff_matmul``'s copy counts under the
    same elision rule: its index maps are unconditional — x_t/x_prev at
    (i, kk) and W at (kk, j) change every step, y_prev at (i, j) changes
    once per output tile — so every tile, skipped or not, moves its full
    operand set."""
    classes = np.asarray(classes)
    gm, gk = classes.shape
    cls_flat = _flat_classes(classes, gn)
    shape = (gm, gn, gk)
    ii, jj, kk = np.indices(shape)
    x_seq = np.stack([ii, kk], -1).reshape(-1, 2)
    w_seq = np.stack([kk, jj], -1).reshape(-1, 2)
    yp_seq = np.stack([ii, jj], -1).reshape(-1, 2)
    return {
        "x_t": count_copies(x_seq, cls_flat),
        "x_prev": count_copies(x_seq, cls_flat),
        "w": count_copies(w_seq, cls_flat),
        "y_prev": count_copies(yp_seq, cls_flat),
        "grid_steps": int(cls_flat.size),
    }


def model_hbm_bytes(classes, gn: int, *, bm: int = 128, bn: int = 128,
                    bk: int = 128, y_prev: bool = True) -> dict:
    """Modeled HBM traffic (bytes) of one diff linear step, both flows.

    Both include the encode pass (x_t + x_prev read once) and the final
    (M, N) int32 output write. Two-pass adds the per-column activation
    re-reads and the y_prev operand pass; fused adds the class-gated
    Δ-cache writes (nibble plane for class>=1 tiles, high plane for
    class-2 tiles) + their block reads, and pays y_prev as an epilogue
    (one extra int32 read-modify-write of the output, counted
    honestly)."""
    classes = np.asarray(classes)
    gm, gk = classes.shape
    m, k, n = gm * bm, gk * bk, gn * bn
    x_tile, w_tile = bm * bk, bk * bn
    dc_tile, dh_tile, o_tile = bm * (bk // 2), bm * bk, bm * bn * 4
    encode_read = 2 * m * k
    out_write = m * n * 4

    tp = two_pass_tile_dma(classes, gn)
    two_pass = (encode_read + out_write
                + (tp["x_t"]["copies"] + tp["x_prev"]["copies"]) * x_tile
                + tp["w"]["copies"] * w_tile
                + (tp["y_prev"]["copies"] * o_tile if y_prev else 0))

    fu = fused_tile_dma(classes, gn)
    n_nonzero = int((classes >= 1).sum())
    n_full = int((classes == 2).sum())
    fused = (encode_read + out_write
             + n_nonzero * dc_tile + n_full * dh_tile  # class-gated cache writes
             + fu["dc"]["copies"] * dc_tile
             + fu["dh"]["copies"] * dh_tile
             + fu["w"]["copies"] * w_tile
             + (3 * m * n * 4 if y_prev else 0))  # epilogue: read y, read y_prev, write

    return {"two_pass": int(two_pass), "fused": int(fused),
            "ratio": float(two_pass) / float(fused)}
