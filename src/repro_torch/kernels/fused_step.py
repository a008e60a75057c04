"""Fused-flow diff step, for Hopper: one encode pass that also writes the
Δ-cache, then a GEMM that reads the cache instead of the raw activations.

Mirror of ``src/repro/kernels/fused_step.py``.

:func:`diff_encode_fused` replaces ``diff_encode_fused`` (Pallas body
``_encode_kernel``). One pass over (x_t, x_prev) gives the tile classes
and the two-plane Δ-cache, exact for every Δ:

* ``dc`` (..., M, K/2) int8 — Δ's low nibbles, two int4 K lanes a byte
  (``int4_pack`` layout); on class-1 tiles this IS Δ;
* ``dh`` (..., M, K) int8 — (Δ - lo) >> 4, so that Δ = lo + (dh << 4)
  (|Δ| <= 254, so dh is in [-16, 16]).

Writes are gated by class: class-0 tiles write neither plane, class-1
tiles skip ``dh``. Kernel (``csrc/diff_encode_fused.cu`` over
``csrc/encode_sm90.cuh``, the two-pass encode's cluster design): each
128 x 128 tile is split over a thread-block cluster of C blocks; every
block keeps its 128/C rows of both operands in registers while the
cluster reduces max|Δ| through distributed shared memory, then writes
those rows of the planes the class needs, so a tile's stores are spread
over C SMs (C from :func:`repro_torch.kernels.common.encode_cluster`). It
moves 2 bytes a Δ in and up to 1.5 out, so its bound is bytes.

:func:`ditto_fused_matmul` replaces ``ditto_fused_matmul`` (Pallas body
``_fused_kernel``). Kernel (``csrc/ditto_fused_matmul.cu``): the
two-pass GEMM's mainloop (``csrc/diff_gemm_sm90.cuh``: live-tile list,
3-stage ``cp.async`` ring, ``wgmma`` with A from registers and W
K-major, K split over a cluster, the output tile staged for 16-byte
stores) with its own producer of Δ. Per live 64-K chunk it stages only
the planes the class needs: class 1 the ``dc`` chunk (32 bytes a row, the
nibbles are Δ) and W, class 2 ``dc``, ``dh`` and W. Each thread rebuilds
its fragment lanes in registers, sign-extending the nibbles (class 1) or
forming Δ = lo + 16 * dh (class 2), which takes the two-pass kernel's
exact lo / hi split where a lane leaves [-127, 127]. Where the reference
remaps skipped blocks through :func:`hold_maps` so that the TPU pipeline
elides their copies, a Hopper block never issues them: its list holds
live tiles only. The reference adds y_prev after its kernel; here y_prev,
when given, is added as the output tile is stored, which saves a full
int32 read and write of the output, and the int32 result is the same.
With ``y_prev=None`` the wrapper returns the bare contribution. At the
B = 2 shapes the int32 output dominates the bytes, so its bound is bytes.

:func:`hold_maps` is the reference's index-table construction as a plain
function; nothing on the CUDA path uses it. ``kernels.dma_model`` replays
it to count the TPU's copies.

On a CPU tensor each wrapper runs its plain version (``kernels.ref``); on
a CUDA tensor it launches the kernel or raises. Dims must be multiples of
128 (:func:`repro_torch.kernels.ops.ditto_linear_step` zero-pads); a
leading batch dim runs as the grid's z axis. Off the CPU each wrapper
reports a launch to ``common.record_work``: its static arguments (the
operands' shapes and dtypes; for the GEMM ``w_transposed`` and whether
``y_prev`` is given) and its work. The work depends on the classes, which
a fake tensor does not hold, so the reports are the dense counts: every
class tile live, both Δ-cache planes written and read whole. On a fake or
meta tensor (the runner-key audit, ``repro_torch/analysis/trace_audit.py``)
a wrapper reports the same and returns empty outputs of the card's
shapes and dtypes, launching nothing.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import common
from .ref import diff_encode_fused_ref, ditto_fused_matmul_ref

__all__ = ["diff_encode_fused", "ditto_fused_matmul", "hold_maps", "launch_encode",
           "launch_matmul", "encode_launches", "matmul_launches"]

#: Kernel launches so far, per kernel (chip_smoke.py zeroes them and reads
#: them around a run).
encode_launches = 0
matmul_launches = 0

_ENCODE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [ctypes.c_int] * 2 + [
    ctypes.c_void_p]
_MATMUL_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 8 + [ctypes.c_int, ctypes.c_void_p]


def _check_even(name: str, bk: int) -> None:
    if bk % 2:
        raise ValueError(f"{name}: the Δ-cache pairs K lanes, so bk must be even, got {bk}")


def diff_encode_fused(x_t: torch.Tensor, x_prev: torch.Tensor, *, bm: int = 128,
                      bk: int = 128) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_*: (..., M, K) int8 -> (classes (..., M/bm, K/bk) int32,
    dc (..., M, K/2) int8, dh (..., M, K) int8). The cache planes hold their
    values only on the tiles whose class gates them in (``dc``: class >= 1,
    ``dh``: class 2); elsewhere the kernel leaves them unwritten."""
    global encode_launches
    common.refuse_dtensor("diff_encode_fused", x_t, x_prev)
    m, k = x_t.shape[-2:]
    if x_prev.shape != x_t.shape or m % bm or k % bk:
        raise ValueError(f"diff_encode_fused: shapes {tuple(x_t.shape)}, "
                         f"{tuple(x_prev.shape)} do not tile by ({bm}, {bk})")
    _check_even("diff_encode_fused", bk)
    if x_t.device.type == "cpu":
        return diff_encode_fused_ref(x_t, x_prev, (bm, bk))
    if (bm, bk) != (128, 128):
        raise ValueError(f"diff_encode_fused: the CUDA kernel tiles by 128, got ({bm}, {bk})")
    tiles = math.prod(x_t.shape[:-2]) * (m // 128) * (k // 128)
    common.record_work("diff_encode_fused", flops=0.0,
                       nbytes=float(2 * x_t.numel() + 4 * tiles + x_t.numel() // 2 + x_t.numel()),
                       dtype=torch.int8, static=dict(operands=common.operands(x_t, x_prev)))
    if common.is_fake(x_t):
        return _empty_cache(x_t)
    common.check_cuda_operand("diff_encode_fused x_t", x_t, torch.int8)
    common.check_cuda_operand("diff_encode_fused x_prev", x_prev, torch.int8)
    out = launch_encode(x_t, x_prev)
    encode_launches += 1
    return out


def launch_encode(x_t: torch.Tensor, x_prev: torch.Tensor, cluster: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the fused encode's C entry on checked operands; no
    count. ``cluster`` as in :func:`repro_torch.kernels.diff_encode.launch`."""
    (m, k), lead = x_t.shape[-2:], x_t.shape[:-2]
    batch, gm, gk = math.prod(lead), m // 128, k // 128
    classes, dc, dh = _empty_cache(x_t)
    cluster = cluster or common.encode_cluster(batch * gm * gk, common.sm_count(x_t.device))
    common.call("diff_encode_fused", "ditto_diff_encode_fused", _ENCODE_ARGTYPES, x_t.device,
                x_t.data_ptr(), x_prev.data_ptr(), classes.data_ptr(), dc.data_ptr(),
                dh.data_ptr(), batch, m, k, m * k, gm * gk, common.LOW_BIT_MAX, cluster)
    return classes, dc, dh


def ditto_fused_matmul(w_q: torch.Tensor, dcache: torch.Tensor, dhigh: torch.Tensor,
                       classes: torch.Tensor, y_prev: torch.Tensor | None = None, *,
                       bm: int = 128, bn: int = 128, bk: int = 128,
                       w_transposed: bool = False) -> torch.Tensor:
    """y_prev + (x_t - x_prev) @ W from the Δ-cache, (..., M, N) int32;
    with ``y_prev=None`` the bare contribution.

    w_q: (..., K, N) int8 — (..., N, K) with ``w_transposed``; dcache
    (..., M, K/2) int8, dhigh (..., M, K) int8 and classes
    (..., M/bm, K/bk) int32, all from :func:`diff_encode_fused`."""
    global matmul_launches
    common.refuse_dtensor("ditto_fused_matmul", w_q, dcache, dhigh, classes, y_prev)
    m, k = dhigh.shape[-2:]
    n, k2 = w_q.shape[-2:] if w_transposed else w_q.shape[-2:][::-1]
    lead = dhigh.shape[:-2]
    if (k != k2 or m % bm or n % bn or k % bk
            or tuple(dcache.shape) != lead + (m, k // 2)
            or tuple(classes.shape) != lead + (m // bm, k // bk)
            or (y_prev is not None and tuple(y_prev.shape) != lead + (m, n))):
        raise ValueError(
            f"ditto_fused_matmul: inconsistent shapes w_q {tuple(w_q.shape)} "
            f"(w_transposed={w_transposed}), dcache {tuple(dcache.shape)}, dhigh "
            f"{tuple(dhigh.shape)}, classes {tuple(classes.shape)}, y_prev "
            f"{None if y_prev is None else tuple(y_prev.shape)} for tiles ({bm}, {bn}, {bk})")
    _check_even("ditto_fused_matmul", bk)
    if dhigh.device.type == "cpu":
        y = ditto_fused_matmul_ref(w_q, dcache, dhigh, classes, (bm, bk),
                                   w_transposed=w_transposed)
        return y if y_prev is None else y + y_prev
    if (bm, bn, bk) != (128, 128, 128):
        raise ValueError(f"ditto_fused_matmul: the CUDA kernel tiles by 128, got "
                         f"({bm}, {bn}, {bk})")
    if w_q.shape[:-2] != lead:
        raise ValueError(f"ditto_fused_matmul: batch dims differ: {tuple(dhigh.shape)} vs "
                         f"{tuple(w_q.shape)}")
    if not w_transposed:  # the kernel reads W K-major, as int8 wgmma does
        w_q = w_q.transpose(-1, -2).contiguous()
    rows = math.prod(lead) * m
    common.record_work(
        "ditto_fused_matmul", flops=2.0 * rows * n * k,
        nbytes=float(dcache.numel() + dhigh.numel() + w_q.numel() + 4 * classes.numel()
                     + 4 * rows * n * (1 if y_prev is None else 2)),
        dtype=torch.int8,
        static=dict(operands=common.operands(w_q, dcache, dhigh, classes, y_prev),
                    w_transposed=w_transposed, y_prev=y_prev is not None))
    if common.is_fake(dhigh):
        return _empty_out(dhigh, w_q)
    common.check_cuda_operand("ditto_fused_matmul w_q", w_q, torch.int8)
    common.check_cuda_operand("ditto_fused_matmul dcache", dcache, torch.int8)
    common.check_cuda_operand("ditto_fused_matmul dhigh", dhigh, torch.int8)
    common.check_cuda_operand("ditto_fused_matmul classes", classes, torch.int32)
    if y_prev is not None:
        common.check_cuda_operand("ditto_fused_matmul y_prev", y_prev, torch.int32)
    out = launch_matmul(w_q, dcache, dhigh, classes, y_prev)
    matmul_launches += 1
    return out


def launch_matmul(w_nk, dcache, dhigh, classes, y_prev, splits=0) -> torch.Tensor:
    """One launch of the fused GEMM's C entry on checked operands, W
    (..., N, K); no count. ``splits`` as in
    :func:`repro_torch.kernels.ditto_diff_matmul.launch`."""
    (m, k), n = dhigh.shape[-2:], w_nk.shape[-2]
    lead = dhigh.shape[:-2]
    out = _empty_out(dhigh, w_nk)
    common.call("ditto_fused_matmul", "ditto_fused_matmul", _MATMUL_ARGTYPES, dhigh.device,
                w_nk.data_ptr(), dcache.data_ptr(), dhigh.data_ptr(), classes.data_ptr(),
                None if y_prev is None else y_prev.data_ptr(), out.data_ptr(),
                math.prod(lead), m, n, k, n * k, m * k, m * n, (m // 128) * (k // 128),
                splits)
    return out


def _empty_cache(x_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused encode's results, unwritten: classes (..., M/128, K/128)
    int32, dc (..., M, K/2) int8, dh (..., M, K) int8."""
    (m, k), lead = x_t.shape[-2:], x_t.shape[:-2]
    classes = torch.empty(lead + (m // 128, k // 128), dtype=torch.int32, device=x_t.device)
    dc = torch.empty(lead + (m, k // 2), dtype=torch.int8, device=x_t.device)
    dh = torch.empty(lead + (m, k), dtype=torch.int8, device=x_t.device)
    return classes, dc, dh


def _empty_out(dhigh: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """The fused GEMM's result, unwritten: (..., M, N) int32 for W (..., N, K)."""
    return torch.empty(dhigh.shape[:-1] + (w_nk.shape[-2],), dtype=torch.int32,
                       device=dhigh.device)


def hold_maps(classes: torch.Tensor, gn: int, *, w_transposed: bool = False):
    """The reference's prefetched block-index tables, for a 2-D class map.

    For each operand and each step t of the (i, j, kk) grid traversal (kk
    innermost) the table holds the block index to present: a step that
    needs the operand presents its real block; one that does not presents
    the index held at t - 1, or, before the first needed step, the first
    needed block. Needs: dc — class >= 1; dh — class 2; W — class >= 1.
    Returns (kd, kh, kw), each (gm * gn * gk, 2) int32 in traversal order."""
    classes = torch.as_tensor(classes)
    gm, gk = classes.shape
    shape = (gm, gn, gk)
    dev = classes.device
    cls3 = classes[:, None, :].expand(shape)
    ii = torch.arange(gm, device=dev)[:, None, None].expand(shape)
    jj = torch.arange(gn, device=dev)[None, :, None].expand(shape)
    kk = torch.arange(gk, device=dev)[None, None, :].expand(shape)

    def hold(need, real):
        flat_need = need.reshape(-1)
        flat_real = real.reshape(-1, 2)
        t = torch.arange(flat_need.numel(), device=dev)
        last = torch.cummax(torch.where(flat_need, t, -1), dim=0).values
        first = torch.argmax(flat_need.to(torch.int32))  # 0 when nothing is ever needed
        idx = torch.where(last >= 0, last, first)
        return flat_real[idx].to(torch.int32)

    d_real = torch.stack([ii, kk], dim=-1)
    w_real = torch.stack([jj, kk] if w_transposed else [kk, jj], dim=-1)
    return hold(cls3 >= 1, d_real), hold(cls3 == 2, d_real), hold(cls3 >= 1, w_real)
