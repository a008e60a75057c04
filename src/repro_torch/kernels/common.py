"""Shared kernel-wrapper helpers of the port.

* :func:`resolve_device` — the port's counterpart of the reference's
  ``resolve_interpret``: entry points run on ``cuda`` unless the caller
  asks for the CPU, and raise when no card is present instead of carrying
  on silently on the CPU.
* :func:`pad2` — zero-padding the last two dims up to the tile grid (the
  128-tile padding contract of every kernel module).
* :func:`validate_low_bits` — the ``low_bits`` domain check.
* :func:`diff_gemm_splits` — the K split the GEMMs' shared kernel
  (``csrc/diff_gemm_sm90.cuh``: both difference GEMMs and ``int8_matmul``)
  chooses for a launch on the card.
* :func:`encode_cluster` — the thread-block cluster the encodes
  (``csrc/encode_sm90.cuh``) split each class tile over, and
  :func:`sm_count`, the card's SMs it is chosen for.
* :func:`cuda_fn` / :func:`build_library` — build the CUDA sources under
  ``csrc`` with ``nvcc`` into one shared library with a plain C interface
  and bind its entry points with ``ctypes``. The library is named after a
  hash of the sources and flags, so a stale build is never loaded; it is
  built on first use, under a lock (two serving threads may reach their
  first launch together), never at import (the CPU tests import every
  module).
* :func:`refuse_dtensor` — a wrapper takes plain tensors only: a
  ``DTensor`` raises, naming ``distributed/sharding.py:row_local``, which
  hands each rank's block to a wrapper as a plain tensor (the plain
  version would run on the whole value, and the kernel would read a
  ``DTensor``'s pointer).
* :func:`record_work` / :func:`recording` — a wrapper reports the work
  of a launch (operations, bytes) to the step analyzer
  (``repro_torch/launch/op_analysis.py``), and its static arguments
  (:func:`operands`: shapes and dtypes; ``low_bits``, ``w_transposed``,
  whether ``y_prev`` is given) to the runner-key audit
  (``repro_torch/analysis/trace_audit.py``); neither can see a ``ctypes``
  launch in the dispatch. A no-op costing two ``None`` checks unless an
  analysis has installed a recorder.
* :func:`call` — every wrapper's launch: the C entry runs under
  ``torch.cuda.device(<the operand's device>)`` on that device's current
  stream. The entries ask ``cudaGetDevice`` for the SM count and the
  shared-memory attribute, and a serving thread's current device need not
  be the operand's (a mesh shard on ``cuda:1`` served from a fresh
  thread).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

__all__ = ["DEFAULT_LOW_BITS", "LOW_BIT_MAX", "pad2", "validate_low_bits",
           "diff_gemm_splits", "ENCODE_CLUSTERS", "encode_cluster", "sm_count",
           "resolve_device", "is_fake", "refuse_dtensor", "operands", "record_work",
           "recording", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build_library",
           "cuda_fn", "call", "launch_check", "row_strides", "check_cuda_operand"]

#: The int8-everywhere default; DittoPlan.low_bits and every kernel
#: signature share this one constant.
DEFAULT_LOW_BITS = 8

#: Largest |Δ| a signed 4-bit lane holds: the class-1 (low) tile threshold
#: of diff_encode, the element classes and the BOPs accounting.
LOW_BIT_MAX = 7

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for ``cuda`` without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def is_fake(t: torch.Tensor) -> bool:
    """A tensor with no data: a meta tensor, or a fake one (``FakeTensorMode``)."""
    return t.is_meta or isinstance(t, FakeTensor)


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise ``TypeError`` when an operand of the wrapper ``name`` is a
    ``DTensor``: a kernel runs on one rank's block, which
    ``sharding.row_local`` hands it as a plain tensor."""
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(
                f"{name}: got a DTensor ({t.placements} over {t.device_mesh}); a kernel "
                f"runs on one rank's block: call it under sharding.row_local, which hands "
                f"it each rank's rows as a plain tensor")


_recorder = None
_launch_recorder = None


def operands(*tensors) -> tuple:
    """``(shape, dtype)`` of each tensor operand of a launch (``None`` for an
    operand not given): the static arguments a recorded launch carries."""
    return tuple(None if t is None else (tuple(t.shape), str(t.dtype)) for t in tensors)


def record_work(name: str, *, flops: float, nbytes: float, dtype: torch.dtype,
                static: dict | None = None) -> None:
    """Report one launch to the recorders :func:`recording` installed: its
    work to ``recorder``, its static arguments to ``launches``; a no-op
    without them."""
    if _recorder is not None:
        _recorder(name, flops=flops, nbytes=nbytes, dtype=dtype)
    if _launch_recorder is not None:
        _launch_recorder(name, static or {})


@contextlib.contextmanager
def recording(recorder=None, *, launches=None):
    """Install ``recorder(name, flops=, nbytes=, dtype=)`` and
    ``launches(name, static)`` for the block (either may be ``None``)."""
    global _recorder, _launch_recorder
    saved = _recorder, _launch_recorder
    _recorder, _launch_recorder = recorder, launches
    try:
        yield
    finally:
        _recorder, _launch_recorder = saved


def pad2(a: torch.Tensor, br: int, bc: int, fill: int = 0) -> torch.Tensor:
    """Zero-pad the last two dims (R, C) so R % br == C % bc == 0."""
    r, c = a.shape[-2:]
    pr, pc = (-r) % br, (-c) % bc
    if pr or pc:
        a = F.pad(a, (0, pc, 0, pr), value=fill)
    return a


def validate_low_bits(low_bits: int) -> int:
    """Only 4 (packed-int4 low tiles) and 8 (int8 everywhere) exist."""
    if low_bits not in (4, 8):
        raise ValueError(
            f"low_bits must be 4 (packed-int4 low-tile branch) or 8 (int8), "
            f"got {low_bits!r}")
    return low_bits


# ------------------------------------------------------------ CUDA library
def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libditto_kernels_{h.hexdigest()[:16]}.so"


def build_library(*, verbose: bool = False) -> tuple[Path, float]:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, all started together),
    link them into one shared library and return ``(path, seconds)``.
    Returns at once with 0 seconds when the library for these sources
    exists already."""
    out = library_path()
    if out.exists():
        return out, 0.0
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, _, proc in jobs:
            log, _ = proc.communicate()
            if verbose and log:
                print(f"--- nvcc {src.name}\n{log}", flush=True)
            if proc.returncode:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_so),
                               *(str(o) for _, o, _ in jobs)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, out)
    return out, time.perf_counter() - t0


_lib: ctypes.CDLL | None = None
_fns: dict = {}
_load_lock = threading.Lock()


def cuda_fn(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry ``name`` of the kernel library (built and loaded on first
    use, under a lock), with its ``argtypes`` declared and an ``int``
    (cudaError_t) result."""
    global _lib
    fn = _fns.get(name)
    if fn is None:
        with _load_lock:
            fn = _fns.get(name)
            if fn is None:
                if _lib is None:
                    path, _ = build_library()
                    lib = ctypes.CDLL(str(path))
                    lib.ditto_error_string.argtypes = [ctypes.c_int]
                    lib.ditto_error_string.restype = ctypes.c_char_p
                    _lib = lib
                fn = getattr(_lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name] = fn
    return fn


def call(label: str, name: str, argtypes: list, device: torch.device, *args) -> None:
    """Run the C entry ``name`` with ``args`` and, last, the current stream
    of ``device`` (the operands' card), with ``device`` the thread's current
    device while it runs; raise as :func:`launch_check` does (``label``
    names the kernel)."""
    fn = cuda_fn(name, argtypes)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    launch_check(label, rc)


def launch_check(name: str, rc: int) -> None:
    """Raise when a C entry returned a non-zero ``cudaGetLastError()``, or
    -1: a thread-block cluster the kernel cannot take (a GEMM whose K needs
    more splits than a cluster holds, a K split or an encode cluster size
    it does not have)."""
    if rc == -1:
        raise RuntimeError(f"{name}: the kernel cannot take this launch's thread-block "
                           f"cluster (the size asked for, or the class tiles K needs)")
    if rc:
        msg = _lib.ditto_error_string(rc).decode() if _lib is not None else ""
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc} ({msg})")


def diff_gemm_splits(batch: int, m: int, n: int, k: int) -> int:
    """The K split the GEMMs' shared kernel (both difference GEMMs and
    ``int8_matmul``) launches a (batch, M, N, K) product with on the
    current card (``choose_splits`` in ``csrc/diff_gemm_sm90.cuh``, from the
    shape and the card's SM count)."""
    rc = cuda_fn("ditto_diff_gemm_splits", [ctypes.c_int64] * 4)(batch, m, n, k)
    launch_check("ditto_diff_gemm_splits", -1 if rc == 0 else -rc if rc < 0 else 0)
    return rc


#: Blocks of a cluster an encode can split a class tile over: the portable
#: cluster sizes that divide a tile's 128 rows (``csrc/encode_sm90.cuh``).
ENCODE_CLUSTERS = (1, 2, 4, 8)


def encode_cluster(tiles: int, sms: int) -> int:
    """The cluster size an encode launch of ``tiles`` class tiles (batch
    included) takes on a card of ``sms`` SMs: the largest whose grid of
    ``tiles * C`` blocks gives no SM a second block, at least 1. Fitted to
    benchmarks/torch_encode_sweep.py at DiT-XL/2's shapes (PERF.md)."""
    return max(c for c in ENCODE_CLUSTERS if c == 1 or tiles * c <= sms)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def row_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """``t`` seen as (batch, rows, last dim), its leading dims flattened
    into the batch: ``(rows a batch, row stride, batch stride)`` in
    elements. ``None`` unless the last dim is contiguous, the leading dims
    flatten at one stride and no two rows overlap: a slice of the rows and
    columns of a contiguous tensor, such as a padded GEMM result cut back
    to its shape."""
    if t.dim() < 2:
        return None
    m, width = t.shape[-2:]
    if width > 1 and t.stride(-1) != 1:
        return None
    ld = t.stride(-2) if m > 1 else width
    batch_ld = span = None
    for size, stride in reversed(list(zip(t.shape[:-2], t.stride()[:-2]))):
        if size == 1:
            continue
        if batch_ld is None:
            batch_ld, span = stride, stride * size
        elif stride != span:
            return None
        else:
            span *= size
    if batch_ld is None:
        batch_ld = m * ld
    if ld < width or batch_ld < (m - 1) * ld + width:
        return None
    return m, ld, batch_ld


def check_cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype, *, rows: bool = False,
                       align: int = 16) -> None:
    """What every kernel needs of a tensor operand: on the card, the right
    dtype, contiguous, and 16-byte aligned for vector loads. ``rows`` takes
    strided rows (:func:`row_strides`) in place of contiguous;
    ``align`` is the alignment in bytes (4 for an operand read as scalars)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if rows:
        if row_strides(t) is None:
            raise ValueError(f"{name}: expected strided rows, the last dim contiguous")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer is not {align}-byte aligned")
