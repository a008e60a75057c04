"""Atomic, async checkpointing with restore into any like-tree.

Mirror of ``src/repro/checkpoint/manager.py``. Layout (one directory per
step):

    <dir>/step_000123/
        meta                  # JSON: step, leaf keys, shapes, dtypes
        arrays.npz            # one entry per leaf ('/'-joined keys)
        COMMIT                # written last -> partial checkpoints are never
                              # visible (atomic-commit fault tolerance)

Two differences from the reference, both forced: the meta is JSON (the
reference writes msgpack, which the card's machine does not have), and a
bfloat16 leaf (numpy has no bfloat16) is stored as its uint16 bits with
its dtype in the meta, and restored bit for bit (the reference widens it
to float32, also losslessly).

Restore loads every leaf on the host and moves it to the like-tree leaf's
device and dtype, then, given target layouts, lays it out on their mesh.
``save_async`` copies every leaf to host memory before it returns, so the
next step may update the tensors in place, and writes to disk on a
background thread so the train loop is not blocked.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import tree as tr
from ..distributed.sharding import layout


def _flatten(tree) -> dict:
    return {tr.key_of(path): leaf for path, leaf in tr.paths(tree)}


def _to_host(leaf) -> torch.Tensor:
    """A host copy of a leaf that later in-place updates cannot touch (a
    DTensor's whole value)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    return torch.as_tensor(leaf).detach().to("cpu", copy=True)


def _storable(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _load(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree) -> str:
        return self._write(step, tr.map_tree(_to_host, tree))

    def save_async(self, step: int, tree) -> None:
        self.wait()  # one in-flight save at a time
        host = tr.map_tree(_to_host, tree)
        self._thread = threading.Thread(target=self._write, args=(step, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree) -> str:
        path = os.path.join(self.dir, f"step_{step:09d}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(host_tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **{k: _storable(v) for k, v in flat.items()})
        meta = {
            "step": step,
            "keys": list(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "meta"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._gc()
        return path

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if name.startswith("step_") and os.path.exists(os.path.join(full, "COMMIT")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree, *, shardings=None):
        """Restore into the structure of ``like_tree``: each leaf on the like
        leaf's device, cast to its dtype. ``shardings``: an optional tree of
        target layouts (``distributed/sharding.py:Layout``, e.g. from
        ``param_shardings``) with the like-tree's keys; each leaf is then
        laid out on its mesh as a DTensor (the elastic restore onto a new
        mesh)."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        if not os.path.exists(os.path.join(path, "COMMIT")):
            raise FileNotFoundError(f"no committed checkpoint at {path}")
        with open(os.path.join(path, "meta")) as f:
            meta = json.load(f)
        flat_like = _flatten(like_tree)
        missing = [k for k in flat_like if k not in meta["dtypes"]]
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]}... ({len(missing)})")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            restored = [_load(data[k], meta["dtypes"][k]).to(like.device, like.dtype)
                        for k, like in flat_like.items()]
        if shardings is not None:
            target = _flatten(shardings)
            restored = [layout(v, target[k]) for k, v in zip(flat_like, restored)]
        return tr.unflatten_like(like_tree, restored)
