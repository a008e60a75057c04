"""Fault-tolerant training driver.

Mirror of ``src/repro/launch/train.py`` (the DiT and the LM stack):
  * resume-from-latest atomic checkpoint (async save off the step path)
  * deterministic seekable data and noise (both a function of (seed, step))
    -> a bit-identical restart
  * straggler mitigation: a step exceeding k x the rolling median is logged
    and counted (the hook a fleet's reschedule controller would read)
  * preemption safety: SIGTERM triggers an immediate checkpoint + clean exit

It runs on the card unless ``device="cpu"`` (``--device cpu``) is given,
and raises when asked for the card without one; nothing falls back.

``mesh=`` / ``shard=`` (the reference's): the step is built with ``shard``
(``launch/steps.py``); with a ``DeviceMesh`` the driver lays the state out
by ``launch/dryrun.py:state_shardings`` and each batch by
``batch_shardings`` under ``shard``'s rules, and checkpoints hold the
whole values (one process writes them).

Usage:  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
            --steps 100 --batch 8 --seq 128 [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import signal
import statistics
import time

import torch

from torch.distributed.tensor import DTensor

from .. import configs
from .. import tree as tr
from ..checkpoint.manager import CheckpointManager
from ..data.synthetic import DataCfg, batch_for
from ..distributed import sharding
from ..kernels.common import resolve_device
from . import dryrun
from . import steps as steps_mod

#: Default work directory: the git-ignored ``experiments/`` of the checkout.
DEFAULT_WORKDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
                               "experiments", "repro_torch_train")


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _laid_out(tree, lays):
    return tr.unflatten_like(tree, [sharding.layout(a, lay) for a, lay in
                                    zip(tr.leaves(tree), tr.leaves(lays))])


class TrainDriver:
    def __init__(
        self,
        arch: configs.ArchConfig,
        *,
        workdir: str,
        batch: int = 8,
        seq: int = 128,
        base_lr: float = 3e-4,
        total_steps: int = 100,
        ckpt_every: int = 50,
        straggler_factor: float = 3.0,
        seed: int = 0,
        device=None,
        mesh=None,
        shard=None,
    ):
        self.arch = arch
        self.device = resolve_device(device)
        self.data_cfg = DataCfg(seed=seed, batch=batch, seq_len=seq)
        self.total_steps = total_steps
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.ckpt = CheckpointManager(workdir)
        self.opt = steps_mod.make_optimizer(
            arch, base_lr=base_lr, warmup=steps_mod.driver_warmup(total_steps), total=total_steps
        )
        self.mesh = mesh
        self.rules = getattr(shard, "rules", None) or sharding.make_rules(arch)
        shards = (1 if mesh is None else
                  math.prod(sharding.mesh_axes(mesh)[a]
                            for a in sharding.batch_axes(mesh, self.rules)))
        self.train_step = steps_mod.make_train_step(arch, self.opt, shard=shard,
                                                    batch_shards=shards)
        self.seed = seed
        self._preempted = False
        self.straggler_events: list[int] = []
        self.metrics_log: list[dict] = []

    # -------------------------------------------------------------- plumbing
    def _install_signal_handler(self):
        def handler(signum, frame):
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # non-main thread (tests)

    def init_or_restore(self):
        state = steps_mod.init_state(self.arch, self.seed, self.opt, device=self.device)
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest, state)
            start = int(state["opt"]["step"])
        else:
            start = 0
        if self.mesh is not None:
            lays = dryrun.state_shardings(self.arch, self.mesh, self.rules, self.opt)
            state = {"params": _laid_out(state["params"], lays["params"]),
                     "opt": _laid_out(state["opt"], lays["opt"]), "rng": state["rng"]}
        return state, start

    def _batch(self, step: int) -> dict:
        batch = batch_for(self.arch, self.data_cfg, step, device=self.device)
        if self.mesh is None:
            return batch
        b, s = next(iter(batch.values())).shape[:2]
        lays, _ = dryrun.batch_shardings(self.arch, configs.ShapeCell("train", "train", s, b),
                                         self.mesh, self.rules)
        return {k: sharding.layout(v, lays[k]) for k, v in batch.items()}

    # ------------------------------------------------------------------ run
    def run(self, *, steps: int | None = None):
        self._install_signal_handler()
        state, start = self.init_or_restore()
        n = steps if steps is not None else self.total_steps
        durations: list[float] = []
        step = start
        while step < start + n and step < self.total_steps:
            t0 = time.monotonic()
            state, metrics = self.train_step(state, self._batch(step))
            # one transfer reads the three (and waits for the step)
            loss, gnorm, lr = torch.stack([_whole(metrics[k]) for k in
                                           ("loss", "grad_norm", "lr")]).tolist()
            dt = time.monotonic() - t0
            # ---- straggler watchdog ----
            if len(durations) >= 5:
                med = statistics.median(durations[-20:])
                if dt > self.straggler_factor * med:
                    self.straggler_events.append(step)
            durations.append(dt)
            self.metrics_log.append(
                {"step": step, "loss": loss, "dt": dt, "grad_norm": gnorm, "lr": lr}
            )
            step += 1
            if self._preempted:
                self.ckpt.save(step, state)  # sync: must land before exit
                return state, step
            if self.ckpt_every and step % self.ckpt_every == 0:
                self.ckpt.save_async(step, state)
        self.ckpt.wait()
        self.ckpt.save(step, state)
        return state, step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.names())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128, help="LM sequence length")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run without")
    args = ap.parse_args(argv)
    arch = configs.get(args.arch)
    if args.smoke:
        arch = arch.smoke()
    driver = TrainDriver(
        arch, workdir=args.workdir, batch=args.batch, seq=args.seq,
        base_lr=args.lr, total_steps=args.steps, device=args.device,
    )
    state, step = driver.run()
    first = driver.metrics_log[0]["loss"] if driver.metrics_log else float("nan")
    last = driver.metrics_log[-1]["loss"] if driver.metrics_log else float("nan")
    print(f"[train] arch={arch.name} device={driver.device} steps={step} loss {first:.4f} -> "
          f"{last:.4f} stragglers={len(driver.straggler_events)}")
    return driver


if __name__ == "__main__":
    main()
