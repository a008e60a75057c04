"""LM pre-training driver demo of the PyTorch/CUDA port: fault tolerance and
gradient compression.

The port's counterpart of ``examples/train_lm.py``. Trains smollm-360m
(the reduced config) with ``repro_torch.launch.train.TrainDriver``:

  * phase 1 runs ``--preempt-at`` steps, as if preempted, and checkpoints;
  * phase 2, a fresh driver, resumes from the atomic checkpoint and runs
    to ``--steps``, bit-identically to a run that was never stopped (the
    data is a function of (seed, step));
  * phase 3, the int8 error-feedback compressed all-reduce
    (``distributed/collectives.py``) over a one-rank process group (NCCL
    on the card, gloo on the CPU): 20 rounds of a growing gradient, whose
    accumulated compressed means plus the residual equal the exact sum.

    python examples/train_lm_torch.py                  # on the card
    python examples/train_lm_torch.py --device cpu     # no card

It runs on the card unless ``--device cpu`` is given; the checkpoints go
to a fresh temporary directory unless ``--workdir`` names one.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.kernels.common import resolve_device  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.train import TrainDriver  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run without")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--preempt-at", type=int, default=25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    arch = configs.get("smollm-360m").smoke()
    workdir = args.workdir or tempfile.mkdtemp(prefix="repro_torch_lm_")
    kw = dict(workdir=workdir, batch=args.batch, seq=args.seq, total_steps=args.steps,
              ckpt_every=20, device=args.device)

    driver = TrainDriver(arch, **kw)
    # phase 1: run, then stop as if preempted (the run's end checkpoints)
    driver.run(steps=args.preempt_at)
    print(f"[phase1] steps={driver.metrics_log[-1]['step'] + 1} "
          f"loss={driver.metrics_log[-1]['loss']:.4f} (checkpointed)")

    # phase 2: a fresh driver resumes from the atomic checkpoint
    driver2 = TrainDriver(arch, **kw)
    driver2.run()
    print(f"[phase2] resumed -> step {driver2.metrics_log[-1]['step'] + 1} "
          f"loss={driver2.metrics_log[-1]['loss']:.4f} "
          f"stragglers={len(driver2.straggler_events)}")

    grad_compress(args.device)
    return driver2


def grad_compress(device=None) -> float:
    """Phase 3: 20 rounds of the compressed all-reduce of g (1 + 0.05 i)
    over a one-rank group; returns |acc + resid - exact| / |exact|. One
    rank's mean is its own dequantized payload, so this shows the
    error-feedback numerics of the int8 wire format end to end."""
    dev = resolve_device(device)
    g = torch.randn((4096,), generator=torch.Generator().manual_seed(0)).mul_(0.1).to(dev)
    resid = torch.zeros_like(g)
    acc_exact, acc_comp = torch.zeros_like(g), torch.zeros_like(g)
    with mesh_mod.local_group(dev):
        for i in range(20):
            gi = g * (1 + 0.05 * i)
            out, resid = collectives._compressed_psum_leaf(gi, resid)
            acc_comp += out
            acc_exact += gi
    err = float(torch.linalg.norm(acc_comp + resid - acc_exact) / torch.linalg.norm(acc_exact))
    print(f"[grad-compress] int8 error-feedback accumulated error: {err:.2e} "
          f"(wire bytes: 4x fewer than fp32, plus a 4-byte scale a leaf)")
    return err


if __name__ == "__main__":
    main()
