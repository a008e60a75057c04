"""Elastic-scaling demo of the PyTorch/CUDA port: checkpoint under one
device layout, restore under another, and continue training bit-identically.

The port's counterpart of ``examples/elastic_rescale.py``. On a fleet this
is the node-loss path: a job falls back to fewer devices by restoring the
same checkpoint with new layouts (``CheckpointManager.restore`` takes a
tree of target layouts, ``distributed/sharding.py:Layout``). Here:

  * "mesh A": qwen3-0.6b (the reduced config) trains 10 steps, plainly on
    one device, and checkpoints;
  * "mesh B": the checkpoint is restored onto a (1, 1) ("data", "model")
    ``DeviceMesh`` of a one-rank process group (NCCL on the card, gloo on
    the CPU) with replicated layouts, as DTensors, and every leaf equals
    the saved state bit for bit;
  * training continues 5 steps on the restored tensors' local values, and
    each loss equals the loss of the never-restored state's next steps.

    python examples/elastic_rescale_torch.py                # on the card
    python examples/elastic_rescale_torch.py --device cpu   # no card

It runs on the card unless ``--device cpu`` is given; the checkpoint goes to
a fresh temporary directory unless ``--workdir`` names one.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import configs, tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.synthetic import DataCfg, batch_for  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels.common import resolve_device  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402

FIRST, MORE = 10, 5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run without")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    arch = configs.get("qwen3-0.6b").smoke()
    opt = steps_mod.make_optimizer(arch, total=FIRST + MORE)
    dc = DataCfg(seed=0, batch=4, seq_len=32)
    mgr = CheckpointManager(args.workdir or tempfile.mkdtemp(prefix="repro_torch_elastic_"))
    train = steps_mod.make_train_step(arch, opt)

    def run(state, steps):
        losses = []
        for step in steps:
            state, m = train(state, batch_for(arch, dc, step, device=dev))
            losses.append(float(m["loss"]))
        return state, losses

    # "mesh A": 10 steps, checkpoint
    state, losses = run(steps_mod.init_state(arch, 0, opt, device=dev), range(FIRST))
    mgr.save(FIRST, state)
    print(f"[mesh A] {FIRST} steps, loss={losses[-1]:.4f}, checkpointed")

    # "mesh B": restore with explicit (here: replicated) target layouts; the
    # same call takes any layout tree, e.g. param_shardings'
    with mesh_mod.local_group(dev):
        mesh = mesh_mod.make_test_mesh()
        layouts = tree.map_tree(lambda _: sharding.replicated(mesh), state)
        restored = mgr.restore(FIRST, state, shardings=layouts)
        for a, d in zip(tree.leaves(state), tree.leaves(restored)):
            if not torch.equal(a.cpu(), d.to_local().cpu()):
                raise AssertionError("restore onto the mesh is not bit-identical")
        print(f"[mesh B] restored onto a {tuple(mesh.shape)} {mesh.mesh_dim_names} mesh "
              f"({mesh.device_type}): bit-identical")

        # continue on the local values: the data is a function of (seed,
        # step), so the stream resumes exactly
        local = tree.map_tree(lambda d: d.to_local(), restored)
        _, got = run(local, range(FIRST, FIRST + MORE))
    _, want = run(state, range(FIRST, FIRST + MORE))
    if got != want:
        raise AssertionError(f"continued losses {got} differ from the unrestored run's {want}")
    print(f"[mesh B] continued to step {FIRST + MORE}, loss={got[-1]:.4f}, "
          f"equal to the unrestored run's")
    return got


if __name__ == "__main__":
    main()
