"""Quickstart of the PyTorch/CUDA port: the paper's pipeline in one script.

The port's counterpart of ``examples/quickstart.py``:

1. Train a tiny DiT denoiser on the synthetic latent mixture (the port's
   train step, ``repro_torch.launch.steps``).
2. Sample from it with float32 DDIM.
3. Sample again through the Ditto engine (quantized temporal-difference
   processing, with the act / diff statistics collected).
4. Print the similarity / zero / BOPs statistics and the simulated
   hardware win (``sim/harness.py:run_designs``).

    python examples/quickstart_torch.py                 # on the card
    python examples/quickstart_torch.py --device cpu    # no card

It runs on the card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import diffusion  # noqa: E402
from repro_torch.data.synthetic import DataCfg, batch_for  # noqa: E402
from repro_torch.kernels.common import resolve_device  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.nn import dit as dit_mod  # noqa: E402
from repro_torch.sim import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run without")
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--sample-steps", type=int, default=25)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- 1. train a small denoiser -------------------------------------
    arch = dataclasses.replace(
        configs.get("dit-xl2").smoke(), n_layers=3, d_model=64, input_size=16, n_classes=8
    )
    dcfg = steps_mod.make_dit_model(arch)
    opt = steps_mod.make_optimizer(arch, base_lr=2e-3, total=args.train_steps)
    state = steps_mod.init_state(arch, 0, opt, device=dev)
    train = steps_mod.make_train_step(arch, opt)
    dc = DataCfg(seed=0, batch=16, seq_len=1)
    for step in range(args.train_steps):
        state, metrics = train(state, batch_for(arch, dc, step, device=dev))
        if step % 50 == 0:
            print(f"[train] step {step:4d} loss {float(metrics['loss']):.4f}")
    params = state["params"]

    # ---- 2. FP32 reference sampling ------------------------------------
    sched = diffusion.cosine_schedule(1000)
    x = torch.randn((4, arch.input_size, arch.input_size, arch.in_channels),
                    generator=torch.Generator().manual_seed(7)).to(dev)
    labels = (torch.arange(4) % arch.n_classes).to(dev)

    def fp32_fn(xt, t, lab):
        return dit_mod.apply(params, dcfg, xt, t.to(torch.float32), lab)

    ref = diffusion.ddim_sample(sched.to(dev), fp32_fn, x, steps=args.sample_steps,
                                labels=labels)

    # ---- 3./4. Ditto serving + design-point simulation ------------------
    records, sample, eng = harness.collect_records(params, dcfg, sched, x, labels,
                                                   steps=args.sample_steps, device=dev)
    rel = float(torch.linalg.norm(sample - ref) / torch.linalg.norm(ref))
    recs = [r for r in records if r["step"] >= 1 and "cls_diff" in r]
    zero = float(np.mean([r["cls_diff"][0] for r in recs]))
    le4 = float(np.mean([r["cls_diff"][0] + r["cls_diff"][1] for r in recs]))
    s = eng.summary()
    print(f"[ditto] FP32-vs-Ditto rel L2          : {rel:.4f}")
    print(f"[ditto] temporal-diff zero fraction   : {zero:.1%}")
    print(f"[ditto] temporal-diff <=4-bit fraction: {le4:.1%}")
    print(f"[ditto] BOPs vs quantized baseline    : {s['bops']/s['bops_act']:.1%}")

    res = harness.run_designs(records, t_mult=64, d_mult=18)  # DiT-XL/2 scale
    t_itc = res["itc"]["time_s"]
    for d in ("gpu-a100", "itc", "diffy", "cambricon-d", "ditto", "ditto+"):
        r = res[d]
        print(f"[sim]  {d:12s} {r['time_s']*1e3:8.2f} ms/batch  "
              f"speedup vs ITC {t_itc/r['time_s']:5.2f}x  energy {r['energy_j']:.3f} J")
    return res


if __name__ == "__main__":
    main()
