"""The control of a cell's ``correct``: the plain reference computed in the
precision below the configuration's (int4 products where the configuration
serves int8), put in the program's place and judged as a run judges the
program. It has to read above the cell's limit on every seed.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3

For each seed it makes the weights and the first ``sample_requests``
requests of the cell's traffic, as a run does, and prints the widest
relative gap of the control's latents from the reference's, beside the
limit. Runs on the card where there is one, else on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:1] = [ROOT, os.path.join(ROOT, "src")]

from perfbench import harness  # noqa: E402


def sample_requests(cell: harness.Cell, seed: int, device) -> list[harness.Request]:
    """The first ``sample_requests`` requests of the cell's traffic."""
    tr, n = cell.traffic, cell.traffic["sample_requests"]
    if tr["kind"] == "poisson":
        sizes = [images for _, images in harness.poisson_schedule(tr, seed, 1.0)[0][:n]]
    else:
        sizes = [tr["images_per_request"]] * n
    out = []
    for i, images in enumerate(sizes):
        x, cond = cell.family.make_request(cell.config["model"], seed, i, images, device)
        out.append(harness.Request(i, images, x, cond))
    return out


#: The control's integer width: int4, the precision below the int8 the
#: configurations serve.
CONTROL_BITS = 4


def control_gap(cell: harness.Cell, seed: int, device) -> float:
    """The control's widest relative gap from the reference at ``seed``."""
    import torch

    fam = cell.family
    weights = fam.make_weights(cell.config["model"], seed, device)
    reqs = sample_requests(cell, seed, device)
    with torch.no_grad():
        served = [fam.reference_sample(weights, cell.config, r.x, r.cond, bits=CONTROL_BITS)
                  for r in reqs]
    return harness.compare(cell, weights, reqs, served=served)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    limit = cell.config["correct"]["latent_rel_err"]
    for seed in args.seeds:
        gap = control_gap(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "bits": CONTROL_BITS,
                          "latent_rel_err": gap, "limit": limit, "fails": gap > limit}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
