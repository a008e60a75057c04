"""The dry run's roofline tables in markdown: the port's counterpart of
``tools/gen_roofline_md.py``.

    PYTHONPATH=src python -m repro_torch.launch.roofline_md [--dir experiments/dryrun_torch] [--mesh 16x16]

Reads every ``{arch}_{shape}_{mesh}[_variant][_bN].json`` that
``launch/dryrun.py:main`` wrote to ``--dir`` and prints one table for each
mesh (``1``: one H100; ``16x16``, ``2x16x16``: one device of the
production meshes), or for ``--mesh`` alone. The reference's columns
(peak GiB a device; compute, memory and collective seconds; the dominant
term; model over counted FLOPs; the roofline fraction) with the cell's
variant, batch and whether it fits the card. A ``layout`` record shows the
bytes its layouts put on a device, a ``skip`` record its reason, and an
``error`` record its error.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs.base import SHAPES
from .dryrun import MESHES

_HEAD = ("| arch | shape | variant | batch | peak GiB/dev | compute s | memory s | "
         "collective s | dominant | model/counted flops | roofline frac | fits |")


def load(directory: str) -> list[dict]:
    """Every record of ``directory``, in file-name order."""
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _row(r: dict) -> str:
    head = (f"| {r['arch']} | {r['shape']} | {r.get('variant') or '-'} | "
            f"{r.get('batch', '-')} |")
    status = r["status"]
    if status == "ok":
        rl = r["roofline"]
        peak = r["memory"]["peak_bytes_per_device"] / 2**30
        return (f"{head} {peak:.2f} | {rl['compute_s']:.3e} | {rl['memory_s']:.3e} | "
                f"{rl['collective_s']:.3e} | {rl['dominant']} | {rl['useful_flops_ratio']:.2f} | "
                f"{rl['roofline_fraction'] * 100:.2f}% | {r['fits']} |")
    if status == "layout":
        state = r["memory"]["state_bytes_per_device"] / 2**30
        return (f"{head} {state:.2f} (state, layouts only) | - | - | - | - | - | "
                f"{r.get('reason', '')} | {r['fits']} |")
    if status == "skip":
        return f"{head} - | - | - | - | - | - | {r.get('reason', 'skip')} | - |"
    err = r.get("error", "").replace("|", "/").replace("\n", " ")[:80]
    return f"{head} ERROR | | | | | | {err} | - |"


def render(recs: list[dict], mesh: str) -> str:
    """The markdown table of ``recs``' cells on ``mesh``, rows in (arch,
    shape, variant, batch) order; empty when none lies on it."""
    rows = [r for r in recs if r.get("mesh") == mesh]
    if not rows:
        return ""
    order = list(SHAPES)
    rows.sort(key=lambda r: (r["arch"], order.index(r["shape"]),
                             r.get("variant") or "", r.get("batch") or 0))
    where = "one H100" if mesh == "1" else f"one device of the {mesh} mesh"
    lines = [f"### Roofline on {where}: {len(rows)} cells", "", _HEAD,
             "|" + "---|" * _HEAD.count(" | ") + "---|"]
    return "\n".join(lines + [_row(r) for r in rows]) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", choices=MESHES, help="one mesh's table (default: every mesh's)")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    tables = [render(recs, m) for m in ([args.mesh] if args.mesh else MESHES)]
    tables = [t for t in tables if t]
    if not tables:
        print(f"no dry-run records in {args.dir}")
        return 1
    print("\n".join(tables), end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
