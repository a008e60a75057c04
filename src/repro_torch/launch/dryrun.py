"""Dry run: count every (arch x input-shape) cell's step for one H100, and
lay each cell out on the production meshes.

Mirror of ``src/repro/launch/dryrun.py``. The reference lowers and compiles
each cell for a mesh of 256 or 512 forced host devices and reads XLA's
memory and cost analyses. The port has no compiler: the cell's step runs
once on fake tensors under ``repro_torch/launch/op_analysis.py``, which
counts its FLOPs, bytes, peak memory and collectives; ``roofline.py``
turns them into the H100's roofline terms. On one card (``--mesh 1``)
that is the plain step. On the production meshes (``16x16``,
``2x16x16``) it is the sharded step (``shard=``, ``launch/steps.py``) over
DTensors on a ``DeviceMesh`` of 256 or 512 ranks of the ``fake`` backend
(``launch/mesh.py:fake_mesh``, started and destroyed by the cell), its
inputs laid out by ``distributed/sharding.py``'s rules, counted for one
rank: the per-device program, its ``cost``, its ``collectives`` and its
``roofline``. The record also holds the bytes the layouts put on one
device (params, the AdamW moments, the decode cache, the batch). The W8A8
denoiser (``variant="int8"``) runs on its replicated int8 weights, each
rank's ``int8_matmul`` on its own rows (``models/dit_int8.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape prefill_32k --mesh 1 --batch 1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out experiments/dryrun_torch]

The recurrent families' long cells (``ssm`` / ``hybrid`` at
``prefill_32k`` and ``train_4k``) dispatch a few ops a token: counting
32768 tokens directly takes many minutes. They are counted at three
lengths L, 2L and 3L (multiples of the chunk); where every count is
exactly affine in the length, the record is extrapolated to the cell's
length and says ``extrapolated_from``; else the cell is counted directly.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback

import torch

from .. import configs
from .. import tree as tr
from ..configs.base import SHAPES, ArchConfig, ShapeCell, cell_applicable, input_specs
from ..distributed import sharding as sh
from ..distributed.sharding import cache_shardings_dict
from ..models.lm import LM
from ..optim import AdamW
from . import op_analysis, roofline
from . import steps as steps_mod
from .mesh import fake_mesh, make_production_mesh

MESHES = ("1", "16x16", "2x16x16")
#: The lengths the recurrent long cells are counted at: L, 2L, 3L.
EXTRAPOLATE_LEN = 512
LAYOUT_ONLY = "layouts only (program=False): the sharded step was not run"


# --------------------------------------------------------------------------
# layouts of state / batch / cache
# --------------------------------------------------------------------------


def state_shardings(arch: ArchConfig, mesh, rules, opt: AdamW):
    axes, shapes = steps_mod.param_axes(arch)
    p_sh = sh.param_shardings(axes, shapes, rules, mesh)
    # optimizer moments are flat lists in params-leaf order; v leaves may be
    # factored {"row","col"} dicts whose specs drop the corresponding dim
    m_sh, v_sh = [], []
    for a, s in zip(tr.leaves(axes), tr.leaves(shapes)):
        spec = sh.spec_for(a, tuple(s.shape), rules, mesh)
        m_sh.append(sh.spec_layout(mesh, spec))
        if opt.factored and s.dim() >= 2:
            v_sh.append({"row": sh.spec_layout(mesh, spec[:-1]),
                         "col": sh.spec_layout(mesh, spec[:-2] + (spec[-1],))})
        else:
            v_sh.append(sh.spec_layout(mesh, spec))
    return {
        "params": p_sh,
        "opt": {"m": m_sh, "v": v_sh, "step": sh.replicated(mesh)},
        "rng": sh.replicated(mesh),
    }


def batch_shardings(arch: ArchConfig, shape: ShapeCell, mesh, rules, *, batch: int | None = None):
    avail = sh.batch_axes(mesh, rules)
    size = math.prod(sh.mesh_axes(mesh)[a] for a in avail)

    def spec(t):
        if t.dim() == 0:
            return ()
        if avail and t.shape[0] % size == 0:
            return (avail[0] if len(avail) == 1 else avail,) + (None,) * (t.dim() - 1)
        return (None,) * t.dim()

    specs = input_specs(arch, shape, batch_override=batch)
    return {k: sh.spec_layout(mesh, spec(v)) for k, v in specs.items()}, specs


def _w8a8(arch: ArchConfig, shape: ShapeCell, variant: str) -> bool:
    """Whether a cell runs the W8A8 denoiser: ``variant="int8"`` on a
    diffusion arch's serving cells (its train cell trains the float DiT)."""
    return variant == "int8" and arch.family == "diffusion" and shape.kind != "train"


def _batch_shards(mesh, rules) -> int:
    return math.prod(sh.mesh_axes(mesh)[a] for a in sh.batch_axes(mesh, rules))


# --------------------------------------------------------------------------
# one card: the counted step
# --------------------------------------------------------------------------


def _meta_cache(arch: ArchConfig, batch: int, length: int) -> dict:
    return LM(arch).init_cache(batch, length, device="meta")


def _on_mesh(tree, lays):
    """Each tensor of ``tree`` (a shape and a dtype) as a DTensor laid out
    on its layout of ``lays``, the rank's block an empty ``meta`` tensor."""
    return tr.unflatten_like(tree, [sh.full(tuple(t.shape), 0, t.dtype, lay, "meta")
                                    for t, lay in zip(tr.leaves(tree), tr.leaves(lays))])


def count_sharded(arch: ArchConfig, shape: ShapeCell, mesh, rules, *, batch: int,
                  variant: str = "") -> dict:
    """``op_analysis.analyze`` of one cell's sharded step for one rank of
    ``mesh`` (a ``DeviceMesh``): params, optimizer state, batch and decode
    cache laid out by the rules on ``meta`` blocks, the LM steps built with
    ``shard=make_shard_fn(rules, mesh)``; the diffusion steps, which take no
    ``shard``, on the same layouts under ``sharding.replicating``
    (``variant="int8"``: the W8A8 denoiser on ``param_axes(int8=True)``'s
    replicated weights)."""
    shard = sh.make_shard_fn(rules, mesh)
    int8 = _w8a8(arch, shape, variant)
    axes, shapes = steps_mod.param_axes(arch, int8=int8)
    b_lays, specs = batch_shardings(arch, shape, mesh, rules, batch=batch)
    # a 0-d input (the decode position) stays a plain tensor
    inputs = {k: v if v.dim() == 0 else _on_mesh(v, b_lays[k]) for k, v in specs.items()}
    with sh.replicating(shard):
        if shape.kind == "train":
            opt = steps_mod.make_optimizer(arch)
            lays = state_shardings(arch, mesh, rules, opt)
            state = {"params": _on_mesh(shapes, lays["params"]),
                     "opt": _on_mesh(opt.init(shapes), lays["opt"]),
                     "rng": torch.zeros((), dtype=torch.int64)}
            step = steps_mod.make_train_step(arch, opt, shard=shard,
                                             batch_shards=_batch_shards(mesh, rules))
            if arch.family != "diffusion":
                return op_analysis.analyze(step, state, inputs)
            x0 = inputs["x0"]
            t = sh.full(x0.shape[:1], 0, torch.int64,
                        sh.Layout(mesh, b_lays["x0"].placements), "meta")
            eps = sh.full(tuple(x0.shape), 0, step.adtype, b_lays["x0"], "meta")
            return op_analysis.analyze(step.with_noise, state, inputs, t, eps)
        params = _on_mesh(shapes, sh.param_shardings(axes, shapes, rules, mesh))
        if arch.family == "diffusion":
            return op_analysis.analyze(steps_mod.make_denoise_step(arch, int8=int8), params,
                                       inputs)
        if shape.kind == "prefill":
            return op_analysis.analyze(steps_mod.make_prefill_step(arch, shard=shard), params,
                                       inputs)
        cache = LM(arch, shard=shard).init_cache(batch, shape.seq_len, device="meta")
        return op_analysis.analyze(steps_mod.make_decode_step(arch, shard=shard), params, cache,
                                   inputs)


def count_step(arch: ArchConfig, shape: ShapeCell, *, variant: str = "",
               batch: int | None = None) -> dict:
    """``op_analysis.analyze`` of one cell's step on fake tensors (on the
    card where one is visible, else on ``meta``): the diffusion cells as
    the reference's branch (the train step for ``train``, a denoiser
    forward at the cell's batch otherwise; ``variant="int8"`` the W8A8
    one), the LM cells' train, prefill or decode step. The diffusion train
    step is counted from its noise on (``with_noise``): drawing the noise
    reads the step counter on the host."""
    b = batch or shape.global_batch
    dev = op_analysis.fake_device()
    int8 = _w8a8(arch, shape, variant)
    with op_analysis.fake_mode():
        specs = op_analysis.fake_like(input_specs(arch, shape, batch_override=b), dev)
        _, shapes = steps_mod.param_axes(arch, int8=int8)
        params = op_analysis.fake_like(shapes, dev)
        if shape.kind == "train":
            opt = steps_mod.make_optimizer(arch)
            step = steps_mod.make_train_step(arch, opt)
            state = {"params": params, "opt": opt.init(params),
                     "rng": torch.zeros((), dtype=torch.int64)}
            if arch.family == "diffusion":
                x0 = specs["x0"]
                t = torch.empty((x0.shape[0],), dtype=torch.int64, device=dev)
                eps = torch.empty(x0.shape, dtype=step.adtype, device=dev)
                res = op_analysis.analyze(step.with_noise, state, specs, t, eps)
            else:
                res = op_analysis.analyze(step, state, specs)
        elif arch.family == "diffusion":
            res = op_analysis.analyze(steps_mod.make_denoise_step(arch, int8=int8), params, specs)
        elif shape.kind == "prefill":
            res = op_analysis.analyze(steps_mod.make_prefill_step(arch), params, specs)
        else:
            cache = op_analysis.fake_like(_meta_cache(arch, b, shape.seq_len), dev)
            res = op_analysis.analyze(steps_mod.make_decode_step(arch), params, cache, specs)
    del res["out"]
    return res


_TOTALS = ("flops", "hbm_bytes", "wire_bytes", "argument_bytes", "output_bytes",
           "alias_bytes", "temp_bytes", "peak_bytes")


def _coll_key(i: int, r: dict) -> tuple:
    return ("coll", i, r["op"], tuple(r["ranks"]), r["bandwidth"])


def _numbers(res: dict) -> dict:
    """The counts of an analysis, flattened: the totals, the FLOPs by dtype,
    each op's calls, FLOPs and bytes, and each collective's bytes (keyed by
    its place, op and group: another sequence of collectives is another
    set of keys)."""
    out = {k: res[k] for k in _TOTALS}
    out.update({("flops_by_dtype", dt): f for dt, f in res["flops_by_dtype"].items()})
    out.update({("by_op", op, i): v for op, row in res["by_op"].items()
                for i, v in enumerate(row)})
    for i, r in enumerate(res["collectives"]):
        out.update({_coll_key(i, r) + (f,): r[f] for f in ("result_bytes", "wire_bytes")})
    out.update({("coll_by_op", op, f): v for op, d in res["coll_by_op"].items()
                for f, v in d.items()})
    return out


def extrapolate(counts: list[dict], lengths: list[int], target: int) -> dict | None:
    """The analysis at ``target`` from analyses at lengths L, 2L, 3L, if every
    count is exactly affine in the length (f(3L) - f(2L) == f(2L) - f(L));
    else None."""
    nums = [_numbers(c) for c in counts]
    if any(n.keys() != nums[0].keys() or c["kernels"] for n, c in zip(nums, counts)):
        return None
    slope = {}
    for k in nums[0]:
        d1, d2 = nums[1][k] - nums[0][k], nums[2][k] - nums[1][k]
        if d1 != d2:
            return None
        slope[k] = d1
    steps = (target - lengths[0]) // (lengths[1] - lengths[0])
    at = {k: nums[0][k] + steps * slope[k] for k in nums[0]}
    res = dict(counts[0])
    res.update({k: at[k] for k in _TOTALS})
    res["flops_by_dtype"] = {k[1]: v for k, v in at.items() if k[0] == "flops_by_dtype"}
    res["by_op"] = {op: [at["by_op", op, i] for i in range(len(row))]
                    for op, row in counts[0]["by_op"].items()}
    res["collectives"] = [dict(r, **{f: at[_coll_key(i, r) + (f,)]
                                     for f in ("result_bytes", "wire_bytes")})
                          for i, r in enumerate(counts[0]["collectives"])]
    res["coll_by_op"] = {op: {f: at["coll_by_op", op, f] for f in d}
                         for op, d in counts[0]["coll_by_op"].items()}
    return res


def count_cell(arch: ArchConfig, shape: ShapeCell, *, variant: str = "",
               batch: int | None = None, count=None) -> tuple[dict, list | None]:
    """(analysis, the lengths it was extrapolated from or None). ``count``:
    ``fn(arch, shape) -> analysis`` (default: the one-card ``count_step``)."""
    count = count or functools.partial(count_step, variant=variant, batch=batch)
    long = (arch.family in ("ssm", "hybrid") and shape.kind in ("prefill", "train")
            and shape.seq_len > 3 * EXTRAPOLATE_LEN and shape.seq_len % EXTRAPOLATE_LEN == 0)
    if long:
        lengths = [EXTRAPOLATE_LEN * i for i in (1, 2, 3)]
        counts = [count(arch, dataclasses.replace(shape, seq_len=n)) for n in lengths]
        res = extrapolate(counts, lengths, shape.seq_len)
        if res is not None:
            return res, lengths
    return count(arch, shape), None


def _per_device(mesh, lays, shapes) -> int:
    return sum(sh.layout_bytes(s, lay) for s, lay in zip(tr.leaves(shapes), tr.leaves(lays)))


def layout_record(arch: ArchConfig, shape: ShapeCell, mesh, rules, *, variant: str = "",
                  batch: int | None = None) -> dict:
    """The bytes one device of a production mesh holds for the cell."""
    b = batch or shape.global_batch
    int8 = _w8a8(arch, shape, variant)
    axes, shapes = steps_mod.param_axes(arch, int8=int8)
    mem = {"param_bytes_per_device": sh.sharded_bytes(axes, shapes, rules, mesh)}
    if shape.kind == "train":
        opt = steps_mod.make_optimizer(arch)
        st = state_shardings(arch, mesh, rules, opt)
        moments = opt.init(shapes)
        mem["opt_bytes_per_device"] = (_per_device(mesh, st["opt"]["m"], moments["m"])
                                       + _per_device(mesh, st["opt"]["v"], moments["v"]))
    if arch.family != "diffusion" and shape.kind != "train":
        length = shape.seq_len
        cache = _meta_cache(arch, b, length)
        mem["cache_bytes_per_device"] = _per_device(
            mesh, cache_shardings_dict(arch, mesh, rules, cache), cache)
    b_sh, specs = batch_shardings(arch, shape, mesh, rules, batch=b)
    mem["batch_bytes_per_device"] = _per_device(mesh, b_sh, specs)
    mem["batch_shards"] = _batch_shards(mesh, rules)
    mem["state_bytes_per_device"] = sum(v for k, v in mem.items() if k.endswith("_per_device"))
    return mem


# --------------------------------------------------------------------------
# per-cell record
# --------------------------------------------------------------------------


def run_cell(arch: str | ArchConfig, shape_name: str, *, mesh: str = "16x16",
             variant: str = "", batch: int | None = None, seq: int | None = None,
             program: bool = True) -> dict:
    """The record of one cell on ``mesh`` ("1": one H100; "16x16" /
    "2x16x16": the production meshes), at the cell's global batch or
    ``batch``, and its sequence length or ``seq``. ``program=False``: on a
    production mesh, the layouts' bytes alone (status ``"layout"``)."""
    arch = configs.get(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name]
    if seq:
        shape = dataclasses.replace(shape, seq_len=seq)
    b = batch or shape.global_batch
    ok, reason = cell_applicable(arch, shape)
    one_card = mesh == "1"
    prod_mesh = None if one_card else make_production_mesh(multi_pod=mesh == "2x16x16")
    n_chips = 1 if one_card else math.prod(prod_mesh.axis_sizes)
    rec: dict = {
        "arch": arch.name,
        "shape": shape_name,
        "mesh": mesh,
        "n_chips": n_chips,
        "kind": shape.kind,
        "device": roofline.CARD,
        "batch": b,
        "seq": shape.seq_len,
        "variant": variant,
    }
    if not ok and not (arch.family == "diffusion" and shape.kind != "train"):
        rec["status"] = "skip"
        rec["reason"] = reason
        return rec
    mf = roofline.model_flops(arch, dataclasses.replace(shape, global_batch=b))
    t0 = time.monotonic()
    if not one_card:
        rules = sh.make_rules(arch, multi_pod=mesh == "2x16x16")
        layout = layout_record(arch, shape, prod_mesh, rules, variant=variant, batch=b)
        rec["layout_s"] = round(time.monotonic() - t0, 2)
        if not program:
            rec["memory"] = layout
            rec["fits"] = layout["state_bytes_per_device"] <= roofline.HBM_BYTES
            rec.update(cost=None, collectives=None, roofline=None, model_flops_global=mf,
                       status="layout", reason=LAYOUT_ONLY)
            return rec
        t0 = time.monotonic()
        with fake_mesh(prod_mesh) as dmesh:
            res, lengths = count_cell(arch, shape, count=functools.partial(
                count_sharded, mesh=dmesh, rules=rules, batch=b, variant=variant))
    else:
        res, lengths = count_cell(arch, shape, variant=variant, batch=b)
    rec["analyze_s"] = round(time.monotonic() - t0, 2)
    if lengths:
        rec["extrapolated_from"] = lengths
    rec["memory"] = {f"{k}_per_device": int(res[k]) for k in
                     ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
                      "peak_bytes")}
    if not one_card:
        rec["layout"] = layout
    rec["fits"] = res["peak_bytes"] <= roofline.HBM_BYTES
    rec["cost"] = {
        "flops_per_device": float(res["flops"]),
        "bytes_per_device": float(res["hbm_bytes"]),
        "flops_by_dtype": {str(dt).removeprefix("torch."): float(f)
                           for dt, f in res["flops_by_dtype"].items()},
        "kernels": res["kernels"],
        # op -> [calls, flops, bytes], the ops with the most bytes first
        "by_op": dict(sorted(res["by_op"].items(), key=lambda kv: -kv[1][2])),
    }
    rec["collectives"] = {
        "total_wire_bytes": float(res["wire_bytes"]),
        "by_op": res["coll_by_op"],
        "summary": roofline.collective_summary(res["collectives"]),
    }
    rec["roofline"] = roofline.roofline_terms(
        float(res["flops"]), float(res["hbm_bytes"]), float(res["wire_bytes"]),
        model_flops_global=mf, n_chips=n_chips, flops_by_dtype=res["flops_by_dtype"],
        collectives=res["collectives"])
    rec["status"] = "ok"
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.names())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=MESHES, help="1: one H100 (the counted step)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="", choices=["", "int8"])
    ap.add_argument("--batch", type=int, default=None, help="the global batch (default: the cell's)")
    ap.add_argument("--layouts-only", action="store_true",
                    help="production meshes: the layouts' bytes, not the sharded step")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.mesh:
        meshes = [args.mesh]
    elif args.both_meshes:
        meshes = ["16x16", "2x16x16"]
    else:
        meshes = ["2x16x16" if args.multi_pod else "16x16"]
    if args.all:
        cells = [(a, s, m) for a in configs.names() for s in SHAPES for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape, m) for m in meshes]

    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch_name, shape_name, mesh in cells:
        suffix = f"_{args.variant}" if args.variant else ""
        suffix += f"_b{args.batch}" if args.batch else ""
        tag = f"{arch_name}_{shape_name}_{mesh}{suffix}"
        try:
            rec = run_cell(arch_name, shape_name, mesh=mesh, variant=args.variant,
                           batch=args.batch, program=not args.layouts_only)
        except Exception as e:  # a failing cell is a bug: record it loudly
            rec = {
                "arch": arch_name,
                "shape": shape_name,
                "mesh": mesh,
                "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }
        results.append(rec)
        with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] {tag:44s} {rec['status']}{summary(rec)}", flush=True)
    n = {s: sum(r["status"] == s for r in results) for s in ("ok", "layout", "skip", "error")}
    print(f"[dryrun] done: {n['ok']} ok, {n['layout']} layout, {n['skip']} skip, "
          f"{n['error']} error")
    return 1 if n["error"] else 0


def summary(rec: dict) -> str:
    """The tail of a cell's printed line."""
    if rec["status"] == "ok":
        r = rec["roofline"]
        return (f" dom={r['dominant']} comp={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
                f"coll={r['collective_s']:.3e}s "
                f"peak={rec['memory']['peak_bytes_per_device'] / 2**30:.2f}GiB "
                f"fits={rec['fits']} analyze={rec['analyze_s']}s")
    if rec["status"] == "layout":
        m = rec["memory"]
        return (f" state={m['state_bytes_per_device'] / 2**30:.3f}GiB "
                f"params={m['param_bytes_per_device'] / 2**30:.3f}GiB fits={rec['fits']}")
    if rec["status"] == "skip":
        return f" ({rec['reason']})"
    return f" !! {rec.get('error', '')[:160]}"


if __name__ == "__main__":
    raise SystemExit(main())
