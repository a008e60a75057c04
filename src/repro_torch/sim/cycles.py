"""Cycle/energy model of the accelerator designs (paper §V / §VI).

Mirror of ``src/repro/sim/cycles.py`` (pure Python, copied unchanged). It
prices the engine's records on the paper's modelled accelerators; none of
its numbers is a measurement of the card the port runs on.

One DittoEngine pass (policy='diff', collect_oracle=True) produces, per
(layer, step), the class statistics of every candidate operand mode:
``cls_act`` / ``cls_diff`` / ``cls_spatial``. The simulator prices those
records on each HwModel under each design's mode policy — iso-workload,
exactly like the paper's hooked-activation simulator.

Because the class statistics are *per-element fractions*, records can be
re-priced at paper-scale layer dimensions (``scale_records``): stats are
measured on trained reduced models (no pretrained checkpoints offline)
while the cycle economics use the real model's (t, k, n).

Pipelining: per-layer latency = max(compute, memory) + slack; Encoding /
VPU / Defo unit overheads are the paper-reported fractions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

from ..core.ditto.hwmodel import HwModel

ENC_LAT, VPU_LAT, DEFO_LAT = 0.001, 0.0017, 0.001  # latency overheads
ENC_E, VPU_E, DEFO_E = 0.0223, 0.029, 1e-6  # energy overheads


@dataclasses.dataclass
class LayerCost:
    layer: str
    step: int
    mode: str
    compute_cycles: float
    mem_cycles: float
    cycles: float
    energy_pj: float
    mem_bytes: float
    macs: float


def scale_records(
    records: Iterable[dict], *, t_mult: float = 1.0, d_mult: float = 1.0, seq_mult: float | None = None
) -> list[dict]:
    """Re-dimension records to the full model's layer sizes (stats kept).

    t_mult: token-row scaling (batch x tokens); d_mult: width scaling;
    seq_mult: tokens-per-sample scaling (attention score dims — the key
    sequence grows with tokens, the head dim does not). Attention rows
    also grow with width (heads = d / head_dim).
    """
    if seq_mult is None:
        seq_mult = t_mult
    out = []
    for r in records:
        r2 = dict(r)
        if r.get("attention"):
            r2["t"] = r["t"] * t_mult * d_mult  # rows: tokens x heads
            if r["kind"] == "attn_qk":  # (rows, hd) x (hd, seq)
                r2["k"] = r["k"]
                r2["n"] = r["n"] * seq_mult
            else:  # attn_pv: (rows, seq) x (seq, hd)
                r2["k"] = r["k"] * seq_mult
                r2["n"] = r["n"]
        else:
            r2["t"] = r["t"] * t_mult
            r2["k"] = r["k"] * d_mult
            r2["n"] = r["n"] * d_mult
        r2["macs"] = r2["t"] * r2["k"] * r2["n"]
        out.append(r2)
    return out


def _classes(rec: dict, mode: str):
    if mode == "diff":
        return rec.get("cls_diff", rec["cls_act"])
    if mode == "spatial":
        return rec.get("cls_spatial", rec["cls_act"])
    return rec["cls_act"]


def _mem_split(rec: dict, mode: str) -> tuple[float, float]:
    """(sram_bytes, dram_bytes). Weights and current activations stream
    through the 192MB SRAM; temporal-difference state (x_prev of every
    layer + int32 y_prev of every layer, persisting across the whole step)
    cannot fit and lives in DRAM — the diff-processing memory overhead the
    paper measures (Fig. 8)."""
    t, k, n = rec["t"], rec["k"], rec["n"]
    w_bytes = 0 if rec.get("attention") else k * n
    sram = w_bytes + t * k + t * n
    if mode != "diff":
        return sram, 0.0
    # y_prev is stored as 16-bit fixed point (the VPU requantizes between
    # layers; a 32-bit store would contradict the paper's own 2.75x
    # memory-access figure — PAPER.md). read previous + write current:
    dram = 4.0 * t * n
    if rec.get("boundary_in", True):
        dram += 2.0 * t * k  # x_prev read + x_t write (difference calc)
    # boundary_out=False (summation bypass) has no extra term: the
    # reconstruction write only exists when a non-linear consumer needs it,
    # and that case is already the boundary_in cost of the *next* layer.
    return sram, dram


def _mem_bytes(rec: dict, mode: str) -> float:
    s, d = _mem_split(rec, mode)
    return s + d


def price(rec: dict, hw: HwModel, mode: str) -> LayerCost:
    macs = rec["macs"]
    zero, low, full = _classes(rec, mode)
    sram_b, dram_b = _mem_split(rec, mode)
    mem = sram_b + dram_b

    if not hw.supports_low_bit:  # ITC: native 8-bit lanes, no skipping
        compute = macs / hw.n_pe
        e_mac = macs * hw.e_mac8
    elif hw.outlier_lanes:  # Cambricon-D: full-bit ops only on outliers
        if mode == "act":
            compute = macs / hw.outlier_lanes
            e_mac = macs * hw.e_mac8
        else:
            low_macs = macs * low
            full_macs = macs * full
            compute = max(low_macs / hw.n_pe, full_macs / hw.outlier_lanes)
            e_mac = low_macs * hw.e_mac4 + full_macs * hw.e_mac8
    else:  # Ditto / Diffy: 4-bit lanes, zero skip, 8-bit = 2 lanes
        if mode == "act":
            lanes = macs * hw.lanes_full
            e_mac = macs * 2 * hw.e_mac4
        else:
            # hw.lanes_mixed: the shared pricing hook with the engine —
            # diff-mode fractions come from measured class mixes (compiled
            # steps carry the executed tile-class histogram alongside)
            lanes = macs * hw.lanes_mixed(zero, low, full)
            e_mac = macs * (low * hw.e_mac4 + full * 2 * hw.e_mac4)
        compute = lanes / (hw.n_pe * hw.mults_per_pe)
    mem_cycles = sram_b / hw.sram_bytes_per_cycle + dram_b / hw.bytes_per_cycle
    cycles = max(compute, mem_cycles) + min(compute, mem_cycles) * hw.overlap_slack
    cycles *= 1 + ENC_LAT + VPU_LAT + DEFO_LAT
    energy = e_mac + sram_b * hw.e_sram_byte + dram_b * hw.e_dram_byte
    energy *= 1 + ENC_E + VPU_E + DEFO_E
    return LayerCost(rec["layer"], rec["step"], mode, compute, mem_cycles, cycles, energy, mem, macs)


# ---------------------------------------------------------------------------
# mode policies (per design point)
# ---------------------------------------------------------------------------


def by_layer_step(records) -> dict[str, dict[int, dict]]:
    out: dict[str, dict[int, dict]] = {}
    for r in records:
        out.setdefault(r["layer"], {})[r["step"]] = r
    return out


def decide_defo(records, hw: HwModel, *, plus: bool = False) -> dict[str, str]:
    """Paper §IV-B: per layer, compare step-1 act cycles with step-2 diff
    cycles (Defo+ also considers spatial); freeze for steps >= 3."""
    modes: dict[str, str] = {}
    for layer, steps in by_layer_step(records).items():
        r0, r1 = steps.get(0), steps.get(1)
        if r0 is None or r1 is None:
            modes[layer] = "act"
            continue
        cands = [(price(r1, hw, "diff").cycles, 0, "diff"), (price(r0, hw, "act").cycles, 1, "act")]
        if plus and "cls_spatial" in r0:
            cands.append((price(r0, hw, "spatial").cycles, 2, "spatial"))
        modes[layer] = min(cands)[2]
    return modes


def oracle_modes(records, hw: HwModel, *, plus: bool = False, temporal_ok=lambda r: True):
    """Per (layer, step) argmin mode — the 'ideal-Ditto' reference."""
    out = {}
    for r in records:
        cands = [(price(r, hw, "act").cycles, 1, "act")]
        if "cls_diff" in r and temporal_ok(r):
            cands.append((price(r, hw, "diff").cycles, 0, "diff"))
        if plus and "cls_spatial" in r:
            cands.append((price(r, hw, "spatial").cycles, 2, "spatial"))
        out[(r["layer"], r["step"])] = min(cands)[2]
    return out


def mode_fn_for(design: str, records, hw: HwModel, *, attention_diff: bool = True,
                dependency_check: bool = True) -> Callable[[dict], str]:
    """Returns mode_fn(rec) -> 'act'|'diff'|'spatial' for a design point.

    ``attention_diff=False`` models original Cambricon-D (attention at full
    bit-width); ``dependency_check=False`` removes the Defo boundary
    bypass (the record's boundary flags are forced True by the pricer when
    the rec carries ``no_dep_check``)."""
    if design == "itc":
        return lambda r: "act"
    if design == "diffy":
        return lambda r: "spatial" if "cls_spatial" in r else "act"
    if design == "cambricon-d":
        def fn(r):
            if r.get("attention") and not attention_diff:
                return "act"
            return "diff" if (r["step"] >= 1 and "cls_diff" in r) else "act"
        return fn
    if design in ("ditto", "ditto+"):
        plus = design == "ditto+"
        frozen = decide_defo(records, hw, plus=plus)
        first = "spatial" if plus else "act"

        def fn(r):
            if r["step"] == 0:
                return first if "cls_spatial" in r or not plus else "act"
            if r["step"] == 1:
                return "diff" if "cls_diff" in r else "act"
            m = frozen.get(r["layer"], "act")
            if m == "diff" and "cls_diff" not in r:
                return "act"
            if m == "spatial" and "cls_spatial" not in r:
                return "act"
            return m

        return fn
    raise ValueError(design)


def simulate(records, hw: HwModel, mode_fn: Callable[[dict], str]) -> dict:
    costs = [price(r, hw, mode_fn(r)) for r in records]
    total_cycles = sum(c.cycles for c in costs)
    return {
        "hw": hw.name,
        "cycles": total_cycles,
        "time_s": total_cycles / hw.freq_hz,
        "energy_j": sum(c.energy_pj for c in costs) * 1e-12,
        "mem_bytes": sum(c.mem_bytes for c in costs),
        "compute_cycles": sum(c.compute_cycles for c in costs),
        "mem_stall_cycles": sum(max(c.mem_cycles - c.compute_cycles, 0.0) for c in costs),
        "modes": {(c.layer, c.step): c.mode for c in costs},
        "per_layer": costs,
    }
