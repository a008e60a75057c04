"""Hardware cost-model parameters of the engine (port of
``src/repro/core/ditto/hwmodel.py``, pure Python, copied unchanged).

Paper Table III (iso-area at 64.48 mm^2, 45nm, 1 GHz):
    ITC          27648 A8W8 PEs (int Tensor-Core baseline)
    Diffy        39398 A4W8 PEs (spatial differences)
    Cambricon-D  38280 A4W8 normal + 2552 A8W8 outlier PEs (temporal diffs)
    Ditto        39398 A4W8 PEs (single PE design, enc/VPU/Defo units)

An A4W8 PE here is one 4-bit x 8-bit multiplier feeding an adder tree;
an 8-bit activation op consumes two multipliers + shift (paper §V-B). The
ITC's A8W8 PE counts as two 4-bit multiplier-equivalents for iso-area
accounting, matching 27648*2 ≈ 39398*1.4... the paper's area numbers; we
keep the paper's PE counts and express throughput in 4-bit-multiplier
lanes: ITC lanes = 27648 (native 8-bit, 1 MAC/cycle each).

Energy constants: 45nm literature values (Horowitz ISSCC'14 style):
    int8 MAC 0.23 pJ   int4 MAC 0.07 pJ  (mult) + adder tree amortized
    SRAM access 5 pJ/byte    DRAM access 160 pJ/byte
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HwModel:
    name: str = "ditto"
    n_pe: int = 39398
    mults_per_pe: int = 1  # 4-bit multiplier lanes per PE
    # lanes needed per MAC by operand class
    lanes_low: float = 1.0  # 4-bit activation
    lanes_full: float = 2.0  # 8-bit activation (two mults + shifter)
    supports_zero_skip: bool = True
    supports_low_bit: bool = True
    # outlier-PE designs (Cambricon-D): full ops ONLY on outlier lanes
    outlier_lanes: int = 0
    freq_hz: float = 1e9
    # memory system: weights/current activations stream via the 192MB SRAM;
    # temporal-difference state (x_prev / y_prev across ALL layers) cannot
    # fit and lives in DRAM — the paper's diff-processing memory overhead.
    bytes_per_cycle: float = 1024.0  # DRAM bandwidth / freq (1 TB/s HBM-class)
    sram_bytes_per_cycle: float = 4096.0  # on-chip SRAM bandwidth / freq
    sram_bytes: int = 192 * 2**20
    overlap_slack: float = 0.05  # imperfect compute/mem pipelining
    # energy (pJ)
    e_mac8: float = 0.23
    e_mac4: float = 0.07
    e_sram_byte: float = 2.0
    e_dram_byte: float = 24.0  # HBM2-class (~3 pJ/bit)
    power_w: float = 33.6

    def lanes_mixed(self, zero: float, low: float, full: float) -> float:
        """4-bit-multiplier lanes per MAC for a measured zero/low/full mix.

        THE pricing hook for difference execution: the engine and the
        design-point simulator both call it with class fractions — on the
        compiled path these come from the measured per-step tile-class
        histogram (``tile_hist``, what ``ditto_diff_matmul`` actually
        skipped / narrowed), so priced savings track realized execution.
        Zero-class work costs nothing when the design skips it; low-class
        work runs one 4-bit lane; full-class work pays ``lanes_full``
        (two multipliers + shift on Ditto-style PEs). Designs without
        low-bit support (ITC) execute every MAC on one native 8-bit lane.
        """
        if not self.supports_low_bit:
            return 1.0
        zero_lanes = 0.0 if self.supports_zero_skip else zero * self.lanes_low
        return zero_lanes + low * self.lanes_low + full * self.lanes_full


ITC = HwModel(
    name="itc", n_pe=27648, lanes_low=1.0, lanes_full=1.0,
    supports_zero_skip=False, supports_low_bit=False, power_w=36.9,
)
DIFFY = HwModel(name="diffy", n_pe=39398, power_w=33.6)
CAMBRICON_D = HwModel(
    name="cambricon-d", n_pe=38280, outlier_lanes=2552, power_w=33.3,
)
DITTO_HW = HwModel(name="ditto", n_pe=39398, power_w=33.6)
DEFAULT_HW = DITTO_HW

ALL_HW = {h.name: h for h in (ITC, DIFFY, CAMBRICON_D, DITTO_HW)}
