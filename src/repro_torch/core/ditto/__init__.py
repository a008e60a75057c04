"""The Ditto engine: quantization, classification, cost model, Defo, the
eager and compiled passes, and the DiT runner."""
from . import bops, classify, defo, quant
from .compiled import CompiledDittoEngine
from .dit_runner import CompiledDittoDiT, DittoDiT, make_denoise_fn, make_step_fn
from .engine import DittoEngine, LayerMeta
from .hwmodel import ALL_HW, CAMBRICON_D, DEFAULT_HW, DIFFY, DITTO_HW, ITC, HwModel
from .plan import EAGER_PLAN, DittoPlan, PlanSchedule

__all__ = [
    "bops",
    "classify",
    "defo",
    "quant",
    "DittoPlan",
    "PlanSchedule",
    "EAGER_PLAN",
    "DittoDiT",
    "CompiledDittoDiT",
    "CompiledDittoEngine",
    "make_denoise_fn",
    "make_step_fn",
    "DittoEngine",
    "LayerMeta",
    "ALL_HW",
    "CAMBRICON_D",
    "DEFAULT_HW",
    "DIFFY",
    "DITTO_HW",
    "ITC",
    "HwModel",
]
