"""Serving and design-point passes over the Ditto engine (``harness``) and
the accelerator cost model (``cycles``)."""
from . import cycles, harness
from .cycles import decide_defo, mode_fn_for, oracle_modes, price, scale_records, simulate
from .harness import collect_records, run_all, run_designs

__all__ = [
    "cycles",
    "harness",
    "decide_defo",
    "mode_fn_for",
    "oracle_modes",
    "price",
    "scale_records",
    "simulate",
    "collect_records",
    "run_all",
    "run_designs",
]
