"""The port's lint: static analysis of ``src/repro_torch/`` and its runner-key audit.

Mirror of ``src/repro/analysis/``. Two pass families guard the serving
stack's central invariant — a :class:`~repro_torch.core.ditto.DittoPlan`'s
``cache_sig()`` IS the identity of the step the runner cache captures
(one CUDA graph a ``RunnerKey``, ``serve/cache.py``):

* :mod:`.trace_audit` proves both directions of ``cache_sig() ⇔ step``
  abstractly: it records what a step dispatches (aten ops and kernel
  launches) on fake tensors, so no kernel runs;
* :mod:`.kernel_contract`, :mod:`.trace_leak`, :mod:`.repo_rules` and
  :mod:`.plan_rules` are pure-AST rules over the kernels package and its
  C entries, the plan-threading boundary, the port's devices and imports,
  repo hygiene (bench registration, pytest markers) and the plan
  definition site (recovery knobs must stay out of
  ``cache_sig()``/``SEGMENT_FIELDS``; ``RunnerKey``'s accessors must read
  the sig's own slots).

Everything reports through :mod:`.findings`, the reference's format.
``python -m repro_torch.analysis`` runs it all. The AST passes import no
kernel and touch no device; :mod:`.trace_audit` is imported at call time.
"""
from .findings import (
    Finding,
    apply_baseline,
    load_baseline,
    render_report,
    report_json,
    write_baseline,
)
from .kernel_contract import check_kernels
from .plan_rules import check_plan_rules
from .repo_rules import check_repo_rules
from .trace_leak import check_trace_leaks

__all__ = [
    "Finding",
    "apply_baseline",
    "check_kernels",
    "check_plan_rules",
    "check_repo_rules",
    "check_trace_leaks",
    "load_baseline",
    "render_report",
    "report_json",
    "write_baseline",
]
