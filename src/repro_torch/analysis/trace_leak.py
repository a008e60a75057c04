"""AST trace-leak pass: no runner-key-invisible state may reach a kernel.

Mirror of ``src/repro/analysis/trace_leak.py`` over the port. The
runner-key contract says the compiled step (one captured CUDA graph a
key, ``serve/cache.py``) is a pure function of ``(cfg, modes,
plan.cache_sig(), bucket)``. The way that contract breaks in practice is
mundane: someone threads a launch knob into a kernel wrapper or a
``compiled.*_apply`` call from a module-level variable (a "tuning
table", a debug toggle, a cached default) instead of from a
:class:`DittoPlan` field. The knob changes what the step launches, the
key never hears about it, and a stale graph replays wrong results.

This pass flags exactly that shape: at every *boundary call* — the port's
counterpart of ``pallas_call``, ``common.call`` and any function of the
kernels package that reaches it (the wrappers and their ``launch*``), the
public functions of ``kernels/ops.py``, and anything named ``*_apply`` —
every knob-carrying keyword argument is scanned for free names: names not
bound by any enclosing function scope (parameters, locals, closure
bindings all count as plan-threaded, since the only way a value enters a
scope is through the plan-carrying call chain). A free name that resolves
to a module-level DATA binding is a trace leak. Imports, function/class
defs and literal constants are fine — they are part of the code identity,
not runtime state — and so is a call into one: ``common.encode_cluster(...)``
or ``common.sm_count(...)`` is code that asks the card, not module data.
"""
from __future__ import annotations

import ast
import os

from . import astutil
from .findings import Finding

#: files whose boundary calls the default run audits
DEFAULT_PATHS = (
    "src/repro_torch/kernels/ops.py",
    "src/repro_torch/core/ditto/compiled.py",
    "src/repro_torch/core/ditto/dit_runner.py",
)

#: the kernels package whose launch-reaching functions are boundaries
KERNELS_PKG = "src/repro_torch/kernels"

#: keyword names that select what a step launches (the knob surface of the
#: stack): the reference's, less ``interpret`` and ``grid`` (no port
#: counterpart), plus the forced K split and encode cluster of the
#: ``launch*`` entries
KNOB_KWARGS = frozenset({
    "bm", "bn", "bk", "block", "low_bits", "fused", "collect_stats", "plan",
    "w_transposed", "splits", "cluster",
})


def _is_boundary(callee_last: str, wrapper_names: set[str]) -> bool:
    return callee_last.endswith("_apply") or callee_last in wrapper_names


def _calls_with_scopes(tree: ast.Module):
    """Yield (enclosing function stack, Call) for every call in the module."""
    out: list[tuple[list, ast.Call]] = []

    def walk(stack, node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                walk(stack + [child], child)
            else:
                if isinstance(child, ast.Call):
                    out.append((list(stack), child))
                walk(stack, child)

    walk([], tree)
    return out


def check_module(tree: ast.Module, rel: str, *,
                 wrapper_names: set[str] = frozenset()) -> list[Finding]:
    """Trace-leak findings for one parsed module."""
    findings: list[Finding] = []
    module_data = astutil.module_data_bindings(tree)
    for stack, call in _calls_with_scopes(tree):
        name = astutil.call_name(call)
        if not name or not _is_boundary(name.rsplit(".", 1)[-1], wrapper_names):
            continue
        bound = astutil.bound_names_in_scope(stack) if stack else set()
        for kw in call.keywords:
            if kw.arg is not None and kw.arg not in KNOB_KWARGS:
                continue
            for node in ast.walk(kw.value):
                if not (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)):
                    continue
                if node.id in bound or node.id not in module_data:
                    continue
                knob = kw.arg or f"**{node.id}"
                findings.append(Finding(
                    "trace-leak", rel,
                    f"{name.rsplit('.', 1)[-1]}.{knob}",
                    f"module-level value '{node.id}' (defined at line "
                    f"{module_data[node.id]}) flows into {name}({knob}=...) — "
                    f"launch knobs must come from a DittoPlan field or a "
                    f"threaded parameter, never module state the runner key "
                    f"cannot see", call.lineno))
    return findings


def ops_wrapper_names(repo_root: str) -> set[str]:
    """The boundary: ``call``, every function of the kernels package that
    reaches it, and the public functions of ``kernels/ops.py``."""
    from .kernel_contract import launch_reaching, load_package

    mods = load_package(os.path.join(repo_root, KERNELS_PKG), repo_root)
    ops = next(m for m in mods if os.path.basename(m.rel) == "ops.py")
    return {"call"} | launch_reaching(mods) | {f.name for f in ops.public()}


def check_trace_leaks(repo_root: str, paths=DEFAULT_PATHS) -> list[Finding]:
    wrappers = ops_wrapper_names(repo_root)
    findings: list[Finding] = []
    for rel in paths:
        tree = astutil.parse_module(os.path.join(repo_root, rel))
        findings += check_module(tree, rel, wrapper_names=wrappers)
    return findings
