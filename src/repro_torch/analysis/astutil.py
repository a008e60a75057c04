"""Shared AST plumbing for the port's lint passes.

Mirror of ``src/repro/analysis/astutil.py``, carried over whole. Small,
dependency-free helpers over :mod:`ast`: parse a module, enumerate public
top-level functions, resolve dotted call names, classify imports vs
module-level data bindings, and collect the name-binding environment of
nested function scopes. Every rule module builds on these so the passes
agree on what "public", "imported" and "locally bound" mean.
"""
from __future__ import annotations

import ast


def parse_module(path: str) -> ast.Module:
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def dotted_name(node: ast.expr) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    """Dotted name of a call target (``ops.ditto_linear_step``), else None."""
    return dotted_name(call.func)


def root_name(node: ast.expr) -> str | None:
    """The leftmost Name of an attribute/subscript chain (``plan`` for
    ``plan.low_bits``, ``cfg`` for ``cfg.shape[0]``), else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def public_functions(tree: ast.Module) -> list[ast.FunctionDef]:
    """Top-level ``def``s whose name has no leading underscore."""
    return [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")]


def all_functions(tree: ast.Module) -> list[ast.FunctionDef]:
    return [n for n in tree.body if isinstance(n, ast.FunctionDef)]


def function_param_names(fn: ast.FunctionDef | ast.Lambda) -> list[str]:
    a = fn.args
    params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        params.append(a.vararg.arg)
    if a.kwarg:
        params.append(a.kwarg.arg)
    return params


def calls_in(node: ast.AST) -> list[ast.Call]:
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)]


def called_names(node: ast.AST) -> set[str]:
    """Dotted names of every call inside ``node`` plus their last segment,
    so both ``resolve_device`` and ``common.resolve_device`` match a
    bare-name query."""
    out: set[str] = set()
    for c in calls_in(node):
        name = call_name(c)
        if name:
            out.add(name)
            out.add(name.rsplit(".", 1)[-1])
    return out


def module_all(tree: ast.Module) -> tuple[list[str] | None, int]:
    """(names listed in ``__all__``, line) — (None, 0) when absent."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    if isinstance(node.value, (ast.List, ast.Tuple)):
                        names = [e.value for e in node.value.elts
                                 if isinstance(e, ast.Constant) and isinstance(e.value, str)]
                        return names, node.lineno
    return None, 0


def defined_public_names(tree: ast.Module) -> set[str]:
    """Public top-level defs, classes and assigned constants (not imports,
    not ``__all__`` itself)."""
    names: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and not t.id.startswith("_") and t.id != "__all__":
                    names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if not node.target.id.startswith("_"):
                names.add(node.target.id)
    return names


def imported_from_names(tree: ast.Module) -> set[str]:
    """Names bound by ``from X import a, b`` (the re-exportable kind);
    plain ``import X`` module bindings are excluded."""
    names: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


def imported_names(tree: ast.Module) -> set[str]:
    """Every name any import statement binds at module level."""
    names = imported_from_names(tree)
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                names.add(a.asname or a.name.split(".")[0])
    return names


def module_data_bindings(tree: ast.Module) -> dict[str, int]:
    """Module-level DATA assignments (name -> line): plain variables that
    are neither imports, functions, classes nor ``__all__``. These are the
    bindings the trace-leak pass treats as cache-key-invisible state."""
    imports = imported_names(tree)
    out: dict[str, int] = {}
    for node in tree.body:
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            for el in ast.walk(t):
                if isinstance(el, ast.Name) and el.id != "__all__" and el.id not in imports:
                    out.setdefault(el.id, node.lineno)
    return out


def bound_names_in_scope(fns: list[ast.FunctionDef | ast.Lambda]) -> set[str]:
    """Every name bound anywhere in a stack of (nested) function scopes:
    parameters, assignment targets, for-loop targets, with-as names,
    comprehension targets and nested def/lambda names."""
    bound: set[str] = set()
    for fn in fns:
        bound.update(function_param_names(fn))
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                    for t in targets:
                        for el in ast.walk(t):
                            if isinstance(el, ast.Name):
                                bound.add(el.id)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    for el in ast.walk(node.target):
                        if isinstance(el, ast.Name):
                            bound.add(el.id)
                elif isinstance(node, ast.withitem) and node.optional_vars is not None:
                    for el in ast.walk(node.optional_vars):
                        if isinstance(el, ast.Name):
                            bound.add(el.id)
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    bound.add(node.name)
    return bound
