"""Repo-hygiene rules: drift catchers outside the kernels package.

Mirror of ``src/repro/analysis/repo_rules.py`` (``bench-registration`` and
``marker-audit`` carried over), plus a rule of the port's own.

``bench-registration``
    Every ``benchmarks/bench_*.py`` must appear in the ``MODULES`` list of
    ``benchmarks/run.py`` — an unregistered benchmark silently drops out
    of the perf-history pipeline — and every ``MODULES`` entry must have a
    matching file, so the list cannot reference deleted modules. (The
    port's benchmarks are ``benchmarks/torch_*.py`` and stay outside it.)

``marker-audit``
    Every pytest marker used in ``tests/`` must be declared in
    ``pytest.ini`` (undeclared markers are typo'd selectors: ``-m slow``
    matches nothing and nobody notices), and every declared marker must be
    used somewhere (a dead declaration hides the day the last slow test
    was accidentally unmarked).

``port-imports``
    The port stands alone: no module under ``src/repro_torch/``, nor
    ``chip_smoke.py``, the examples whose name ends in ``_torch`` or the
    benchmarks whose name starts with ``torch_``, imports ``jax``, ``jaxlib``, ``repro`` or ``repro.*`` — at module level
    or inside a function, by an import statement or by
    ``importlib.import_module`` / ``__import__`` with a literal name. The
    chip machine has no JAX, and a reference module on the port's path
    would make the port's results the reference's. Tests that import both
    packages are exempt: they hold one against the other.

All three rules are pure AST/ini reads — no imports, no test collection.
"""
from __future__ import annotations

import ast
import configparser
import glob
import os

from . import astutil
from .findings import Finding

#: pytest built-in marks — usable without declaration
_BUILTIN_MARKS = frozenset({
    "parametrize", "skip", "skipif", "xfail", "usefixtures", "filterwarnings",
})


# ----------------------------------------------------------- bench modules
def registered_bench_modules(run_py: str) -> tuple[set[str], int]:
    """Names in run.py's MODULES list (module-level string list)."""
    tree = astutil.parse_module(run_py)
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "MODULES" \
                        and isinstance(node.value, (ast.List, ast.Tuple)):
                    names = {e.value for e in node.value.elts
                             if isinstance(e, ast.Constant) and isinstance(e.value, str)}
                    return names, node.lineno
    return set(), 0


def check_bench_registration(repo_root: str, bench_dir: str = "benchmarks") -> list[Finding]:
    run_rel = f"{bench_dir}/run.py"
    registered, line = registered_bench_modules(os.path.join(repo_root, run_rel))
    findings = []
    if not registered:
        return [Finding("bench-registration", run_rel, "MODULES",
                        "benchmarks/run.py has no module-level MODULES list", 0)]
    on_disk = {
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(repo_root, bench_dir, "bench_*.py"))
    }
    for missing in sorted(on_disk - registered):
        findings.append(Finding(
            "bench-registration", f"{bench_dir}/{missing}.py", missing,
            f"benchmark module '{missing}' exists but is not registered in "
            f"{run_rel} MODULES — it will never run in the perf pipeline", 0))
    bench_entries = {m for m in registered if m.startswith("bench_")}
    for ghost in sorted(bench_entries - on_disk):
        findings.append(Finding(
            "bench-registration", run_rel, ghost,
            f"{run_rel} registers '{ghost}' but {bench_dir}/{ghost}.py does not exist",
            line))
    return findings


# ------------------------------------------------------------ marker audit
def declared_markers(pytest_ini: str) -> set[str]:
    cp = configparser.ConfigParser()
    cp.read(pytest_ini)
    if not cp.has_option("pytest", "markers"):
        return set()
    names = set()
    for ln in cp.get("pytest", "markers").splitlines():
        ln = ln.strip()
        if ln:
            names.add(ln.split(":", 1)[0].strip())
    return names


def used_markers(tests_dir: str) -> dict[str, tuple[str, int]]:
    """marker name -> (first file using it, line). Reads ``pytest.mark.X``
    attribute accesses — decorators and ``pytestmark`` assignments alike."""
    out: dict[str, tuple[str, int]] = {}
    for path in sorted(glob.glob(os.path.join(tests_dir, "**", "test_*.py"),
                                 recursive=True)):
        tree = astutil.parse_module(path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                dotted = astutil.dotted_name(node)
                if dotted and ".mark." in dotted:
                    mark = dotted.split(".mark.", 1)[1].split(".", 1)[0]
                    out.setdefault(mark, (path, node.lineno))
    return out


def check_markers(repo_root: str, tests_dir: str = "tests",
                  ini: str = "pytest.ini") -> list[Finding]:
    declared = declared_markers(os.path.join(repo_root, ini))
    used = used_markers(os.path.join(repo_root, tests_dir))
    findings = []
    for mark in sorted(set(used) - declared - _BUILTIN_MARKS):
        path, line = used[mark]
        findings.append(Finding(
            "marker-audit", os.path.relpath(path, repo_root), mark,
            f"marker '{mark}' is used but not declared in {ini} — "
            f"`-m {mark}` selects nothing and `--strict-markers` would fail", line))
    for mark in sorted(declared - set(used)):
        findings.append(Finding(
            "marker-audit", ini, mark,
            f"{ini} declares marker '{mark}' but no test uses it", 0))
    return findings


# ------------------------------------------------------------ port imports
#: top-level packages the port may not import
FORBIDDEN_ROOTS = frozenset({"jax", "jaxlib", "repro"})

#: (directory or file, glob) pairs of the port's files, repo-relative
PORT_FILES = (
    ("src/repro_torch", "**/*.py"),
    (".", "chip_smoke.py"),
    ("examples", "*_torch.py"),
    ("benchmarks", "torch_*.py"),
)


def port_files(repo_root: str) -> list[str]:
    """Repo-relative paths of every file the ``port-imports`` rule reads."""
    out = []
    for base, pattern in PORT_FILES:
        for path in sorted(glob.glob(os.path.join(repo_root, base, pattern), recursive=True)):
            out.append(os.path.relpath(path, repo_root))
    return out


def imported_modules(tree: ast.Module) -> list[tuple[str, int]]:
    """``(absolute module name, line)`` of every import anywhere in ``tree``
    (function bodies included): import statements, and
    ``importlib.import_module`` / ``__import__`` calls with a literal name.
    Relative imports stay inside their own package and are skipped."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name, node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level and node.module:
            out.append((node.module, node.lineno))
        elif isinstance(node, ast.Call):
            name = astutil.call_name(node)
            if (name in ("importlib.import_module", "import_module", "__import__")
                    and node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append((node.args[0].value, node.lineno))
    return out


def check_port_imports(repo_root: str, files: list[str] | None = None) -> list[Finding]:
    findings = []
    for rel in port_files(repo_root) if files is None else files:
        tree = astutil.parse_module(os.path.join(repo_root, rel))
        for mod, line in imported_modules(tree):
            if mod.split(".", 1)[0] in FORBIDDEN_ROOTS:
                findings.append(Finding(
                    "port-imports", rel, mod,
                    f"the port imports '{mod}' — the port runs without JAX and holds "
                    f"its own copy of whatever it needs from the reference", line))
    return findings


def check_repo_rules(repo_root: str) -> list[Finding]:
    return (check_bench_registration(repo_root) + check_markers(repo_root)
            + check_port_imports(repo_root))
