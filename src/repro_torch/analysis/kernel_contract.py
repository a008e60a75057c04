"""Kernel-contract lint: AST rules over ``src/repro_torch/kernels/`` (and,
for ``device-resolve``, the whole port).

Mirror of ``src/repro/analysis/kernel_contract.py``. Carried over:

``kernel-validate-low-bits``
    Every public function with a ``low_bits`` parameter must call
    ``validate_low_bits`` (or forward to one that does) — a bare
    ``assert`` disappears under ``python -O`` and an unchecked value
    silently takes the int8 branch (the C entries take any ``int``).

``kernel-pad2-boundary``
    Public functions in the unpadded-operand boundary module (``ops.py``)
    that call a kernel entry — any function that reaches ``common.call``,
    the port's counterpart of ``pl.pallas_call`` — must route operands
    through ``pad2``, or reach the kernels only through public boundary
    functions. The wrappers raise on shapes that do not tile; the
    boundary is where the 128-pad contract is honored.

``kernel-block-default-128``
    Default values of ``bm``/``bn``/``bk`` tile parameters must be
    multiples of 128 (the tile every CUDA kernel takes). Callers may pass
    smaller tiles explicitly to the plain versions (tests do); defaults
    must not drift.

``kernel-all-drift``
    Where ``__all__`` exists, it must list every public name the module
    defines, and every entry must resolve to a defined or imported name.
    In ``__init__.py`` every ``from X import ...`` binding must be listed
    too — the package namespace IS the public API surface.

The reference's ``kernel-indexmap-pure`` has no counterpart: a CUDA
kernel has no ``BlockSpec``, so there is no index map to keep pure — its
grid arithmetic lives in the ``.cu`` sources, and what crosses into it is
checked by ``kernel-c-abi``.

``kernel-resolve-interpret`` becomes:

``device-resolve``
    Every public function of the port outside ``nn/`` (methods of public
    classes included) with a ``device=None`` parameter must route it
    through ``kernels.common.resolve_device`` — directly, or by
    forwarding ``device=`` to a function that does (the same fixpoint as
    the reference's ``check_param_routing``). This makes the port's rule
    mechanical: an entry point runs on the card unless asked for the CPU,
    and raises without one. :data:`DEVICE_RESOLVE_ALLOWLIST` names the
    exceptions, each with its reason.

Rules of the port's own:

``kernel-legs``
    Every public wrapper that launches a kernel entry has three legs, in
    this order: (1) on a CPU tensor, the plain version from
    ``kernels/ref.py``; (2) on a fake or meta tensor (``common.is_fake``),
    ``common.record_work`` and an empty result of the output's shape and
    dtype, with no launch; (3) on the card, ``common.check_cuda_operand``
    on every tensor operand, then the launch. Without leg 2 the runner-key
    audit cannot trace a step; without leg 3's checks a launch reads a
    host, misaligned or strided pointer.

``kernel-c-abi``
    Every entry name passed to ``common.call`` / ``common.cuda_fn`` is an
    ``extern "C"`` entry of ``src/repro_torch/csrc/*.cu``, and every such
    entry is bound. The ``ctypes`` signature of each binding matches the C
    one slot for slot (``common.call`` appends the stream, so a wrapper's
    ``_ARGTYPES`` ends with it and the call passes one argument fewer); a
    binding through ``cuda_fn`` takes its ``int`` (cudaError_t) result, an
    attribute binding (``lib.<entry>.argtypes`` / ``.restype``) its own.
    A mismatched ``ctypes`` signature corrupts memory silently, and no
    test on the CPU can see it.

``check_kernels`` runs everything over the port and returns
:class:`~repro_torch.analysis.findings.Finding`s; per-rule entry points
take parsed modules so the self-tests can feed fixture snippets.
"""
from __future__ import annotations

import ast
import glob
import os
import re

from . import astutil
from .findings import Finding

#: modules that take UNPADDED operands and must route through pad2
PAD_BOUNDARY_MODULES = ("ops.py",)

KERNELS_PKG = "src/repro_torch/kernels"
PORT_PKG = "src/repro_torch"
CSRC_DIR = "src/repro_torch/csrc"

#: ``device-resolve`` exceptions: (module, function, reason). A public
#: function listed here may take ``device=None`` and give it another meaning.
DEVICE_RESOLVE_ALLOWLIST = (
    ("src/repro_torch/launch/op_analysis.py", "fake_like",
     "None means the fake device (op_analysis.fake_device: the card's type where "
     "one is visible, else meta) — the tensors it makes hold no data and never "
     "reach a card, so the card default and its raise would be wrong here"),
)


# --------------------------------------------------------------- module info
class ModuleInfo:
    """Per-module facts the package-level fixpoint rules consume."""

    def __init__(self, rel: str, tree: ast.Module):
        self.rel = rel
        self.tree = tree
        #: every def in the module, nested ones and methods included
        self.functions = {n.name: n for n in ast.walk(tree)
                          if isinstance(n, ast.FunctionDef)}
        self._top = astutil.all_functions(tree)

    def public(self) -> list[ast.FunctionDef]:
        """Top-level public defs — the module's API surface."""
        return [f for f in self._top if not f.name.startswith("_")]

    def public_methods(self) -> list[tuple[str, ast.FunctionDef]]:
        """``(Class.method, def)`` of the public methods (``__init__``
        included) of the module's public top-level classes."""
        out = []
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef) and (
                            item.name == "__init__" or not item.name.startswith("_")):
                        out.append((f"{node.name}.{item.name}", item))
        return out


def load_package(pkg_dir: str, repo_root: str, *, recursive: bool = False,
                 exclude: tuple[str, ...] = ()) -> list[ModuleInfo]:
    """The ``.py`` modules of ``pkg_dir`` (and its subpackages with
    ``recursive``, skipping the subdirectories named in ``exclude``)."""
    pattern = "**/*.py" if recursive else "*.py"
    mods = []
    for path in sorted(glob.glob(os.path.join(pkg_dir, pattern), recursive=recursive)):
        sub = os.path.relpath(path, pkg_dir).split(os.sep)
        if len(sub) > 1 and sub[0] in exclude:
            continue
        mods.append(ModuleInfo(os.path.relpath(path, repo_root), astutil.parse_module(path)))
    return mods


# ------------------------------------------------- resolver/validator routing
def _forwards_param(fn: ast.FunctionDef, param: str) -> list[str]:
    """Last-segment names of callees that receive ``param=<...param...>``."""
    out = []
    for call in astutil.calls_in(fn):
        for kw in call.keywords:
            if kw.arg == param and any(
                isinstance(n, ast.Name) and n.id == param for n in ast.walk(kw.value)
            ):
                name = astutil.call_name(call)
                if name:
                    out.append(name.rsplit(".", 1)[-1])
    return out


def _routing(targets: list[tuple], mods: list[ModuleInfo], param: str,
             resolver: str) -> set[str]:
    """Fixpoint: the names (a function's, a class's for its ``__init__``)
    of the targets that call ``resolver`` or forward ``param=`` to a
    satisfying function; any function anywhere that calls the resolver can
    absorb a forward."""
    satisfied = {f.name for m in mods for f in m.functions.values()
                 if resolver in astutil.called_names(f)}
    satisfied |= {ident.split(".")[0] for _, ident, f in targets
                  if ident.endswith(".__init__") and resolver in astutil.called_names(f)}
    changed = True
    while changed:
        changed = False
        for _, ident, f in targets:
            name = ident.split(".")[0] if ident.endswith(".__init__") else f.name
            if name in satisfied and f.name in satisfied:
                continue
            if resolver in astutil.called_names(f) or any(
                    callee in satisfied for callee in _forwards_param(f, param)):
                if name not in satisfied or f.name not in satisfied:
                    satisfied |= {name, f.name}
                    changed = True
    return satisfied


def check_param_routing(mods: list[ModuleInfo], param: str, resolver: str,
                        rule: str) -> list[Finding]:
    """A public fn with ``param`` satisfies the contract iff it calls
    ``resolver`` or forwards ``param=`` to a satisfying function."""
    targets = [(m, f.name, f) for m in mods for f in m.public()
               if param in astutil.function_param_names(f) and f.name != resolver]
    satisfied = _routing(targets, mods, param, resolver)
    return [
        Finding(rule, m.rel, ident,
                f"public kernel wrapper '{ident}' takes {param}= but never routes it "
                f"through {resolver}() (directly or via a delegate)", f.lineno)
        for m, ident, f in targets if f.name not in satisfied
    ]


def _defaults_none(fn: ast.FunctionDef, param: str) -> bool:
    a = fn.args
    pos = a.posonlyargs + a.args
    pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
    pairs += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
    return any(p.arg == param and isinstance(d, ast.Constant) and d.value is None
               for p, d in pairs)


def check_device_resolve(mods: list[ModuleInfo], *, allow=DEVICE_RESOLVE_ALLOWLIST
                         ) -> list[Finding]:
    """``device-resolve`` over ``mods`` (the port outside ``nn/``)."""
    allowed = {(rel, name) for rel, name, _ in allow}
    targets = []
    for m in mods:
        fns = [(f.name, f) for f in m.public()] + m.public_methods()
        targets += [(m, ident, f) for ident, f in fns
                    if _defaults_none(f, "device") and f.name != "resolve_device"]
    satisfied = _routing(targets, mods, "device", "resolve_device")
    findings = []
    for m, ident, f in targets:
        name = ident.split(".")[0] if ident.endswith(".__init__") else f.name
        if name in satisfied or (m.rel, ident) in allowed:
            continue
        findings.append(Finding(
            "device-resolve", m.rel, ident,
            f"'{ident}' takes device=None but never routes it through "
            f"resolve_device() (directly or by forwarding device=): None must mean "
            f"the card, and no card must raise", f.lineno))
    return findings


# ------------------------------------------------------- launches, entries
def entry_names(mods: list[ModuleInfo]) -> set[str]:
    """Functions that call ``common.call`` directly: the raw launches (the
    port's counterpart of a function that calls ``pl.pallas_call``)."""
    return {f.name for m in mods for f in m.functions.values()
            if "common.call" in astutil.called_names(f)}


def launch_reaching(mods: list[ModuleInfo]) -> set[str]:
    """Every function of ``mods`` that reaches ``common.call``, directly or
    through others that do (fixpoint over last-segment call names)."""
    reach = entry_names(mods)
    changed = True
    while changed:
        changed = False
        for m in mods:
            for f in m.functions.values():
                if f.name not in reach and astutil.called_names(f) & reach:
                    reach.add(f.name)
                    changed = True
    return reach


# ------------------------------------------------------------- pad2 boundary
def check_pad_boundary(mods: list[ModuleInfo]) -> list[Finding]:
    boundary = [m for m in mods if os.path.basename(m.rel) in PAD_BOUNDARY_MODULES]
    own = {f.name for m in boundary for f in m.functions.values()}
    kernels = launch_reaching(mods) - own
    findings = []
    for m in boundary:
        for f in m.public():
            called = astutil.called_names(f)
            direct = called & kernels
            if not direct or "pad2" in called:
                continue  # pads, or reaches kernels through padded boundary fns
            findings.append(Finding(
                "kernel-pad2-boundary", m.rel, f.name,
                f"'{f.name}' hands operands to a kernel ({sorted(direct)}) without "
                f"pad2() — the 128-pad contract lives at this boundary", f.lineno))
    return findings


# --------------------------------------------------------- block defaults
def check_block_defaults(mod: ModuleInfo) -> list[Finding]:
    findings = []
    for f in mod.functions.values():
        a = f.args
        pairs = list(zip(a.args[len(a.args) - len(a.defaults):], a.defaults))
        pairs += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
        for p, d in pairs:
            if p.arg in ("bm", "bn", "bk") and isinstance(d, ast.Constant) \
                    and isinstance(d.value, int) and d.value % 128 != 0:
                findings.append(Finding(
                    "kernel-block-default-128", mod.rel, f"{f.name}.{p.arg}",
                    f"'{f.name}' defaults {p.arg}={d.value}, not a multiple of 128 "
                    f"(the tile every CUDA kernel takes)", d.lineno))
    return findings


# ---------------------------------------------------------------- __all__
def check_all_drift(mod: ModuleInfo, *, is_init: bool | None = None) -> list[Finding]:
    names, line = astutil.module_all(mod.tree)
    if names is None:
        return []
    if is_init is None:
        is_init = os.path.basename(mod.rel) == "__init__.py"
    findings = []
    listed = set(names)
    defined = astutil.defined_public_names(mod.tree)
    imported = astutil.imported_names(mod.tree)
    for missing in sorted(defined - listed):
        findings.append(Finding(
            "kernel-all-drift", mod.rel, missing,
            f"public name '{missing}' is defined but missing from __all__", line))
    for ghost in sorted(listed - defined - imported):
        findings.append(Finding(
            "kernel-all-drift", mod.rel, ghost,
            f"__all__ lists '{ghost}', which the module neither defines nor imports",
            line))
    if is_init:
        reexports = {n for n in astutil.imported_from_names(mod.tree)
                     if not n.startswith("_")}
        for missing in sorted(reexports - listed):
            findings.append(Finding(
                "kernel-all-drift", mod.rel, missing,
                f"__init__ imports '{missing}' but __all__ does not re-export it",
                line))
    return findings


# ------------------------------------------------------------ the three legs
def _is_cpu_test(test: ast.expr) -> bool:
    """``<t>.device.type == "cpu"``."""
    for node in ast.walk(test):
        if isinstance(node, ast.Compare):
            sides = [node.left, *node.comparators]
            if any(isinstance(s, ast.Constant) and s.value == "cpu" for s in sides) and any(
                    isinstance(s, ast.Attribute) and s.attr == "type" for s in sides):
                return True
    return False


def _is_fake_test(test: ast.expr) -> bool:
    return "is_fake" in astutil.called_names(test)


def _ref_names(mod: ModuleInfo) -> set[str]:
    """Names the module imports from ``kernels/ref.py``."""
    out = set()
    for node in mod.tree.body:
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.rsplit(".", 1)[-1] == "ref":
            out.update(a.asname or a.name for a in node.names)
    return out


def _allocators(mod: ModuleInfo) -> set[str]:
    """``empty`` and the module's functions that (transitively) call it."""
    out = {"empty"}
    changed = True
    while changed:
        changed = False
        for f in mod.functions.values():
            if f.name not in out and astutil.called_names(f) & out:
                out.add(f.name)
                changed = True
    return out


def _lines_of(fn: ast.AST, names: set[str]) -> list[tuple[int, ast.Call]]:
    out = []
    for c in astutil.calls_in(fn):
        name = astutil.call_name(c)
        if name and (name in names or name.rsplit(".", 1)[-1] in names):
            out.append((c.lineno, c))
    return sorted(out, key=lambda p: p[0])


def _tensor_params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            if p.annotation is not None and "Tensor" in ast.unparse(p.annotation)]


def check_legs(mod: ModuleInfo, entries: set[str]) -> list[Finding]:
    """``kernel-legs`` for the module's public wrappers (public functions
    that call a raw launch in ``entries`` and are not one)."""
    findings = []
    refs = _ref_names(mod)
    allocs = _allocators(mod)
    launch_names = entries | {"common.call", "call"}
    for f in mod.public():
        called = astutil.called_names(f)
        if f.name in entries or not called & entries:
            continue

        def bad(part: str, msg: str, line: int = f.lineno):
            findings.append(Finding("kernel-legs", mod.rel, f"{f.name}:{part}",
                                    f"'{f.name}': {msg}", line))

        ifs = [s for s in f.body if isinstance(s, ast.If)]
        cpu = next((s for s in ifs if _is_cpu_test(s.test)), None)
        fake = next((s for s in ifs if _is_fake_test(s.test)), None)
        if cpu is None or not (astutil.called_names(cpu) & (refs | {"_ref"})) or not any(
                isinstance(n, ast.Return) for n in ast.walk(cpu)):
            bad("cpu", "no CPU leg returning the plain version from kernels/ref.py "
                       "(`if x.device.type == \"cpu\": return <ref>(...)`)")
            continue
        if fake is None:
            bad("fake", "no fake leg (`if common.is_fake(x): ...`): the runner-key audit "
                        "cannot trace it without launching")
            continue
        if fake.lineno < cpu.lineno:
            bad("order", "the fake leg comes before the CPU leg", fake.lineno)
        fake_calls = astutil.called_names(ast.Module(body=fake.body, type_ignores=[]))
        if fake_calls & launch_names:
            bad("fake", "the fake leg launches a kernel", fake.lineno)
        if not any(isinstance(n, ast.Return) for s in fake.body for n in ast.walk(s)) or \
                not fake_calls & allocs:
            bad("fake", "the fake leg does not return an empty result of the output's "
                        "shape (torch.empty, or a helper that calls it)", fake.lineno)
        records = [ln for ln, _ in _lines_of(f, {"record_work"})]
        if not any(ln < fake.lineno or fake.lineno <= ln <= fake.end_lineno for ln in records):
            bad("fake", "no common.record_work before or in the fake leg: the launch "
                        "goes unreported", fake.lineno)
        launches = [ln for ln, _ in _lines_of(f, launch_names) if ln > fake.end_lineno]
        if not launches:
            bad("card", "no launch after the fake leg")
            continue
        checks = {}
        for ln, c in _lines_of(f, {"check_cuda_operand"}):
            if len(c.args) >= 2:
                checks.setdefault(astutil.root_name(c.args[1]), ln)
        for p in _tensor_params(f):
            ln = checks.get(p)
            if ln is None:
                bad(f"card:{p}", f"tensor operand '{p}' reaches the launch without "
                                 f"common.check_cuda_operand")
            elif not fake.end_lineno < ln < launches[0]:
                bad(f"card:{p}", f"common.check_cuda_operand of '{p}' is not between the "
                                 f"fake leg and the launch", ln)
    return findings


# ---------------------------------------------------------------- the C ABI
_C_ENTRY = re.compile(r'extern\s+"C"\s+([^;{}()]*?)\b(\w+)\s*\(([^)]*)\)\s*\{')
_C_TYPES = {"void*": "c_void_p", "int64_t": "c_int64", "int32_t": "c_int32", "int": "c_int",
            "char*": "c_char_p", "float": "c_float", "double": "c_double",
            "size_t": "c_size_t", "uint64_t": "c_uint64", "uint32_t": "c_uint32"}


def _ctype(decl: str) -> str:
    t = re.sub(r"\bconst\b", "", decl).replace(" ", "").replace("\t", "")
    return _C_TYPES.get(t, t)


def c_entries(source: str) -> dict[str, tuple[str, list[str], int]]:
    """``{name: (ctypes result, [ctypes param], line)}`` of every
    ``extern "C"`` function defined in a CUDA source."""
    text = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group().count("\n"), source, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    out = {}
    for m in _C_ENTRY.finditer(text):
        params = []
        for p in m.group(3).split(","):
            p = p.strip()
            if p and p != "void":
                pm = re.match(r"(.*?)(\w+)\s*$", p, re.S)
                params.append(_ctype(pm.group(1) if pm and pm.group(1).strip() else p))
        out[m.group(2)] = (_ctype(m.group(1)), params, text.count("\n", 0, m.start()) + 1)
    return out


def _eval_types(node: ast.expr, env: dict) -> list[str] | None:
    """A ctypes list expression (``[ctypes.c_void_p] * 3 + [...]``, a module
    constant naming one) as ctypes names; None when it is not static."""
    if isinstance(node, (ast.List, ast.Tuple)):
        out = []
        for el in node.elts:
            name = astutil.dotted_name(el)
            if not name:
                return None
            out.append(name.rsplit(".", 1)[-1])
        return out
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _eval_types(node.left, env), _eval_types(node.right, env)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for lst, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                a = _eval_types(lst, env)
                return None if a is None else a * n.value
    return None


def _type_env(tree: ast.Module) -> dict[str, list[str]]:
    env: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            types = _eval_types(node.value, env)
            if types is not None:
                env[node.targets[0].id] = types
    return env


def bindings(mods: list[ModuleInfo]) -> list[dict]:
    """Every ``ctypes`` binding of a C entry in ``mods``: ``common.call``
    and ``cuda_fn`` calls with a literal entry name, and attribute
    bindings (``<lib>.<entry>.argtypes`` / ``.restype``)."""
    out = []
    fn_restype = None
    for m in mods:
        if "cuda_fn" in m.functions:
            for node in ast.walk(m.functions["cuda_fn"]):
                # ``fn.restype = ...``: the result every bound entry gets
                if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Attribute) \
                        and node.targets[0].attr == "restype" \
                        and isinstance(node.targets[0].value, ast.Name):
                    fn_restype = (astutil.dotted_name(node.value) or "").rsplit(".", 1)[-1]
    for m in mods:
        env = _type_env(m.tree)
        attr: dict = {}
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Call):
                name = astutil.call_name(node) or ""
                last = name.rsplit(".", 1)[-1]
                if last == "call" and len(node.args) >= 4:
                    ent, types = node.args[1], _eval_types(node.args[2], env)
                    n_args = (None if any(isinstance(a, ast.Starred) for a in node.args)
                              else len(node.args) - 4)
                elif last == "cuda_fn" and len(node.args) >= 2:
                    ent, types, n_args = node.args[0], _eval_types(node.args[1], env), None
                else:
                    continue
                if isinstance(ent, ast.Constant) and isinstance(ent.value, str):
                    out.append(dict(entry=ent.value, rel=m.rel, line=node.lineno, via=last,
                                    argtypes=types, restype=fn_restype, n_args=n_args))
            elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Attribute) \
                    and node.targets[0].attr in ("argtypes", "restype") \
                    and isinstance(node.targets[0].value, ast.Attribute):
                ent = node.targets[0].value.attr
                b = attr.setdefault(ent, dict(entry=ent, rel=m.rel, line=node.lineno,
                                              via="attribute", argtypes=None, restype=None,
                                              n_args=None))
                if node.targets[0].attr == "argtypes":
                    b["argtypes"] = _eval_types(node.value, env)
                else:
                    b["restype"] = (astutil.dotted_name(node.value) or "").rsplit(".", 1)[-1]
        out += attr.values()
    return out


def check_c_abi(mods: list[ModuleInfo], sources: dict[str, str]) -> list[Finding]:
    """``kernel-c-abi``: ``sources`` maps a repo-relative ``.cu`` path to its text."""
    entries = {}
    for rel, text in sources.items():
        for name, (ret, params, line) in c_entries(text).items():
            entries[name] = (ret, params, rel, line)
    findings = []
    bound = bindings(mods)
    for b in bound:
        name = b["entry"]

        def bad(msg: str, part: str = ""):
            findings.append(Finding("kernel-c-abi", b["rel"], name + part, msg, b["line"]))

        if name not in entries:
            bad(f"'{name}' is bound through {b['via']} but no csrc/*.cu defines an "
                f'extern "C" entry of that name')
            continue
        ret, params, rel, line = entries[name]
        if b["argtypes"] is None:
            bad(f"the argtypes of '{name}' are not a static ctypes list", ":argtypes")
        elif b["argtypes"] != params:
            bad(f"'{name}' is bound with {len(b['argtypes'])} argtypes {b['argtypes']}, but "
                f"{rel}:{line} takes {len(params)} parameters {params}"
                + (" (the last, the stream, appended by common.call)"
                   if b["via"] == "call" else ""), ":argtypes")
        if b["restype"] != ret:
            bad(f"'{name}' is bound with result {b['restype']}, but {rel}:{line} returns "
                f"{ret}", ":restype")
        if b["n_args"] is not None and b["n_args"] != len(params) - 1:
            bad(f"common.call passes {b['n_args']} arguments to '{name}', which takes "
                f"{len(params)} (the last, the stream, appended by common.call)", ":args")
    names = {b["entry"] for b in bound}
    for name, (_, _, rel, line) in sorted(entries.items()):
        if name not in names:
            findings.append(Finding(
                "kernel-c-abi", rel, name,
                f'extern "C" entry \'{name}\' is never bound through common.call, '
                f"cuda_fn or an attribute binding", line))
    return findings


def csrc_sources(repo_root: str, csrc: str = CSRC_DIR) -> dict[str, str]:
    out = {}
    for path in sorted(glob.glob(os.path.join(repo_root, csrc, "*.cu"))):
        with open(path) as f:
            out[os.path.relpath(path, repo_root)] = f.read()
    return out


# ----------------------------------------------------------- every rule
def check_kernels(repo_root: str, pkg: str = KERNELS_PKG, port: str = PORT_PKG,
                  csrc: str = CSRC_DIR) -> list[Finding]:
    mods = load_package(os.path.join(repo_root, pkg), repo_root)
    findings: list[Finding] = []
    findings += check_param_routing(mods, "low_bits", "validate_low_bits",
                                    "kernel-validate-low-bits")
    findings += check_pad_boundary(mods)
    entries = entry_names(mods)
    for m in mods:
        findings += check_block_defaults(m)
        findings += check_all_drift(m)
        findings += check_legs(m, entries)
    findings += check_c_abi(mods, csrc_sources(repo_root, csrc))
    port_mods = load_package(os.path.join(repo_root, port), repo_root, recursive=True,
                             exclude=("nn",))
    findings += check_device_resolve(port_mods)
    return findings
