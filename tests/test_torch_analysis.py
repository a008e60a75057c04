"""The port's lint (``repro_torch.analysis``) on the CPU, against the
reference's (``repro.analysis``).

The counterparts of ``tests/test_dittolint.py`` (each AST rule on a good
and a bad fixture snippet, parsed and never imported; the finding and
baseline plumbing; the shipped tree clean; the CLI's exit codes) and of
``tests/test_trace_audit.py`` (both failure directions of the runner-key
audit caught on deliberately broken plans and schedules; the allowlist's
scope; tracing never launches a kernel), the port's own rules
(``port-imports``, ``device-resolve``, ``kernel-legs``, ``kernel-c-abi``,
the mesh entries of the allowlist, the ``block`` refusal on ``meta``), the
fake legs of the four wrappers that gained one, and the parity test: the
port's fingerprints partition the reference's plan matrix as the
reference's jaxprs do.

Without a card the fake tensors lie on ``meta``; the fake-CUDA leg runs in
``chip_smoke.py``'s ``analysis`` phase.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import trace_audit as rta  # noqa: E402
from repro_torch.analysis import (Finding, apply_baseline, check_kernels,  # noqa: E402
                                  check_plan_rules, check_repo_rules, check_trace_leaks,
                                  load_baseline, report_json, write_baseline)
from repro_torch.analysis import kernel_contract, plan_rules, repo_rules  # noqa: E402
from repro_torch.analysis import trace_audit as ta  # noqa: E402
from repro_torch.analysis import trace_leak  # noqa: E402
from repro_torch.core.ditto.plan import DittoPlan, PlanSchedule, check_device_block  # noqa: E402
from repro_torch.kernels import common, ref  # noqa: E402
from repro_torch.kernels import diff_encode as k_encode  # noqa: E402
from repro_torch.kernels import ditto_diff_matmul as k_diff  # noqa: E402
from repro_torch.kernels import fused_step as k_fused  # noqa: E402
from repro_torch.kernels import int8_matmul as k_int8  # noqa: E402
from repro_torch.kernels import quant_rows as k_quant  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.nn import dit as dit_mod  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dit_mod.DiTCfg(d_model=16, n_layers=1, n_heads=2, patch=2, in_channels=2,
                     input_size=4, n_classes=2)
MODES = ta.uniform_modes(CFG, "diff")
KERNELS = "src/repro_torch/kernels"


def mk(src: str, rel: str = f"{KERNELS}/fixture.py"):
    return kernel_contract.ModuleInfo(rel, ast.parse(textwrap.dedent(src)))


def rules_of(findings):
    return sorted({f.rule for f in findings})


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- finding format
def test_finding_key_and_render():
    f = Finding("kernel-all-drift", "src/x.py", "foo", "msg", 7)
    assert f.key == "kernel-all-drift::src/x.py::foo"
    assert f.render() == "src/x.py:7: [kernel-all-drift] msg"
    assert Finding("r", "p", "i", "m").render() == "p: [r] m"  # no line -> no :0
    data = json.loads(report_json([f]))
    assert data["version"] == 1 and data["findings"][0]["ident"] == "foo"


def test_baseline_round_trip(tmp_path):
    f1 = Finding("r1", "a.py", "x", "m1", 3)
    f2 = Finding("r2", "b.py", "y", "m2", 9)
    path = str(tmp_path / "baseline.json")
    write_baseline(path, [f1])
    keys = load_baseline(path)
    assert keys == [f1.key]
    active, suppressed, stale = apply_baseline([f1, f2], keys)
    assert active == [f2] and suppressed == [f1] and stale == []
    # a suppression whose finding disappeared is stale — baselines only shrink
    active, suppressed, stale = apply_baseline([f2], keys)
    assert active == [f2] and suppressed == [] and stale == [f1.key]
    assert load_baseline(str(tmp_path / "absent.json")) == []


def test_baseline_rejects_malformed(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text('["just", "a", "list"]')
    with pytest.raises(ValueError):
        load_baseline(str(path))


# ------------------------------------------------------- device-resolve
def test_device_resolve_rule():
    """The counterpart of the reference's ``kernel-resolve-interpret``: a
    public function (or a public class's method) taking ``device=None``
    must resolve it; the allow-list's entry is named by module and function."""
    bad = mk("""
        import torch
        def entry(x, *, device=None):
            return x.to(torch.device("cuda" if device is None else device))
        class Server:
            def __init__(self, *, device=None):
                self.device = device
    """, rel="src/repro_torch/serve/fixture.py")
    fs = kernel_contract.check_device_resolve([bad])
    assert rules_of(fs) == ["device-resolve"]
    assert sorted(f.ident for f in fs) == ["Server.__init__", "entry"]

    good = mk("""
        from ..kernels.common import resolve_device
        def entry(x, *, device=None):
            return x.to(resolve_device(device))
        class Server:
            def __init__(self, *, device=None):
                self.device = resolve_device(device)
        def other(x, device="cpu"):  # not a device=None default: out of scope
            return x
    """, rel="src/repro_torch/serve/fixture.py")
    assert kernel_contract.check_device_resolve([good]) == []
    fake = mk("""
        def fake_like(tree, device=None):
            return tree
    """, rel="src/repro_torch/launch/op_analysis.py")
    assert kernel_contract.check_device_resolve([fake]) == []  # allow-listed, with its reason
    assert [f.ident for f in kernel_contract.check_device_resolve([fake], allow=())] == \
        ["fake_like"]


def test_device_resolve_delegation_fixpoint():
    # forwarding device= to a resolving function or class satisfies the rule
    mods = [mk("""
        from ..kernels.common import resolve_device
        class Session:
            def __init__(self, *, device=None):
                self.device = resolve_device(device)
        def inner(x, *, device=None):
            return resolve_device(device)
        def outer(x, *, device=None):
            return inner(x, device=device)
        def serve(x, *, device=None):
            return Session(device=device)
        def broken(x, *, device=None):
            return inner(x, device="cpu")  # drops the caller's value
    """, rel="src/repro_torch/serve/fixture.py")]
    fs = kernel_contract.check_device_resolve(mods)
    assert [f.ident for f in fs] == ["broken"]


def test_validate_low_bits_rule():
    bad = mk("""
        def kernel(x, *, low_bits=8):
            assert low_bits in (4, 8)
            return x
    """)
    fs = kernel_contract.check_param_routing(
        [bad], "low_bits", "validate_low_bits", "kernel-validate-low-bits")
    assert [f.ident for f in fs] == ["kernel"]  # a bare assert is not validation
    good = mk("""
        from . import common
        def kernel(x, *, low_bits=8):
            common.validate_low_bits(low_bits)
            return x
        def outer(x, *, low_bits=8):
            return kernel(x, low_bits=low_bits)
    """)
    assert kernel_contract.check_param_routing(
        [good], "low_bits", "validate_low_bits", "kernel-validate-low-bits") == []


# ----------------------------------------------------------- pad2 boundary
_RAW = """
    import torch
    from . import common
    def launch(x):
        common.call("raw", "ditto_raw", _ARGTYPES, x.device, x.data_ptr())
    def raw_kernel(x, *, bm=128):
        return launch(x)
"""


def test_pad2_boundary_rule():
    """An entry reaches ``common.call``: a boundary function handing it
    operands must pad them, or reach it through one that does."""
    raw = mk(_RAW, rel=f"{KERNELS}/raw.py")
    bad = mk("""
        from .raw import raw_kernel
        def wrapper(x):
            return raw_kernel(x)
    """, rel=f"{KERNELS}/ops.py")
    fs = kernel_contract.check_pad_boundary([raw, bad])
    assert [f.ident for f in fs] == ["wrapper"]

    good = mk("""
        from .common import pad2
        from .raw import raw_kernel
        def wrapper(x):
            return raw_kernel(pad2(x, 128, 128))
        def delegate(x):
            return wrapper(x) * 2  # through a padded boundary function
    """, rel=f"{KERNELS}/ops.py")
    assert kernel_contract.check_pad_boundary([raw, good]) == []
    # non-boundary modules may call raw kernels unpadded (they raise on shape)
    elsewhere = mk("def probe(x):\n    return raw_kernel(x)\n", rel=f"{KERNELS}/dma_model.py")
    assert kernel_contract.check_pad_boundary([raw, elsewhere]) == []


def test_block_default_rule():
    bad = mk("""
        def kernel(x, *, bm=100, bn=128):
            return x
        def kern2(x, bk=64):
            return x
    """)
    fs = kernel_contract.check_block_defaults(bad)
    assert [f.ident for f in fs] == ["kernel.bm", "kern2.bk"]
    good = mk("def kernel(x, *, bm=128, bn=256, bk=128):\n    return x\n")
    assert kernel_contract.check_block_defaults(good) == []


# ------------------------------------------------------------- kernel-legs
# (the counterparts of the reference's four index-map tests: a CUDA kernel
# has no BlockSpec; what its wrapper must do in Python is the three legs)
def _wrapper(cpu="", fake="", checks=("x", "y"), launch_first=False):
    """A fixture wrapper module, its legs replaceable (each a block of
    source lines at the function body's indentation, 4 spaces)."""
    cpu = cpu or """
    if x.device.type == "cpu":
        return thing_ref(x, y)"""
    fake = fake or """
    common.record_work("thing", flops=0.0, nbytes=1.0, dtype=torch.int8)
    if common.is_fake(x):
        return _empty(x)"""
    checks = "".join(f"""
    common.check_cuda_operand("{p}", {p}, torch.int8)""" for p in checks)
    launch = """
    out = launch(x, y)"""
    body = (launch + checks) if launch_first else (checks + launch)
    head = textwrap.dedent("""
        import torch
        from . import common
        from .ref import thing_ref
        def launch(x, y):
            out = _empty(x)
            common.call("thing", "ditto_thing", _ARGTYPES, x.device, x.data_ptr(), y.data_ptr())
            return out
        def _empty(x):
            return torch.empty(x.shape, dtype=torch.int32, device=x.device)
        def thing(x: torch.Tensor, y: torch.Tensor | None, *, bm=128):""")
    return kernel_contract.ModuleInfo(f"{KERNELS}/fixture.py", ast.parse(
        head + cpu + fake + body + "\n    return out\n"))


def _legs(mod):
    return kernel_contract.check_legs(mod, kernel_contract.entry_names([mod]))


def test_kernel_legs_sound_wrapper_is_quiet():
    assert _legs(_wrapper()) == []


def test_kernel_legs_flags_a_missing_fake_leg():
    fs = _legs(_wrapper(fake=" "))
    assert [f.ident for f in fs] == ["thing:fake"] and "fake leg" in fs[0].message
    # a CPU leg that does not return the plain version
    fs = _legs(_wrapper(cpu="""
    if x.device.type == "cpu":
        return x"""))
    assert [f.ident for f in fs] == ["thing:cpu"]


def test_kernel_legs_flags_a_launching_or_unreported_fake_leg():
    fs = _legs(_wrapper(fake="""
    common.record_work("thing", flops=0.0, nbytes=1.0, dtype=torch.int8)
    if common.is_fake(x):
        return launch(x, y)"""))
    assert {f.ident for f in fs} == {"thing:fake"} and any("launches" in f.message for f in fs)
    fs = _legs(_wrapper(fake="""
    if common.is_fake(x):
        return _empty(x)"""))
    assert [f.ident for f in fs] == ["thing:fake"] and "record_work" in fs[0].message


def test_kernel_legs_flags_unchecked_operands():
    fs = _legs(_wrapper(checks=("x",)))
    assert [f.ident for f in fs] == ["thing:card:y"]
    fs = _legs(_wrapper(launch_first=True))
    assert sorted(f.ident for f in fs) == ["thing:card:x", "thing:card:y"]


# ---------------------------------------------------------------- __all__
def test_all_drift_rule():
    bad = mk("""
        __all__ = ["present", "ghost"]
        def present():
            pass
        def missing():
            pass
    """)
    fs = kernel_contract.check_all_drift(bad)
    assert {(f.ident, "missing from __all__" in f.message) for f in fs} == \
        {("missing", True), ("ghost", False)}
    init = mk("""
        from .ops import exported, hidden
        __all__ = ["exported"]
    """, rel=f"{KERNELS}/__init__.py")
    fs = kernel_contract.check_all_drift(init)
    assert [f.ident for f in fs] == ["hidden"]  # re-export not in __all__
    assert kernel_contract.check_all_drift(mk("x = 1\n")) == []  # no __all__: opt-in
    sound = mk("""
        from .common import pad2
        __all__ = ["present", "pad2", "LIMIT"]
        LIMIT = 7
        def present():
            pass
    """)
    assert kernel_contract.check_all_drift(sound) == []


# ------------------------------------------------------------ kernel-c-abi
_CU = """
// the C entry: four parameters, the stream last
extern "C" int ditto_thing(const void* x, void* out, int64_t n, void* stream) {
  return 0;
}
extern "C" const char* ditto_error_string(int code) { return ""; }
"""
_BIND = """
    import ctypes
    from . import common
    _ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p]
    def launch(x, out, n):
        common.call("thing", "ditto_thing", _ARGTYPES, x.device, x.data_ptr(),
                    out.data_ptr(), n)
    def cuda_fn(name, argtypes):
        lib.ditto_error_string.argtypes = [ctypes.c_int]
        lib.ditto_error_string.restype = ctypes.c_char_p
        fn.restype = ctypes.c_int
"""


def test_kernel_c_abi_rule():
    good = mk(_BIND)
    assert kernel_contract.check_c_abi([good], {"src/repro_torch/csrc/t.cu": _CU}) == []
    # the .cu entry grows a parameter the ctypes binding does not declare
    extra = _CU.replace("int64_t n, void* stream", "int64_t n, int splits, void* stream")
    fs = kernel_contract.check_c_abi([good], {"src/repro_torch/csrc/t.cu": extra})
    assert {f.ident for f in fs} == {"ditto_thing:argtypes", "ditto_thing:args"}
    assert all(f.rule == "kernel-c-abi" for f in fs)
    # an entry nobody binds, a binding of no entry, a wrong result type
    lone = _CU + 'extern "C" int ditto_lonely(int code) { return 0; }\n'
    ghost = mk(_BIND.replace('"ditto_thing"', '"ditto_ghost"').replace(
        "ctypes.c_char_p", "ctypes.c_int"))
    fs = kernel_contract.check_c_abi([ghost], {"src/repro_torch/csrc/t.cu": lone})
    assert {f.ident for f in fs} == {"ditto_ghost", "ditto_thing", "ditto_lonely",
                                     "ditto_error_string:restype"}


def test_shipped_c_abi_binds_every_entry():
    mods = kernel_contract.load_package(os.path.join(ROOT, KERNELS), ROOT)
    sources = kernel_contract.csrc_sources(ROOT)
    entries = {n for text in sources.values() for n in kernel_contract.c_entries(text)}
    assert entries == {"ditto_diff_encode", "ditto_diff_encode_fused", "ditto_diff_matmul",
                       "ditto_diff_gemm_splits", "ditto_fused_matmul", "ditto_int8_matmul",
                       "ditto_error_string", "ditto_quantize_rows", "ditto_dequantize_rows"}
    assert {b["entry"] for b in kernel_contract.bindings(mods)} == entries
    assert kernel_contract.check_c_abi(mods, sources) == []


# --------------------------------------------------------------- trace-leak
def test_trace_leak_flags_module_state():
    bad = ast.parse(textwrap.dedent("""
        TILE = 256
        CLUSTER = 4
        def linear_apply(p, x, *, plan):
            return ditto_linear_step(x, x, p, bm=TILE, low_bits=plan.low_bits)
        def encode(x):
            return launch(x, x, cluster=CLUSTER)
    """))
    fs = trace_leak.check_module(bad, "src/repro_torch/core/ditto/compiled.py",
                                 wrapper_names={"ditto_linear_step", "launch"})
    assert [f.ident for f in fs] == ["ditto_linear_step.bm", "launch.cluster"]
    assert all(f.rule == "trace-leak" for f in fs) and "'TILE'" in fs[0].message


def test_trace_leak_allows_plan_threading():
    good = ast.parse(textwrap.dedent("""
        from . import common
        DEFAULT = 128
        def helper(n):
            return n
        def linear_apply(p, x, *, plan):
            b = plan.block
            return ditto_linear_step(x, x, p, bm=b, low_bits=plan.low_bits,
                                     fused=plan.fused)
        def encode(x, tiles):
            # a call into the kernels' helpers is code that asks the card, not module data
            return launch(x, x, cluster=common.encode_cluster(tiles, common.sm_count(x.device)))
        def other(x):
            return unrelated_call(bm=DEFAULT)  # not a boundary call
    """))
    assert trace_leak.check_module(good, "x.py",
                                   wrapper_names={"ditto_linear_step", "launch"}) == []


def test_trace_leak_boundary_is_what_reaches_a_launch():
    names = trace_leak.ops_wrapper_names(ROOT)
    assert {"call", "launch", "launch_encode", "launch_matmul", "int8_matmul", "diff_encode",
            "ditto_diff_matmul", "diff_encode_fused", "ditto_fused_matmul",
            "ditto_linear_step", "attention_delta"} <= names
    assert "hold_maps" not in names and "pad2" not in names


# ---------------------------------------------------------- repo rules
def test_bench_registration_rule(tmp_path):
    bench = tmp_path / "benchmarks"
    bench.mkdir()
    (bench / "run.py").write_text("MODULES = ['bench_a', 'bench_ghost', 'fig1']\n")
    (bench / "bench_a.py").write_text("def run():\n    return []\n")
    (bench / "bench_orphan.py").write_text("def run():\n    return []\n")
    (bench / "torch_sweep.py").write_text("print(1)\n")  # the port's: not registered
    fs = repo_rules.check_bench_registration(str(tmp_path))
    assert {(f.rule, f.ident) for f in fs} == {
        ("bench-registration", "bench_orphan"),  # on disk, unregistered
        ("bench-registration", "bench_ghost"),   # registered, no file
    }


def test_marker_audit_rule(tmp_path):
    (tmp_path / "pytest.ini").write_text(
        "[pytest]\nmarkers =\n    slow: long tests\n    dead: never used\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_x.py").write_text(textwrap.dedent("""
        import pytest
        @pytest.mark.slow
        def test_a():
            pass
        @pytest.mark.gpu
        def test_b():
            pass
        @pytest.mark.skipif("not torch.cuda.is_available()", reason="card")  # builtin
        def test_c():
            pass
    """))
    fs = repo_rules.check_markers(str(tmp_path))
    assert {(f.rule, f.ident) for f in fs} == {
        ("marker-audit", "gpu"),   # used, undeclared
        ("marker-audit", "dead"),  # declared, unused
    }


def test_port_imports_rule(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "good.py").write_text(textwrap.dedent("""
        import torch
        from repro_torch.kernels import common
        from . import sibling
        from .repro import helper  # relative: inside the port
    """))
    (pkg / "bad.py").write_text(textwrap.dedent("""
        import numpy as np
        def lazy():
            import jax.numpy as jnp  # inside a function still counts
            from repro.kernels import ops
            return jnp, ops
    """))
    (tmp_path / "chip_smoke.py").write_text(
        "import importlib\nj = importlib.import_module('jaxlib')\n")
    (tmp_path / "examples").mkdir()
    (tmp_path / "examples" / "serve_torch.py").write_text("import repro\n")
    (tmp_path / "examples" / "serve.py").write_text("import jax\n")  # the reference's
    (tmp_path / "benchmarks").mkdir()
    (tmp_path / "benchmarks" / "torch_sweep.py").write_text("import torch\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_x.py").write_text("import jax\nimport repro\n")  # exempt
    fs = repo_rules.check_port_imports(str(tmp_path))
    assert {(f.path, f.ident) for f in fs} == {
        ("src/repro_torch/bad.py", "jax.numpy"), ("src/repro_torch/bad.py", "repro.kernels"),
        ("chip_smoke.py", "jaxlib"), ("examples/serve_torch.py", "repro")}
    assert all(f.rule == "port-imports" for f in fs)


# ------------------------------------------------------------ plan rules
_PLAN = """
    SEGMENT_FIELDS = ("block", "collect_stats", "low_bits", "fused")
    MESH_SIG_FIELDS = ("mesh_devices", "mesh_axis")
    FALLBACK_FIELDS = SEGMENT_FIELDS + ("compiled",)
    ROBUSTNESS_FIELDS = ("max_retries", "watchdog")
    class DittoPlan:
        def cache_sig(self):
            return (self.block, self.collect_stats, self.low_bits, self.fused, self.mesh_sig())
        def mesh_sig(self):
            return (self.mesh_devices, self.mesh_axis)
"""
_KEY = """
    class RunnerKey:
        @property
        def block(self):
            return self.plan_sig[0]
        @property
        def collect_stats(self):
            return self.plan_sig[1]
        @property
        def low_bits(self):
            return self.plan_sig[2]
        @property
        def fused(self):
            return self.plan_sig[3]
        @property
        def mesh(self):
            return self.plan_sig[4]
"""


def _plan_tree(tmp_path, plan=_PLAN, key=_KEY):
    for rel, src in ((plan_rules.PLAN_REL, plan), (plan_rules.CACHE_REL, key),
                     (plan_rules.MESH_REL, 'MESH_POLICY_FIELDS = ("steal", "steal_min_rows")\n')):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return plan_rules.check_plan_rules(str(tmp_path))


def test_plan_sig_purity_rule(tmp_path):
    assert _plan_tree(tmp_path) == []
    # a recovery knob read by the sig; RunnerKey reading the reference's
    # mesh slot (5, behind an interpret slot the port has not)
    leaky = _PLAN.replace("self.fused, self.mesh_sig())", "self.fused, self.mesh_sig(), "
                          "self.watchdog)")
    fs = _plan_tree(tmp_path, leaky, _KEY.replace("plan_sig[4]", "plan_sig[5]"))
    assert {f.ident for f in fs} == {"cache_sig:watchdog", "RunnerKey.mesh", "RunnerKey.!watchdog"}
    assert all(f.rule == "plan-sig-purity" for f in fs)


def test_plan_rules_read_the_ports_tuple():
    slots = plan_rules.sig_slots(next(
        m for n in ast.walk(ast.parse(open(os.path.join(ROOT, plan_rules.PLAN_REL)).read()))
        if isinstance(n, ast.ClassDef) and n.name == "DittoPlan"
        for m in n.body if isinstance(m, ast.FunctionDef) and m.name == "cache_sig"))
    assert slots == {"block": 0, "collect_stats": 1, "low_bits": 2, "fused": 3, "mesh": 4}
    assert check_plan_rules(ROOT) == []


# --------------------------------------------------- the shipped tree itself
def test_shipped_tree_is_clean():
    """Zero AST-pass findings on the port's tree."""
    assert check_kernels(ROOT) == []
    assert check_trace_leaks(ROOT) == []
    assert check_repo_rules(ROOT) == []
    assert check_plan_rules(ROOT) == []


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args], cwd=ROOT,
                          capture_output=True, text=True, env=env)


def test_cli_ast_only_exits_zero(tmp_path):
    report = tmp_path / "report.json"
    proc = _cli("--ast-only", "--json", str(report))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro_torch.analysis: clean" in proc.stdout
    assert json.loads(report.read_text()) == {"version": 1, "findings": [], "suppressed": []}
    shipped = os.path.join(ROOT, "src", "repro_torch", "analysis", "baseline.json")
    assert load_baseline(shipped) == []  # fix-don't-suppress: ships empty


def test_cli_fails_on_stale_suppression(tmp_path):
    stale = tmp_path / "baseline.json"
    stale.write_text(json.dumps(
        {"version": 1, "suppressions": ["kernel-all-drift::gone.py::x"]}))
    proc = _cli("--ast-only", "--baseline", str(stale))
    assert proc.returncode == 1 and "stale baseline suppression" in proc.stdout
    bad = tmp_path / "bad.json"
    bad.write_text("[]")
    assert _cli("--ast-only", "--baseline", str(bad)).returncode == 2


# ================================================================ the audit
@pytest.fixture(scope="module")
def state():
    return ta.abstract_state(CFG, 2)


def fp(plan, state):
    return ta.trace_fingerprint(CFG, MODES, plan, 2, state=state)


def test_fingerprint_deterministic_and_knob_sensitive(state):
    base = DittoPlan(collect_stats=False)
    f1 = fp(base, state)
    assert f1 == fp(DittoPlan(collect_stats=False), state)  # fresh trace, same hash
    assert f1 != fp(base.replace(low_bits=4), state)  # launch knob -> new step
    assert f1 == fp(base.replace(steps=40), state)  # loop knob -> same step
    assert op_analysis.fake_device() == "meta" and not any(
        isinstance(t, torch.Tensor) and not common.is_fake(t) for v in state.values()
        for t in v.values())


def test_tracing_never_launches(state, monkeypatch):
    """Every flow's step runs on ``meta``: no wrapper's launch counter
    moves and the kernel library is never built; each kernel's launch is
    recorded with its static arguments instead."""
    def no_build(*a, **k):
        raise AssertionError("tracing reached build_library")

    monkeypatch.setattr(common, "build_library", no_build)
    counters = [(k_int8, "launches"), (k_encode, "launches"), (k_diff, "launches"),
                (k_diff, "launches_int4"), (k_fused, "encode_launches"),
                (k_fused, "matmul_launches"), (k_quant, "quantize_launches"),
                (k_quant, "dequantize_launches")]
    before = [getattr(m, c) for m, c in counters]
    seen = {}
    for plan in (DittoPlan(collect_stats=True), DittoPlan(low_bits=4), DittoPlan(fused=True)):
        for modes in (MODES, ta.uniform_modes(CFG, "act")):
            args = ta.abstract_inputs(CFG, 2)
            rec = ta.record_step(CFG, modes, plan, args[:2] + (state,) + args[2:])
            for k, n in rec.launch_counts().items():
                seen[k] = seen.get(k, 0) + n
    assert [getattr(m, c) for m, c in counters] == before
    assert set(seen) == {"int8_matmul", "diff_encode", "ditto_diff_matmul",
                         "ditto_diff_matmul[low_bits=4]", "diff_encode_fused",
                         "ditto_fused_matmul", "quantize_rows", "dequantize_rows"}


def test_block_other_than_128_is_refused_on_meta(state):
    """The card's kernels tile by 128; on ``meta`` the wrappers take their
    card legs, so a plan with another block is refused there too, before
    any step (the CPU leg of the audit runs it)."""
    with pytest.raises(ValueError, match="tile by 128"):
        check_device_block(DittoPlan(block=256), torch.device("meta"))
    with pytest.raises(ValueError, match="tile by 128"):
        fp(DittoPlan(collect_stats=False, block=256), state)
    check_device_block(DittoPlan(block=256), torch.device("cpu"))


# ------------------------------------------------- synthetic case algebra
def _case(label, sig, fingerprint, plan=None, batch=None):
    return ta.TraceCase(label, sig, fingerprint, plan, batch)


def test_audit_cases_directions():
    stale = ta.audit_cases([_case("a", (1,), "x"), _case("b", (1,), "y")], group="g")
    assert [f.rule for f in stale] == ["trace-stale"]
    dup = ta.audit_cases([_case("a", (1,), "x"), _case("b", (2,), "x")], group="g")
    assert [f.rule for f in dup] == ["trace-dup"]
    assert ta.audit_cases([_case("a", (1,), "x"), _case("b", (2,), "x")],
                          group="g", check_dup=False) == []
    clean = ta.audit_cases([_case("a", (1,), "x"), _case("b", (2,), "y"),
                            _case("c", (1,), "x")], group="g")
    assert clean == []


def test_shared_trace_allowlist_scopes_the_fused_exception():
    pa = DittoPlan(collect_stats=False, fused=True)
    pb = pa.replace(low_bits=4)
    allowed = ta.audit_cases(
        [_case("fused", pa.cache_sig(), "same", pa),
         _case("fused-lb4", pb.cache_sig(), "same", pb)], group="g")
    assert allowed == []  # shared-trace pair
    # the same field pair WITHOUT fused is not covered by the allowlist
    qa = DittoPlan(collect_stats=False)
    qb = qa.replace(low_bits=4)
    assert [f.rule for f in ta.audit_cases(
        [_case("base", qa.cache_sig(), "same", qa),
         _case("lb4", qb.cache_sig(), "same", qb)], group="g")] == ["trace-dup"]


def test_shared_trace_allowlist_scopes_the_mesh_entries():
    """``mesh-axis-name``: one width, another axis name. ``mesh-unsplit``:
    a width that does not divide the bucket runs the unsharded step. Both
    scoped: another width, or a bucket the width divides, is a dup."""
    base = DittoPlan(collect_stats=False)
    dp2, axis_x, dp4 = (base.replace(mesh_devices=2), base.replace(mesh_devices=2, mesh_axis="x"),
                        base.replace(mesh_devices=4))

    def dups(pa, pb, batch):
        return [f.rule for f in ta.audit_cases(
            [_case("a", pa.cache_sig(), "same", pa, batch),
             _case("b", pb.cache_sig(), "same", pb, batch)], group="g")]

    assert dups(dp2, axis_x, 2) == []
    assert dups(base, dp4, 2) == []  # 4 does not divide 2: unsplit
    assert dups(base, dp4, 4) == ["trace-dup"]  # 4 divides 4: a split that equals base's step
    assert dups(dp2, dp4, 4) == ["trace-dup"]
    assert dups(base.replace(low_bits=4), dp4, 2) == ["trace-dup"]  # differs beyond the mesh


def test_mesh_dispatch_fingerprint_groups_rows(state):
    """A mesh plan's fingerprint is its dispatch: bucket 2 over two devices
    is two 1-row groups, each its own step; over four it runs unsplit."""
    calls = []

    def step_fp(rows, lo, hi):
        calls.append((rows, lo, hi))
        return f"step{rows}"

    base = DittoPlan(collect_stats=False)
    assert ta.dispatch_fingerprint(base.replace(mesh_devices=4), 2, step_fp) == "step2"
    split = ta.dispatch_fingerprint(base.replace(mesh_devices=2), 2, step_fp)
    assert split not in ("step1", "step2") and calls == [(2, 0, 2), (1, 0, 1), (1, 1, 2)]
    assert split == ta.dispatch_fingerprint(base.replace(mesh_devices=2, mesh_axis="x"), 2,
                                            step_fp)


# ------------------------------------------------ injected failure: stale
@dataclasses.dataclass(frozen=True)
class LeakyPlan(DittoPlan):
    """low_bits omitted from the sig — the stale-graph bug, on purpose."""

    def cache_sig(self):
        return (self.block, self.collect_stats, self.fused, self.mesh_sig())


def test_leaky_plan_flagged_as_stale_trace(state):
    p8 = LeakyPlan(collect_stats=False)
    p4 = LeakyPlan(collect_stats=False, low_bits=4)
    assert p8.cache_sig() == p4.cache_sig()  # the collision the leak creates
    found = ta.audit_cases(
        [_case("lb8", p8.cache_sig(), fp(p8, state), p8),
         _case("lb4", p4.cache_sig(), fp(p4, state), p4)], group="leaky")
    assert [f.rule for f in found] == ["trace-stale"]
    assert "missing from cache_sig()" in found[0].message


# -------------------------------------------- injected failure: duplication
@dataclasses.dataclass(frozen=True)
class RedundantPlan(DittoPlan):
    """max_batch added to the sig — the duplicate-graph bug, on purpose."""

    def cache_sig(self):
        return DittoPlan.cache_sig(self) + (self.max_batch,)


def test_redundant_sig_field_flagged_as_duplication(state):
    r1 = RedundantPlan(collect_stats=False)
    r2 = RedundantPlan(collect_stats=False, max_batch=8)
    assert r1.cache_sig() != r2.cache_sig()  # distinct keys ...
    found = ta.audit_cases(
        [_case("mb64", r1.cache_sig(), fp(r1, state), r1),
         _case("mb8", r2.cache_sig(), fp(r2, state), r2)], group="dup")
    assert [f.rule for f in found] == ["trace-dup"]  # ... same step


# ---------------------------------------------- injected schedule failures
def test_leaky_schedule_flagged_as_stale_trace(state):
    """Over a leaky base, the int8 and int4 segments of a schedule collide
    on one key, so the late segment would replay the early one's graph."""
    sched = PlanSchedule(LeakyPlan(collect_stats=False, steps=12),
                         [(0, 6, {}), (6, 12, {"low_bits": 4})])
    cases = ta.expand_schedule("leaky", sched)
    assert len(cases) == 2  # unequal plans: normalization must NOT merge
    assert cases[0][1].cache_sig() == cases[1][1].cache_sig()
    found = ta.audit_cases(
        [_case(label, p.cache_sig(), fp(p, state), p) for label, p in cases],
        group="leaky-sched")
    assert [f.rule for f in found] == ["trace-stale"]
    assert "missing from cache_sig()" in found[0].message


@dataclasses.dataclass(frozen=True)
class _StepTagged(DittoPlan):
    """A plan whose sig leaks its segment's start step."""

    step_tag: int = 0

    def cache_sig(self):
        return DittoPlan.cache_sig(self) + (self.step_tag,)


class RedundantSchedule(PlanSchedule):
    """Per-segment sig split — the schedule-level duplicate-graph bug."""

    def segment_plans(self):
        return tuple((start, stop, _StepTagged(**dataclasses.asdict(p), step_tag=start))
                     for start, stop, p in PlanSchedule.segment_plans(self))


def test_redundant_schedule_flagged_as_duplication(state):
    sched = RedundantSchedule(DittoPlan(collect_stats=False, steps=12),
                              [(0, 6, {}), (6, 12, {})])
    cases = ta.expand_schedule("dup", sched)
    assert len(cases) == 2  # tag-split plans survive normalization ...
    sigs = [p.cache_sig() for _, p in cases]
    assert sigs[0] != sigs[1]  # ... with distinct keys
    found = ta.audit_cases(
        [_case(label, sig, fp(p, state), p) for (label, p), sig in zip(cases, sigs)],
        group="dup-sched")
    assert [f.rule for f in found] == ["trace-dup"]
    assert [label for label, _ in cases] == ["dup[0:6)", "dup[6:12)"]


def test_constant_schedule_expands_to_the_bare_plans_case():
    base = DittoPlan(collect_stats=False, steps=12)
    cases = ta.expand_schedule("const", PlanSchedule(base, [(0, 5, {}), (5, 12, {})]))
    assert [(label, p.cache_sig()) for label, p in cases] == \
        [("const[0:12)", base.normalized().cache_sig())]


# ------------------------------------------------------- recovery coverage
def test_recovery_rules_fire_on_unaudited_sigs():
    audited = {p.cache_sig() for _, p in ta.default_plan_matrix()}
    assert ta.audit_recovery_sigs(ta.default_recovery_matrix(), audited) == []
    ladder = DittoPlan(collect_stats=False, low_bits=4, fused=True, watchdog=True,
                       fallbacks=(dict(fused=False),))
    lean = {DittoPlan(collect_stats=False, low_bits=4, fused=True).cache_sig()}
    fs = ta.audit_recovery_sigs([("ladder", ladder)], lean)
    assert sorted(f.rule for f in fs) == ["fallback-unaudited", "reanchor-unaudited"]


# --------------------------------------------------------- the shipped tree
def test_shipped_tree_audit_is_clean():
    """The acceptance invariant: the port's DittoPlan passes both
    directions over the whole matrix on ``meta`` and on the CPU leg."""
    assert ta.run_trace_audit() == []


def test_an_unrefused_block_is_a_finding(monkeypatch):
    """Were ``check_device_block`` to let ``block=256`` through on ``meta``,
    the audit says so (and does not trace it: its step would fail inside a
    wrapper instead of before any step)."""
    monkeypatch.setattr(ta, "check_device_block", lambda plan, device: None)
    fs = ta.run_trace_audit()
    assert [(f.rule, f.ident) for f in fs] == [("block-unrefused", "tiny/diff/b2:block-256")]


# ------------------------------------------------ parity with the reference
_EXPECTED_DIFF = {
    frozenset({"base", "steps-40", "sampler-plms", "policy-diff", "max-batch-8",
               "deadline-250", "eager", "watchdog", "retry-ladder"}),
    frozenset({"stats", "watchdog-reanchor"}), frozenset({"low-bits-4"}),
    frozenset({"fused", "fused-low-bits-4"}), frozenset({"block-256"})}


def _partition(fps: dict) -> set:
    classes: dict = {}
    for label, f in fps.items():
        classes.setdefault(f, set()).add(label)
    return {frozenset(c) for c in classes.values()}


@pytest.mark.parametrize("mode", ["diff", "act"])
def test_fingerprint_partition_matches_the_reference(mode, state):
    """The non-mesh plans of the matrix fall into the same equal-fingerprint
    classes under the port's record as under the reference's jaxprs: on
    ``meta`` for every plan the card takes, and on the CPU leg for all of
    them (``block-256`` too)."""
    rcfg = dict(rta._tiny_cfgs())["tiny"]
    rplans = {label: p for label, p in rta.default_plan_matrix()
              if "mesh" not in label and label != "interpret-explicit"}
    rstate = rta.abstract_state(rcfg, 2)
    ref = {label: rta.trace_fingerprint(rcfg, rta.uniform_modes(rcfg, mode), p, 2, state=rstate)
           for label, p in rplans.items()}
    plans = {label: p for label, p in ta.default_plan_matrix() if "mesh" not in label}
    assert set(plans) == set(rplans)
    modes = ta.uniform_modes(CFG, mode)
    fake = {label: ta.trace_fingerprint(CFG, modes, p, 2, state=state)
            for label, p in plans.items() if label != "block-256"}
    args = ta.cpu_inputs(CFG, 2)
    cpu = {label: ta.cpu_fingerprint(CFG, modes, p, args) for label, p in plans.items()}
    want = _partition(ref)
    if mode == "diff":
        assert want == _EXPECTED_DIFF
    assert _partition(cpu) == want
    assert _partition(fake) == _partition({k: v for k, v in ref.items() if k != "block-256"})


# ------------------------------------------------- the wrappers' fake legs
def _delta(g, shape):
    x_t = torch.randint(-100, 100, shape, generator=g, dtype=torch.int8)
    return x_t, torch.randint(-100, 100, shape, generator=g, dtype=torch.int8)


def _meta(*ts):
    return [None if t is None else torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in ts]


def _shapes(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("lead", [(), (3,)], ids=["2d", "batched"])
@pytest.mark.parametrize("case", ["diff_encode", "ditto_diff_matmul", "ditto_diff_matmul-lb4",
                                  "ditto_diff_matmul-yprev", "diff_encode_fused",
                                  "ditto_fused_matmul", "ditto_fused_matmul-yprev",
                                  "int8_matmul"])
def test_fake_leg_shapes_and_launch_record(case, lead):
    """On ``meta`` each wrapper returns empty outputs of its plain
    version's shapes and dtypes (on the same operands on the CPU), records
    one launch with its static arguments and launches nothing."""
    g = torch.Generator().manual_seed(0)
    m, k, n = 256, 384, 128
    x_t, x_prev = _delta(g, lead + (m, k))
    w = torch.randint(-127, 128, lead + (n, k), generator=g, dtype=torch.int8)
    y_prev = torch.randint(-1000, 1000, lead + (m, n), generator=g, dtype=torch.int32) \
        if case.endswith("yprev") else None
    name = case.split("-")[0]
    low_bits = 4 if case.endswith("lb4") else 8
    if name == "diff_encode":
        fn, args, kw = k_encode.diff_encode, (x_t, x_prev), {}
        static = dict(operands=common.operands(x_t, x_prev))
    elif name == "ditto_diff_matmul":
        cls = ref.diff_encode_ref(x_t, x_prev, (128, 128))
        fn, args = k_diff.ditto_diff_matmul, (x_t, x_prev, w, y_prev, cls)
        kw = dict(low_bits=low_bits, w_transposed=True)
        static = dict(operands=common.operands(x_t, x_prev, w, y_prev, cls), low_bits=low_bits,
                      w_transposed=True, y_prev=y_prev is not None)
    elif name == "diff_encode_fused":
        fn, args, kw = k_fused.diff_encode_fused, (x_t, x_prev), {}
        static = dict(operands=common.operands(x_t, x_prev))
    elif name == "ditto_fused_matmul":
        cls, dc, dh = ref.diff_encode_fused_ref(x_t, x_prev, (128, 128))
        fn, args = k_fused.ditto_fused_matmul, (w, dc, dh, cls, y_prev)
        kw = dict(w_transposed=True)
        static = dict(operands=common.operands(w, dc, dh, cls, y_prev), w_transposed=True,
                      y_prev=y_prev is not None)
    else:
        fn, args, kw = k_int8.int8_matmul, (x_t, w), dict(w_transposed=True)
        static = dict(operands=common.operands(x_t, w), w_transposed=True)
    want = _shapes(fn(*args, **kw))  # the plain version, on the CPU
    seen, work = [], []
    with common.recording(lambda nm, **w_: work.append(nm),
                          launches=lambda nm, st: seen.append((nm, st))):
        got = fn(*_meta(*args), **kw)
    assert _shapes(got) == want
    assert all(common.is_fake(t) for t in (got if isinstance(got, tuple) else (got,)))
    assert seen == [(name, static)] and work == [name]
