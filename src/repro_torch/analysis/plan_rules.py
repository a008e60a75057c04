"""Plan-contract rules: the recovery knobs must stay out of runner identity.

Mirror of ``src/repro/analysis/plan_rules.py`` over the port's
``core/ditto/plan.py`` and ``serve/mesh.py``.

``plan-sig-purity``
    No name in ``ROBUSTNESS_FIELDS`` (retries, backoff, fallback chain,
    watchdog, re-anchor threshold) may be read inside
    ``DittoPlan.cache_sig`` or listed in ``SEGMENT_FIELDS``. These knobs
    select HOW a dispatch recovers, never what a step launches — leaking
    one into the sig would fork the runner cache (one CUDA graph a key)
    per recovery policy, and a segment-schedulable recovery field would
    let two segments of one schedule disagree on recovery policy
    mid-dispatch. The runner-key audit (``trace_audit.py``) proves the same
    property dynamically (equal-sig probes); this rule pins it at the
    definition site with a pure AST read.

    The mesh leg partitions the sharding knobs the same way, both ways:

    * every ``MESH_SIG_FIELDS`` name (``mesh_devices``/``mesh_axis`` —
      the row split a dispatch runs as) MUST reach ``cache_sig``
      (directly or through ``mesh_sig()``) — dropping one would let
      sharded and unsharded plans collide on a runner; and none may be
      segment-schedulable or fallback-overridable (a mid-loop or
      mid-recovery reshard would move the carried temporal state off its
      devices);
    * every ``MESH_POLICY_FIELDS`` name (``serve.mesh.ServeMesh``'s
      steal/queue knobs) must stay OUT of ``cache_sig`` and out of
      ``MESH_SIG_FIELDS``/``SEGMENT_FIELDS`` — routing policy shapes how
      work reaches a shard, never what a step launches.

    The port's leg of its own: ``serve.cache.RunnerKey`` reads the plan's
    fields back out of ``plan_sig`` by position, so each accessor must
    name the slot of the port's ``cache_sig()`` tuple it indexes. The
    port's tuple is not the reference's: it has no ``interpret`` slot, so
    its mesh slot is 4, not 5. The rule reads the slots from the tuple
    ``cache_sig`` returns (``self.X`` is slot ``X``, ``self.mesh_sig()``
    slot ``mesh``).
"""
from __future__ import annotations

import ast
import os

from . import astutil
from .findings import Finding

#: the definition site every finding anchors to
PLAN_REL = "src/repro_torch/core/ditto/plan.py"

#: where the scheduler-policy mesh knobs (MESH_POLICY_FIELDS) are defined
MESH_REL = "src/repro_torch/serve/mesh.py"

#: where ``RunnerKey`` reads the sig back by position
CACHE_REL = "src/repro_torch/serve/cache.py"


def _tuple_assign(tree: ast.Module, name: str) -> tuple[set[str], int]:
    """Module-level ``NAME = ("a", "b", ...)`` string entries (tuples built
    by concatenation contribute their literal parts)."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if name in targets:
                names = {c.value for c in ast.walk(node.value)
                         if isinstance(c, ast.Constant)
                         and isinstance(c.value, str)}
                return names, node.lineno
    return set(), 0


def _method(tree: ast.Module, cls: str, meth: str) -> ast.FunctionDef | None:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and item.name == meth:
                    return item
    return None


def _self_reads(fn: ast.FunctionDef) -> dict[str, int]:
    """``self.X`` attribute names read anywhere in the method body."""
    out: dict[str, int] = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            out.setdefault(node.attr, node.lineno)
    return out


def check_plan_rules(repo_root: str, plan_rel: str = PLAN_REL) -> list[Finding]:
    path = os.path.join(repo_root, plan_rel)
    tree = astutil.parse_module(path)
    findings: list[Finding] = []

    robustness, _ = _tuple_assign(tree, "ROBUSTNESS_FIELDS")
    if not robustness:
        return [Finding(
            "plan-sig-purity", plan_rel, "ROBUSTNESS_FIELDS",
            f"{plan_rel} has no module-level ROBUSTNESS_FIELDS tuple — the "
            f"recovery-knob contract has nothing to check against", 0)]

    segment, s_line = _tuple_assign(tree, "SEGMENT_FIELDS")
    for name in sorted(robustness & segment):
        findings.append(Finding(
            "plan-sig-purity", plan_rel, f"SEGMENT_FIELDS:{name}",
            f"recovery field '{name}' is listed in SEGMENT_FIELDS — a "
            f"schedule segment could override recovery policy mid-dispatch, "
            f"and every segment-schedulable field is a cache_sig() field",
            s_line))

    sig_fn = _method(tree, "DittoPlan", "cache_sig")
    if sig_fn is None:
        findings.append(Finding(
            "plan-sig-purity", plan_rel, "cache_sig",
            f"{plan_rel} defines no DittoPlan.cache_sig method", 0))
        return findings
    reads = _self_reads(sig_fn)
    for name in sorted(robustness & set(reads)):
        findings.append(Finding(
            "plan-sig-purity", plan_rel, f"cache_sig:{name}",
            f"DittoPlan.cache_sig reads self.{name} — recovery policy would "
            f"become runner identity, forking the runner cache per "
            f"retry/fallback/watchdog configuration with no launch "
            f"difference to justify it", reads[name]))
    findings += _check_mesh_partition(repo_root, plan_rel, tree, sig_fn,
                                      reads, segment, s_line)
    findings += _check_key_slots(repo_root, plan_rel, sig_fn)
    return findings


def _check_mesh_partition(repo_root: str, plan_rel: str, tree: ast.Module,
                          sig_fn: ast.FunctionDef, sig_reads: dict[str, int],
                          segment: set[str], s_line: int) -> list[Finding]:
    """The mesh leg of ``plan-sig-purity`` (see module docstring)."""
    findings: list[Finding] = []
    mesh_sig, m_line = _tuple_assign(tree, "MESH_SIG_FIELDS")
    if not mesh_sig:
        return [Finding(
            "plan-sig-purity", plan_rel, "MESH_SIG_FIELDS",
            f"{plan_rel} has no module-level MESH_SIG_FIELDS tuple — the "
            f"mesh-signature contract has nothing to check against", 0)]

    # cache_sig may read the fields through the mesh_sig() helper; follow
    # that one hop so the rule checks what the sig actually contains
    effective = dict(sig_reads)
    helper = _method(tree, "DittoPlan", "mesh_sig")
    if helper is not None and "mesh_sig" in sig_reads:
        for name, line in _self_reads(helper).items():
            effective.setdefault(name, line)
    for name in sorted(mesh_sig - set(effective)):
        findings.append(Finding(
            "plan-sig-purity", plan_rel, f"cache_sig:!{name}",
            f"mesh field '{name}' (MESH_SIG_FIELDS) never reaches "
            f"DittoPlan.cache_sig — a sharded and an unsharded plan "
            f"differing only there would collide on one runner and the "
            f"second would silently replay the first's graph", m_line))
    for name in sorted(mesh_sig & segment):
        findings.append(Finding(
            "plan-sig-purity", plan_rel, f"SEGMENT_FIELDS:{name}",
            f"mesh field '{name}' is listed in SEGMENT_FIELDS — a schedule "
            f"segment could reshard the denoise loop mid-sample, moving the "
            f"carried temporal state off its devices", s_line))
    fallback, f_line = _tuple_assign(tree, "FALLBACK_FIELDS")
    for name in sorted(mesh_sig & fallback):
        findings.append(Finding(
            "plan-sig-purity", plan_rel, f"FALLBACK_FIELDS:{name}",
            f"mesh field '{name}' is fallback-overridable — a degradation "
            f"rung could move a recovery dispatch onto a different mesh "
            f"layout mid-ladder; rungs must inherit the shard's mesh",
            f_line))

    mesh_path = os.path.join(repo_root, MESH_REL)
    if not os.path.exists(mesh_path):
        return findings  # serve layer absent (a fixture tree): the plan
        # side of the partition is already proven above
    policy, p_line = _tuple_assign(astutil.parse_module(mesh_path),
                                   "MESH_POLICY_FIELDS")
    if not policy:
        findings.append(Finding(
            "plan-sig-purity", MESH_REL, "MESH_POLICY_FIELDS",
            f"{MESH_REL} has no module-level MESH_POLICY_FIELDS tuple — "
            f"the steal/queue policy contract has nothing to check against",
            0))
    for name in sorted(policy & set(effective)):
        findings.append(Finding(
            "plan-sig-purity", plan_rel, f"cache_sig:{name}",
            f"DittoPlan.cache_sig reads self.{name} — ServeMesh queue/steal "
            f"policy would become runner identity, forking the runner cache "
            f"per routing configuration with no launch difference to "
            f"justify it", effective[name]))
    for name in sorted(policy & (mesh_sig | segment)):
        findings.append(Finding(
            "plan-sig-purity", MESH_REL, f"policy-vs-sig:{name}",
            f"'{name}' appears in MESH_POLICY_FIELDS and in "
            f"MESH_SIG_FIELDS/SEGMENT_FIELDS — one knob cannot be both "
            f"routing policy and runner identity; pick a side", p_line))
    return findings


def sig_slots(sig_fn: ast.FunctionDef) -> dict[str, int] | None:
    """Slot of each name in the tuple ``cache_sig`` returns: ``self.X`` is
    ``X``, ``self.mesh_sig()`` is ``mesh``; None when it returns no tuple."""
    for node in ast.walk(sig_fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Tuple):
            slots = {}
            for i, el in enumerate(node.value.elts):
                if isinstance(el, ast.Call):
                    el = el.func
                if (isinstance(el, ast.Attribute) and isinstance(el.value, ast.Name)
                        and el.value.id == "self"):
                    slots[el.attr.removesuffix("_sig")] = i
            return slots
    return None


def key_accessors(tree: ast.Module, cls: str = "RunnerKey") -> dict[str, tuple[int, int]]:
    """``{accessor: (slot, line)}`` for each method of ``cls`` that returns
    ``self.plan_sig[<int>]``."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for item in node.body:
                if not isinstance(item, ast.FunctionDef):
                    continue
                for ret in ast.walk(item):
                    if (isinstance(ret, ast.Return) and isinstance(ret.value, ast.Subscript)
                            and astutil.dotted_name(ret.value.value) == "self.plan_sig"
                            and isinstance(ret.value.slice, ast.Constant)
                            and isinstance(ret.value.slice.value, int)):
                        out[item.name] = (ret.value.slice.value, item.lineno)
    return out


def _check_key_slots(repo_root: str, plan_rel: str, sig_fn: ast.FunctionDef,
                     cache_rel: str = CACHE_REL) -> list[Finding]:
    """The port's leg of ``plan-sig-purity`` (see module docstring)."""
    cache_path = os.path.join(repo_root, cache_rel)
    if not os.path.exists(cache_path):
        return []  # serve layer absent (a fixture tree)
    slots = sig_slots(sig_fn)
    if slots is None:
        return [Finding("plan-sig-purity", plan_rel, "cache_sig:tuple",
                        "DittoPlan.cache_sig returns no literal tuple — RunnerKey's "
                        "positional accessors have nothing to check against", sig_fn.lineno)]
    findings = []
    accessors = key_accessors(astutil.parse_module(cache_path))
    for name, (slot, line) in sorted(accessors.items()):
        if slots.get(name) != slot:
            findings.append(Finding(
                "plan-sig-purity", cache_rel, f"RunnerKey.{name}",
                f"RunnerKey.{name} reads plan_sig[{slot}], but cache_sig() puts "
                f"'{name}' in slot {slots.get(name)} — the accessor reads another "
                f"field (the port's tuple has no interpret slot: {slots})", line))
    for name in sorted(set(slots) - set(accessors)):
        findings.append(Finding(
            "plan-sig-purity", cache_rel, f"RunnerKey.!{name}",
            f"cache_sig() slot {slots[name]} ('{name}') has no RunnerKey accessor", 0))
    return findings
