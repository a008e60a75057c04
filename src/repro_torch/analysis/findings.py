"""The one finding/report format the port's lint speaks.

Mirror of ``src/repro/analysis/findings.py``, carried over whole, so the
reference's lint and the port's read alike. A :class:`Finding` is a
single rule violation: ``rule`` (kebab-case rule id), ``path``
(repo-relative file), ``ident`` (a stable, line-number-free key for the
suppression baseline — function name, field set, marker name),
``message`` (human sentence) and an optional ``line``.
``python -m repro_torch.analysis`` emits these:

  * text rendering: ``path:line: [rule] message`` (clickable, grep-able);
  * machine-readable report: ``report_json`` — ``{"version": 1,
    "findings": [...]}`` for CI artifacts and downstream tooling;
  * suppression baseline: a checked-in JSON list of ``Finding.key``
    strings (``rule::path::ident`` — deliberately no line numbers, so
    unrelated edits never churn the baseline). ``apply_baseline`` splits
    findings into (active, suppressed) and reports stale suppressions —
    entries whose finding no longer exists — so the baseline can only
    shrink, never silently rot.

The baseline ships empty: the policy is fix-don't-suppress, and the file
exists so a genuinely unfixable finding has an explicit, reviewed place
to live rather than an ad-hoc disable.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # kebab-case rule id, e.g. "device-resolve"
    path: str  # repo-relative path the finding is anchored to
    ident: str  # stable suppression key component (NO line numbers)
    message: str
    line: int = 0

    @property
    def key(self) -> str:
        """Baseline suppression key — stable across unrelated edits."""
        return f"{self.rule}::{self.path}::{self.ident}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


def report_json(findings: list[Finding], *, suppressed: list[Finding] = ()) -> str:
    """Machine-readable report of a lint run (the CI artifact format)."""
    return json.dumps(
        {
            "version": 1,
            "findings": [dataclasses.asdict(f) for f in findings],
            "suppressed": [f.key for f in suppressed],
        },
        indent=2,
        sort_keys=True,
    ) + "\n"


# ------------------------------------------------------------------ baseline
def load_baseline(path: str) -> list[str]:
    """Suppression keys from a baseline file; [] when the file is absent."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return []
    if not isinstance(data, dict) or "suppressions" not in data:
        raise ValueError(f"{path}: baseline must be {{'version': 1, 'suppressions': [...]}}")
    return list(data["suppressions"])


def write_baseline(path: str, findings: list[Finding]) -> None:
    with open(path, "w") as f:
        json.dump({"version": 1, "suppressions": sorted(f_.key for f_ in findings)},
                  f, indent=2)
        f.write("\n")


def apply_baseline(
    findings: list[Finding], suppressions: list[str]
) -> tuple[list[Finding], list[Finding], list[str]]:
    """-> (active, suppressed, stale_suppression_keys).

    A suppression is STALE when no current finding matches it — the
    underlying fault was fixed, so the baseline entry must be deleted
    (callers treat stale entries as an error: baselines only shrink).
    """
    sup = set(suppressions)
    active = [f for f in findings if f.key not in sup]
    suppressed = [f for f in findings if f.key in sup]
    stale = sorted(sup - {f.key for f in findings})
    return active, suppressed, stale


def render_report(findings: list[Finding], *, suppressed: list[Finding] = (),
                  stale: list[str] = (), tool: str = "repro_torch.analysis") -> str:
    """Uniform text summary every lint CLI prints."""
    lines = [f"{tool}: {f.render()}" for f in sorted(
        findings, key=lambda f: (f.path, f.line, f.rule))]
    for key in stale:
        lines.append(f"{tool}: stale baseline suppression (its finding is gone — delete it): {key}")
    n, m = len(findings), len(suppressed)
    if n or stale:
        lines.append(f"{tool}: {n} finding(s), {m} suppressed, {len(stale)} stale suppression(s)")
    else:
        lines.append(f"{tool}: clean ({m} suppressed)" if m else f"{tool}: clean")
    return "\n".join(lines)
