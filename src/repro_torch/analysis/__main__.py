"""The port's lint — runner-key audit + kernel-contract analyzer.

    PYTHONPATH=src python -m repro_torch.analysis [-v] [--ast-only]
        [--json PATH] [--baseline PATH] [--write-baseline]

Counterpart of the reference's ``tools/dittolint.py``. Runs every pass in
``repro_torch.analysis`` over the repo:

  * AST passes (fast, no device): kernel-contract rules over
    ``src/repro_torch/kernels/`` and its C entries, ``device-resolve``
    over the port, the trace-leak scan over the plan-threading boundary,
    bench-registration, pytest-marker and port-import audits, and the
    plan rules;
  * the runner-key audit: what a step dispatches, recorded on fake
    tensors (fake CUDA where a card is visible, ``meta`` where not),
    proves ``DittoPlan.cache_sig()`` equality ⇔ step identity in both
    directions (no kernel launches, no weight exists; seconds on the
    CPU), plus a CPU leg on real tensors for the plans the card refuses.
    ``--ast-only`` skips it.

Findings not suppressed by the baseline (``baseline.json`` beside this
file; policy: fix-don't-suppress, ships empty) fail the run (exit 1), as
do STALE baseline entries — suppressions whose finding no longer fires
must be deleted, so the baseline only ever shrinks. A malformed baseline
exits 2. ``--json`` writes the machine-readable report; ``--write-baseline``
accepts the current findings as the new baseline (for bootstrapping a
rule, not for dodging one) and exits 0.
"""
from __future__ import annotations

import argparse
import os
import sys

from . import (apply_baseline, check_kernels, check_plan_rules, check_repo_rules,
               check_trace_leaks, load_baseline, render_report, report_json,
               write_baseline)

#: the repo root: src/repro_torch/analysis/ is three levels below it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")

TOOL = "repro_torch.analysis"


def run(root: str = ROOT, *, ast_only: bool = False, log=None) -> list:
    """Every pass's findings over the tree at ``root``."""
    say = log or (lambda *_: None)
    findings = []
    say("pass: kernel-contract (src/repro_torch/kernels, csrc, device-resolve)")
    findings += check_kernels(root)
    say("pass: trace-leak (kernels/ops, core/ditto boundary)")
    findings += check_trace_leaks(root)
    say("pass: repo rules (bench-registration, marker-audit, port-imports)")
    findings += check_repo_rules(root)
    say("pass: plan rules (recovery knobs out of cache_sig/SEGMENT_FIELDS, RunnerKey slots)")
    findings += check_plan_rules(root)
    if not ast_only:
        say("pass: runner-key audit (what a step dispatches, on fake tensors)")
        from .trace_audit import run_trace_audit
        findings += run_trace_audit(log=say)
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=f"python -m {TOOL}",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="narrate passes and every recorded (sig, fingerprint)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE, metavar="PATH",
                    help="suppression baseline JSON (default: %(default)s)")
    ap.add_argument("--ast-only", action="store_true",
                    help="skip the runner-key audit (AST rules only)")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the machine-readable findings report")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings as the new baseline and exit 0")
    args = ap.parse_args(argv)
    findings = run(ast_only=args.ast_only, log=print if args.verbose else None)

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"{TOOL}: wrote {len(findings)} suppression(s) to {args.baseline}")
        return 0
    try:
        suppressions = load_baseline(args.baseline)
    except ValueError as e:
        print(f"{TOOL}: {e}", file=sys.stderr)
        return 2
    active, suppressed, stale = apply_baseline(findings, suppressions)
    if args.json:
        with open(args.json, "w") as f:
            f.write(report_json(active, suppressed=suppressed))
    print(render_report(active, suppressed=suppressed, stale=stale, tool=TOOL))
    return 1 if active or stale else 0


if __name__ == "__main__":
    raise SystemExit(main())
