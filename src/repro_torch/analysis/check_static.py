"""Static-analysis gate of the port: run the :mod:`repro_torch.analysis`
rule engine and fail on any unsuppressed, unbaselined finding (the
counterpart of the reference's ``scripts/check_static.py``).

Usage::

    python -m repro_torch.analysis.check_static [--root PATH]
        [--baseline PATH] [--write-baseline] [--list-rules]

Exit codes: 0 clean; 1 findings (new findings, stale baseline entries,
or baseline entries without a justification); 2 usage/internal error.

Findings are silenced either inline::

    x = float(d)  # repro: ignore[RS101] CLI timing, off the hot path

or by freezing them in the baseline file (by default
``src/repro_torch/analysis/STATIC_BASELINE.json`` under the root).  The
baseline only ever shrinks: stale entries (debt paid) and entries whose
``justification`` field is empty are errors, which is what stops the
baseline growing without an explicit written reason.
``--write-baseline`` regenerates the file from the current findings with
empty justifications for a human to fill in.

``--root`` (default: the checkout this file lies in) exists so the
fixture tests can point the gate at doctored trees.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .engine import BASELINE, RULES, analyze
from .findings import write_baseline

REPO_ROOT = Path(__file__).resolve().parents[3]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.check_static")
    ap.add_argument("--root", default=str(REPO_ROOT))
    ap.add_argument(
        "--baseline",
        default=None,
        help=f"baseline file (default: <root>/{BASELINE})",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="freeze current findings into the baseline file and exit",
    )
    ap.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalog and exit",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES):
            print(f"  {rule}  {RULES[rule]}")
        return 0

    root = Path(args.root).resolve()
    if not (root / "src" / "repro_torch").is_dir():
        print(f"FAIL: no src/repro_torch under {root}")
        return 2
    baseline = Path(args.baseline) if args.baseline else root / BASELINE

    if args.write_baseline:
        report = analyze(root, baseline_path=None)
        write_baseline(baseline, report.findings, root)
        print(
            f"wrote {len(report.findings)} finding(s) to {baseline} "
            f"(fill in every justification field)"
        )
        return 0

    report = analyze(root, baseline_path=baseline)
    n_mod = len(report.graph.modules)
    n_fn = len(report.graph.functions)
    n_roots = len(report.graph.hot_roots())
    print(
        f"  analyzed {n_mod} modules / {n_fn} functions "
        f"({n_roots} hot roots), baselined: {len(report.baselined)}"
    )

    failed = False
    if report.findings:
        failed = True
        print(f"FAIL: {len(report.findings)} finding(s):")
        for f in report.findings:
            print(f"  {f.render(root)}")
    if report.stale_baseline:
        failed = True
        print(
            f"FAIL: {len(report.stale_baseline)} stale baseline "
            f"entr(ies) — the finding is gone, delete the entry:"
        )
        for fp in report.stale_baseline:
            print(f"  {fp}")
    if report.unjustified_baseline:
        failed = True
        print(
            f"FAIL: {len(report.unjustified_baseline)} baseline "
            f"entr(ies) with an empty justification:"
        )
        for fp in report.unjustified_baseline:
            print(f"  {fp}")
    if failed:
        print("  (suppress inline with `# repro: ignore[RSxxx] <reason>` "
              "or baseline with a justification)")
        return 1
    print("OK: static analysis clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
