"""Rule engine: build the call graph, run every rule family, fold in
inline suppressions and the committed baseline (the counterpart of
:mod:`repro.analysis.engine`).

:func:`analyze` is the one entry point; :mod:`.check_static` is a thin
CLI over it and the fixture tests call it directly on miniature trees
under ``tests/fixtures/analysis_torch/``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List

from . import rules_concurrency, rules_dispatch, rules_trace
from .callgraph import CallGraph, build_graph
from .findings import (Finding, Suppression, apply_baseline,
                       apply_suppressions, load_baseline, scan_suppressions)

__all__ = ["RULES", "Report", "analyze", "BASELINE"]

# the port's baseline, relative to the tree's root (the root's
# STATIC_BASELINE.json is the reference's)
BASELINE = Path("src/repro_torch/analysis/STATIC_BASELINE.json")

# id -> one-line summary; --list-rules prints it.  RS103 (jit
# static_argnames) has no counterpart in eager PyTorch.
RULES: Dict[str, str] = {
    "RS001": "suppression comment has no justification text",
    "RS002": "suppression comment matched no finding",
    "RS101": "host sync or device read-back outside obs.fence",
    "RS102": "data-dependent Python branch in a hot-reachable function",
    "RS104": "module-level state mutated from a hot-reachable function",
    "RS201": "kernel package missing ops.py, ref.py or its CUDA source",
    "RS202": "kernel package not imported by core/dispatch.py",
    "RS203": "dispatch op not gated by EXPECTED_OPS in the routing gate",
    "RS204": "torch.vmap over a function that can reach a CUDA launch",
    "RS205": "routing gate consumes more than one dump format",
    "RS301": "writer-only field assigned outside writer-thread methods",
    "RS302": "attribute assignment on a published IndexView",
    "RS303": "bare lock acquire/release instead of a with block",
}


@dataclasses.dataclass
class Report:
    graph: CallGraph
    findings: List[Finding]        # new, unsuppressed, unbaselined
    baselined: List[str]           # fingerprints matched by the baseline
    stale_baseline: List[str]      # baselined but no longer present
    unjustified_baseline: List[str]  # baselined with empty justification

    @property
    def clean(self) -> bool:
        return (not self.findings and not self.stale_baseline
                and not self.unjustified_baseline)


def _py_files(root: Path) -> List[Path]:
    pkg = root / "src" / "repro_torch"
    return sorted(p for p in pkg.rglob("*.py")
                  if "__pycache__" not in p.parts
                  and "analysis" not in p.relative_to(pkg).parts)


def analyze(root: Path, baseline_path: Path | None = None) -> Report:
    """Run every rule over the tree rooted at ``root`` (which contains
    ``src/repro_torch``, its ``kernels/csrc`` and optionally the routing
    gate ``src/repro_torch/analysis/check_routing.py``)."""
    root = root.resolve()
    files = _py_files(root)
    graph = build_graph(files, root / "src")

    findings: List[Finding] = []
    findings += rules_trace.run(graph)
    findings += rules_trace.run_csrc(
        root / "src" / "repro_torch" / "kernels" / "csrc")
    findings += rules_dispatch.run(graph, root)
    findings += rules_concurrency.run(graph)

    suppressions: Dict[Path, List[Suppression]] = {}
    paths = {m.path for m in graph.modules.values()}
    paths.update(f.path for f in findings)
    for path in paths:
        if path.exists():
            subs = scan_suppressions(path, path.read_text(encoding="utf-8"))
            if subs:
                suppressions[path] = subs
    findings = apply_suppressions(findings, suppressions)
    findings.sort(key=lambda f: (f.rel(root), f.lineno, f.rule))

    baseline = (load_baseline(baseline_path)
                if baseline_path is not None else {})
    new, seen, stale = apply_baseline(findings, baseline, root)
    unjustified = [fp for fp in seen
                   if not baseline[fp].get("justification", "").strip()]
    return Report(graph=graph, findings=new, baselined=seen,
                  stale_baseline=stale, unjustified_baseline=unjustified)
