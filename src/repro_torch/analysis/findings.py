"""Finding records, inline suppressions, and the committed baseline (a
copy of :mod:`repro.analysis.findings`; a CUDA source takes the same
comment after ``//``).

A finding is identified by a *fingerprint* — ``sha1(rule|relpath|scope|
normalized source line)`` — deliberately independent of the line
*number*, so unrelated edits above a baselined finding don't churn the
baseline file.

Suppression syntax (checked by :func:`scan_suppressions`)::

    x = float(dist)  # repro: ignore[RS101] CLI timing, off hot path
    cudaDeviceSynchronize();  // repro: ignore[RS101] <reason>

The comment may sit on the finding's own line or the line directly
above.  A suppression without a reason still suppresses but raises the
meta-finding ``RS001``; a suppression that matches nothing raises
``RS002`` — both keep the ignore inventory honest.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

__all__ = [
    "Finding", "Suppression", "scan_suppressions", "apply_suppressions",
    "load_baseline", "apply_baseline", "write_baseline",
]

_IGNORE_RE = re.compile(
    r"(?:#|//)\s*repro:\s*ignore\[(RS\d{3}(?:\s*,\s*RS\d{3})*)\]\s*(.*)$")


@dataclasses.dataclass
class Finding:
    rule: str                 # "RS101"
    path: Path                # absolute file path
    lineno: int
    scope: str                # qualname of the enclosing function/module
    message: str
    source_line: str = ""     # stripped source text of the finding line

    def rel(self, root: Path) -> str:
        try:
            return str(self.path.relative_to(root))
        except ValueError:
            return str(self.path)

    def fingerprint(self, root: Path) -> str:
        norm = re.sub(r"\s+", " ", self.source_line.strip())
        key = f"{self.rule}|{self.rel(root)}|{self.scope}|{norm}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def render(self, root: Path) -> str:
        return (f"{self.rel(root)}:{self.lineno}: {self.rule} "
                f"[{self.scope}] {self.message}")


@dataclasses.dataclass
class Suppression:
    path: Path
    lineno: int               # line the comment sits on
    rules: List[str]
    reason: str
    used: bool = False


def scan_suppressions(path: Path, source: str) -> List[Suppression]:
    out = []
    for i, line in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(line)
        if m:
            rules = [r.strip() for r in m.group(1).split(",")]
            out.append(Suppression(path=path, lineno=i, rules=rules,
                                   reason=m.group(2).strip()))
    return out


def apply_suppressions(
    findings: List[Finding],
    suppressions: Dict[Path, List[Suppression]],
) -> List[Finding]:
    """Drop findings matched by an inline ignore; append RS001/RS002
    meta-findings for missing reasons and unused suppressions."""
    kept: List[Finding] = []
    for f in findings:
        hit: Optional[Suppression] = None
        for s in suppressions.get(f.path, ()):
            if f.rule in s.rules and s.lineno in (f.lineno, f.lineno - 1):
                hit = s
                break
        if hit is None:
            kept.append(f)
        else:
            hit.used = True
    for path, subs in suppressions.items():
        for s in subs:
            if s.used and not s.reason:
                kept.append(Finding(
                    rule="RS001", path=path, lineno=s.lineno,
                    scope="<suppression>",
                    message="suppression has no justification text — add "
                            "a reason after the bracket",
                    source_line=f"ignore[{','.join(s.rules)}]"))
            if not s.used:
                kept.append(Finding(
                    rule="RS002", path=path, lineno=s.lineno,
                    scope="<suppression>",
                    message=f"unused suppression for "
                            f"{','.join(s.rules)} — matched no finding; "
                            f"delete it",
                    source_line=f"ignore[{','.join(s.rules)}]"))
    return kept


# -- baseline ----------------------------------------------------------------

def load_baseline(path: Path) -> Dict[str, dict]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text(encoding="utf-8"))
    return data.get("findings", {})


def apply_baseline(
    findings: List[Finding],
    baseline: Dict[str, dict],
    root: Path,
) -> tuple[List[Finding], List[str], List[str]]:
    """Split findings into (new, baselined fingerprints seen, stale
    fingerprints).  Stale = baselined but no longer present: the debt was
    paid, so the entry must be deleted (the file only ever shrinks)."""
    new: List[Finding] = []
    seen: List[str] = []
    for f in findings:
        fp = f.fingerprint(root)
        if fp in baseline:
            seen.append(fp)
        else:
            new.append(f)
    stale = [fp for fp in baseline if fp not in seen]
    return new, seen, stale


def write_baseline(path: Path, findings: List[Finding], root: Path) -> None:
    entries = {}
    for f in sorted(findings, key=lambda f: (f.rel(root), f.lineno)):
        entries[f.fingerprint(root)] = {
            "rule": f.rule,
            "path": f.rel(root),
            "scope": f.scope,
            "message": f.message,
            # every baselined entry must carry a human justification;
            # check_static errors on empty ones (the CI growth gate)
            "justification": "",
        }
    payload = {
        "_comment": "Frozen pre-existing findings. Entries may only be "
                    "removed (debt paid) — new findings must be fixed or "
                    "inline-suppressed, and every entry needs a "
                    "non-empty justification.",
        "findings": entries,
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")
