"""Console rendering of a metrics snapshot + stage-coverage checks (a copy
of :mod:`repro.obs.report`, which is pure Python).

Everything here consumes the *snapshot dict* from
:func:`repro_torch.obs.export.snapshot` — not live metric objects — so a
JSON file read back from disk renders identically to an in-process
registry.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["stage_rows", "counter_value", "missing_stages", "render",
           "check_stages"]


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def stage_rows(snap: dict) -> List[Tuple[str, int, float, float, float]]:
    """``(stage, count, p50, p95, p99)`` per ``stage_seconds`` histogram,
    sorted by stage name.  Stages with no samples report zero counts."""
    rows = []
    for h in snap.get("histograms", []):
        if h["name"] != "stage_seconds":
            continue
        stage = h["labels"].get("stage", "?")
        rows.append((stage, h["count"], h.get("p50") or 0.0,
                     h.get("p95") or 0.0, h.get("p99") or 0.0))
    return sorted(rows)


def counter_value(snap: dict, name: str, **labels: str) -> float:
    """Sum of every counter ``name`` whose labels are a superset of
    ``labels`` (so ``counter_value(s, "dispatch_total", op="adc_cdist")``
    aggregates over backends/measures)."""
    total = 0.0
    for c in snap.get("counters", []):
        if c["name"] != name:
            continue
        if all(c["labels"].get(k) == v for k, v in labels.items()):
            total += c["value"]
    return total


def missing_stages(snap: dict, required: Sequence[str]) -> List[str]:
    """Required stage names that recorded zero ``stage_seconds`` samples."""
    seen = {stage for stage, count, *_ in stage_rows(snap) if count > 0}
    return [s for s in required if s not in seen]


def _fmt_ms(seconds: float) -> str:
    ms = seconds * 1e3
    return f"{ms:10.2f}" if ms < 1e5 else f"{ms:10.3g}"


def render(snap: dict, title: str = "observability report") -> str:
    """Multi-section console report of a snapshot dict."""
    lines = [f"== {title} ==",
             f"obs_enabled: {snap.get('obs_enabled')}"]

    rows = stage_rows(snap)
    if rows:
        lines.append("")
        lines.append(f"{'stage':<28} {'count':>7} {'p50 ms':>10} "
                     f"{'p95 ms':>10} {'p99 ms':>10}")
        for stage, count, p50, p95, p99 in rows:
            lines.append(f"{stage:<28} {count:>7} {_fmt_ms(p50)} "
                         f"{_fmt_ms(p95)} {_fmt_ms(p99)}")

    prune = [h for h in snap.get("histograms", [])
             if h["name"] == "lb_pruning_rate" and h["count"]]
    bounded = counter_value(snap, "lb_candidates_bounded_total")
    refined = counter_value(snap, "lb_candidates_refined_total")
    if prune or bounded:
        lines.append("")
        lines.append("-- LB cascade --")
        if bounded:
            lines.append(
                f"candidates bounded/refined/pruned: {int(bounded)} / "
                f"{int(refined)} / {int(bounded - refined)} "
                f"(pruning rate {1.0 - refined / bounded:.1%})")
        for h in prune:
            lines.append(
                f"per-search pruning rate{_label_str(h['labels'])}: "
                f"p50 {h.get('p50') or 0.0:.1%}, over {h['count']} searches")

    routes = [c for c in snap.get("counters", [])
              if c["name"] == "dispatch_total"]
    if routes:
        lines.append("")
        lines.append("-- dispatch routing (trace-time counts) --")
        for c in sorted(routes, key=lambda c: sorted(c["labels"].items())):
            lab = dict(c["labels"])
            lab.pop("kind", None)
            op = lab.pop("op", "?")
            backend = lab.pop("backend", "?")
            extra = _label_str(lab)
            lines.append(f"{op + extra:<36} -> {backend:<18} "
                         f"{int(c['value']):>6}")

    other = [c for c in snap.get("counters", [])
             if c["name"] != "dispatch_total"]
    if other:
        lines.append("")
        lines.append("-- counters --")
        for c in sorted(other,
                        key=lambda c: (c["name"], sorted(c["labels"].items()))):
            lines.append(f"{c['name'] + _label_str(c['labels']):<44} "
                         f"{int(c['value']):>10}")

    gauges = snap.get("gauges", [])
    if gauges:
        lines.append("")
        lines.append("-- gauges --")
        for g in sorted(gauges,
                        key=lambda g: (g["name"], sorted(g["labels"].items()))):
            lines.append(f"{g['name'] + _label_str(g['labels']):<44} "
                         f"{g['value']:>10.4g}")
    return "\n".join(lines)


def check_stages(snap: dict, required: Sequence[str]
                 ) -> Tuple[bool, Optional[str]]:
    """``(ok, message)`` for a stage-coverage gate: every name in
    ``required`` must have recorded at least one span.  Fails (with a
    pointed message) when the snapshot was taken with obs disabled —
    a coverage assertion against a disabled registry is vacuous."""
    if not snap.get("obs_enabled"):
        return False, ("snapshot was captured with obs disabled "
                       "(obs_enabled: false) — set REPRO_OBS=1 in the "
                       "producing process to assert stage coverage")
    missing = missing_stages(snap, required)
    if missing:
        return False, ("stages recorded zero samples: "
                       + ", ".join(missing))
    return True, None
