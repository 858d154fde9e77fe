"""Exporters: JSON snapshot + Prometheus text format + atexit dump (a copy
of :mod:`repro.obs.export`, which is pure Python).

The JSON snapshot is the machine-readable interchange format of the obs
layer; ``to_prometheus`` emits the standard text exposition format
(cumulative ``le`` buckets, ``_sum``/``_count`` series) so a scrape
endpoint can serve the same registry verbatim.  Both render the same
registry writes exactly as the JAX package's exporters do.

Set ``REPRO_OBS_DUMP=<path>`` to write a snapshot at interpreter exit.
"""

from __future__ import annotations

import atexit
import json
import math
import os
from typing import Optional

from . import spans
from .registry import REGISTRY, Registry

__all__ = ["snapshot", "to_json", "to_prometheus", "write_snapshot",
           "DUMP_ENV_VAR", "PROM_PREFIX"]

DUMP_ENV_VAR = "REPRO_OBS_DUMP"

# Prometheus metric-name prefix for every exported series.
PROM_PREFIX = "repro_"

# histogram percentiles included in every snapshot / report
PERCENTILES = (50.0, 95.0, 99.0)


def snapshot(registry: Optional[Registry] = None,
             include_samples: bool = False) -> dict:
    """JSON-able dict of the whole registry.

    Histogram entries carry exact ``p50/p95/p99`` (from the recorded
    samples) next to the exponential buckets; ``include_samples`` embeds
    the raw samples too (round-trip tests, offline re-analysis).
    """
    reg = registry if registry is not None else REGISTRY
    out = {
        "obs_enabled": spans.enabled(),
        "counters": [
            {"name": c.name, "labels": c.labels, "value": c.value}
            for c in reg.counters()],
        "gauges": [
            {"name": g.name, "labels": g.labels, "value": g.value}
            for g in reg.gauges()],
        "histograms": [],
    }
    for h in reg.histograms():
        entry = {
            "name": h.name, "labels": h.labels, "count": h.count,
            "sum": h.sum,
            "min": h.min if h.count else None,
            "max": h.max if h.count else None,
            "samples_capped": h.samples_capped,
            "buckets": {"le": list(h.bounds),
                        "counts": list(h.bucket_counts)},
        }
        for p in PERCENTILES:
            entry[f"p{p:g}"] = h.percentile(p) if h.samples else None
        if include_samples:
            entry["samples"] = list(h.samples)
        out["histograms"].append(entry)
    return out


def to_json(registry: Optional[Registry] = None,
            include_samples: bool = False) -> str:
    return json.dumps(snapshot(registry, include_samples=include_samples),
                      indent=1, sort_keys=True)


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


def to_prometheus(registry: Optional[Registry] = None) -> str:
    """Prometheus text exposition format for the whole registry."""
    reg = registry if registry is not None else REGISTRY
    lines = []
    typed = set()

    def header(name: str, kind: str):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {PROM_PREFIX}{name} {kind}")

    for c in reg.counters():
        header(c.name, "counter")
        lines.append(
            f"{PROM_PREFIX}{c.name}{_prom_labels(c.labels)} {c.value}")
    for g in reg.gauges():
        header(g.name, "gauge")
        lines.append(
            f"{PROM_PREFIX}{g.name}{_prom_labels(g.labels)} {_fmt(g.value)}")
    for h in reg.histograms():
        header(h.name, "histogram")
        cum = h.cumulative_counts()
        for bound, count in zip(list(h.bounds) + [math.inf], cum):
            le = _prom_labels(h.labels, {"le": _fmt(bound)})
            lines.append(f"{PROM_PREFIX}{h.name}_bucket{le} {count}")
        lines.append(
            f"{PROM_PREFIX}{h.name}_sum{_prom_labels(h.labels)} "
            f"{_fmt(h.sum)}")
        lines.append(
            f"{PROM_PREFIX}{h.name}_count{_prom_labels(h.labels)} {h.count}")
    return "\n".join(lines) + "\n"


def write_snapshot(path: str, registry: Optional[Registry] = None,
                   include_samples: bool = False) -> str:
    """Write the JSON snapshot to ``path`` (parent dirs created)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write(to_json(registry, include_samples=include_samples))
    return path


def _dump_at_exit() -> None:
    path = os.environ.get(DUMP_ENV_VAR)
    if path:
        write_snapshot(path)


atexit.register(_dump_at_exit)
