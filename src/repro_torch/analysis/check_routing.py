"""Fail if the dispatch layer silently fell off the expected route (the
counterpart of the reference's ``scripts/check_routing.py``).

Usage: ``python -m repro_torch.analysis.check_routing DUMP.json [ROUTE]``

The dump is a ``repro_torch.obs`` metrics snapshot (``obs.snapshot()``,
``obs.write_snapshot`` or ``REPRO_OBS_DUMP=<path>``) whose
``dispatch_total`` counters mirror the process-lifetime
``repro_torch.core.dispatch.totals`` ledger.  That snapshot is the *only*
accepted format — a dump without counters/histograms keys is rejected
rather than guessed at.  Every elastic op must have dispatched through
ROUTE (default ``cuda``, the kernels; ``torch`` is the CPU route) at
least once — a kernel that stopped loading, or inputs left on the CPU,
would otherwise let a run pass without launching a single kernel.

Measure-parameterised ops are additionally keyed as ``op[measure]``; for
MEASURED_OPS the gate also requires at least one NON-DTW measure to have
dispatched through ROUTE, so the measure-generic kernel bodies (wdtw,
erp, msm) are provably exercised, not just the DTW default.

When the snapshot was captured with obs enabled (or the caller says the
run had obs on where its stages ran), a third gate checks *stage
coverage*: every instrumented pipeline stage in EXPECTED_STAGES must have
recorded at least one ``stage_seconds`` span.

Exit codes: 0 clean; 1 a gate failed; 2 usage error or a dump that is
not a snapshot.  ``chip_smoke.py`` runs :func:`check` in-process on the
card after every path, as its ``routing_gate`` phase.
"""

from __future__ import annotations

import json
import re
import sys
from typing import List, Optional, Tuple

__all__ = ["EXPECTED_OPS", "MEASURED_OPS", "EXPECTED_STAGES",
           "ledger_from_snapshot", "check", "main"]

EXPECTED_OPS = (
    "elastic_pairwise",
    "elastic_pairwise_adaptive",
    "elastic_cdist",
    "adc_cdist",
    "adc_cdist_quant",
    "adc_lookup",
    "adc_lookup_quant",
    "prealign_encode",
    "lb_refine",
    "lb_refine_adaptive",
    "two_level_coarse",
    "lb_filter",
)

# ops whose recurrence is measure-parameterised: each needs a non-DTW
# dispatch on the asserted route (lb_refine stays DTW-only by its
# capability gate, so it is not listed here)
MEASURED_OPS = (
    "elastic_pairwise",
    "elastic_cdist",
    "prealign_encode",
    "two_level_coarse",
)

# every instrumented pipeline stage a run must light up with obs on
# (spans live in index/streaming.py, index/planner.py and serve_index/)
EXPECTED_STAGES = (
    "index.search",
    "index.search.coarse",
    "index.search.lut",
    "index.search.fine",
    "index.search.hot",
    "index.search.merge",
    "index.insert",
    "index.flush",
    "index.compact",
    "sharded.search",
    "sharded.execute",
    "serving.batch_search",
    "serving.apply",
    "serving.snapshot_swap",
)


def ledger_from_snapshot(snap: dict) -> dict:
    """Rebuild the flat ``{"op:route": n, "op[measure]:route": n}``
    ledger from a metrics snapshot's ``dispatch_total`` counters."""
    ledger: dict = {}
    for c in snap.get("counters", []):
        if c["name"] != "dispatch_total":
            continue
        labels = c["labels"]
        op, route = labels.get("op"), labels.get("backend")
        if not op or not route:
            continue
        n = int(c["value"])
        key = f"{op}:{route}"
        ledger[key] = ledger.get(key, 0) + n
        measure = labels.get("measure")
        if measure:
            mkey = f"{op}[{measure}]:{route}"
            ledger[mkey] = ledger.get(mkey, 0) + n
    return ledger


def check(snap: dict, route: str = "cuda",
          stages: Optional[bool] = None) -> Tuple[int, List[str]]:
    """``(exit code, report lines)`` of the gate on snapshot ``snap``.
    ``stages`` asserts stage coverage; by default it follows the
    snapshot's ``obs_enabled``."""
    if "counters" not in snap and "histograms" not in snap:
        return 2, ["FAIL: not a repro_torch.obs metrics snapshot (no "
                   "counters/histograms keys); a flat routing dict is not "
                   "accepted"]
    ledger = ledger_from_snapshot(snap)
    lines = [f"routing ledger, asserting route {route!r}:"]
    lines += [f"  {key}: {ledger[key]}" for key in sorted(ledger)]
    missing = [op for op in EXPECTED_OPS if not ledger.get(f"{op}:{route}")]
    if missing:
        lines.append(f"FAIL: ops never dispatched through {route!r}: "
                     f"{', '.join(missing)} — silent fallback?")
        return 1, lines
    missing_measure = []
    for op in MEASURED_OPS:
        pat = re.compile(
            rf"^{re.escape(op)}\[(?!dtw\])[^\]]+\]:{re.escape(route)}$")
        if not any(pat.match(k) and ledger[k] for k in ledger):
            missing_measure.append(op)
    if missing_measure:
        lines.append(f"FAIL: measure-parameterised ops never ran a non-DTW "
                     f"measure through {route!r}: "
                     f"{', '.join(missing_measure)} — the measure-generic "
                     f"kernel bodies are untested")
        return 1, lines
    lines.append(f"OK: all {len(EXPECTED_OPS)} elastic ops routed through "
                 f"{route!r} (incl. a non-DTW measure for "
                 f"{len(MEASURED_OPS)} measured ops)")
    if stages is None:
        stages = bool(snap.get("obs_enabled"))
    if not stages:
        lines.append("note: snapshot captured with obs disabled — "
                     "stage-coverage gate skipped (set REPRO_OBS=1 to "
                     "assert it)")
        return 0, lines
    seen = {h["labels"].get("stage") for h in snap.get("histograms", [])
            if h["name"] == "stage_seconds" and h["count"] > 0}
    missing_stages = [s for s in EXPECTED_STAGES if s not in seen]
    if missing_stages:
        lines.append(f"FAIL: instrumented stages recorded zero samples: "
                     f"{', '.join(missing_stages)} — span instrumentation "
                     f"silently dropped?")
        return 1, lines
    lines.append(f"OK: all {len(EXPECTED_STAGES)} instrumented stages "
                 f"recorded spans")
    return 0, lines


def main(argv: Optional[List[str]] = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args or len(args) > 2:
        print(__doc__)
        return 2
    with open(args[0]) as f:
        snap = json.load(f)
    rc, lines = check(snap, args[1] if len(args) > 1 else "cuda")
    print(f"{args[0]}:")
    print("\n".join(lines))
    return rc


if __name__ == "__main__":
    sys.exit(main())
