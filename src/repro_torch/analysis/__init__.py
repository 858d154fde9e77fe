"""Static analysis for the port (the counterpart of :mod:`repro.analysis`,
its own copy: nothing here imports the JAX package or the code it reads).

An AST-based rule engine over ``src/repro_torch``: a best-effort call
graph (:mod:`.callgraph`, from the declared hot roots) feeds three rule
families —

* **RS1xx** hot-path safety (:mod:`.rules_trace`): no host syncs,
  device read-backs or data-dependent Python control flow on hot paths
  (and no sync in the kernel library's host code);
* **RS2xx** dispatch invariants (:mod:`.rules_dispatch`): every kernel
  package complete, routed, gated by the routing gate, and never
  vmapped over;
* **RS3xx** concurrency discipline (:mod:`.rules_concurrency`):
  writer-only state, immutable published views, ``with``-scoped locks in
  ``serve_index``.

Driven by ``python -m repro_torch.analysis.check_static``; findings are
suppressed inline with ``# repro: ignore[RSxxx] <reason>`` or frozen in
``src/repro_torch/analysis/STATIC_BASELINE.json``.  The two dynamic
gates run on the card: :mod:`.check_routing` (every dispatch op through
route ``"cuda"``) and :mod:`.check_sanitizers` (no op reads the card
back).
"""

from .engine import RULES, Report, analyze
from .findings import Finding

__all__ = ["RULES", "Report", "analyze", "Finding"]
