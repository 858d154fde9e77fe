"""Observability layer of the port: metrics registry, stage spans,
exporters (counterpart of :mod:`repro.obs`, with the same stage names and
the same ``repro_`` metric names)::

    from repro_torch import obs

    with obs.span("index.search.coarse") as sp:
        dc = sp.fence(coarse_dists(...))     # device work lands in the span

    obs.counter("lb_refined_total").inc(int(n_refined))
    obs.gauge("hot_occupancy").set(fill / capacity)
    print(obs.to_prometheus())

Disabled by default (``REPRO_OBS=1`` or :func:`enable` turns it on):
metric *writes* stay cheap host-side dict/list operations either way, and
the disabled path makes no device sync — no spans, no fences — so search
results are identical with obs on or off.  ``REPRO_OBS_DUMP=<path>``
writes a JSON snapshot at process exit.

The dispatch routing ledgers (:data:`repro_torch.core.dispatch.stats` /
``totals``) are mirrored into the registry as ``dispatch_total`` counters
labeled ``kind="call"``: PyTorch runs eagerly, so the port counts every
dispatch *call*, where the reference counts *traces* (``kind="trace"``;
a jitted caller hitting its cache does not re-count there).
"""

from .export import (DUMP_ENV_VAR, PROM_PREFIX, snapshot, to_json,
                     to_prometheus, write_snapshot)
from .registry import (DEFAULT_LATENCY_BUCKETS, MAX_SAMPLES, REGISTRY,
                       Counter, Gauge, Histogram, Registry, exp_buckets,
                       percentile)
from .report import (check_stages, counter_value, missing_stages, render,
                     stage_rows)
from .spans import (ENV_VAR, Span, current_spans, disable, enable, enabled,
                    fence, override, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "exp_buckets", "percentile", "DEFAULT_LATENCY_BUCKETS", "MAX_SAMPLES",
    "ENV_VAR", "DUMP_ENV_VAR", "PROM_PREFIX",
    "enabled", "enable", "disable", "override",
    "span", "Span", "fence", "current_spans",
    "counter", "gauge", "histogram", "reset",
    "snapshot", "to_json", "to_prometheus", "write_snapshot",
    "render", "stage_rows", "counter_value", "missing_stages",
    "check_stages",
]


def counter(name: str, persistent: bool = False, **labels: str) -> Counter:
    """Get-or-create a counter in the process-wide registry.

    Same ``(name, labels)`` always returns the same object, so call sites
    never cache handles:

    >>> from repro_torch import obs
    >>> obs.counter("doc_requests_total", route="a").inc()
    >>> obs.counter("doc_requests_total", route="a").inc(2)
    >>> obs.counter("doc_requests_total", route="a").value
    3
    >>> obs.reset()
    """
    return REGISTRY.counter(name, persistent=persistent, **labels)


def gauge(name: str, persistent: bool = False, **labels: str) -> Gauge:
    """Get-or-create a gauge in the process-wide registry.

    >>> from repro_torch import obs
    >>> obs.gauge("doc_queue_depth").set(7)
    >>> int(obs.gauge("doc_queue_depth").value)
    7
    >>> obs.reset()
    """
    return REGISTRY.gauge(name, persistent=persistent, **labels)


def histogram(name: str, buckets=None, persistent: bool = False,
              **labels: str) -> Histogram:
    """Get-or-create a histogram in the process-wide registry.

    Default bounds are the exponential latency ladder
    (:data:`DEFAULT_LATENCY_BUCKETS`); percentiles are exact over the
    recorded samples:

    >>> from repro_torch import obs
    >>> h = obs.histogram("doc_wait_seconds")
    >>> for v in (0.010, 0.020, 0.030):
    ...     h.record(v)
    >>> h.count
    3
    >>> round(h.percentile(50.0), 3)
    0.02
    >>> obs.reset()
    """
    return REGISTRY.histogram(name, buckets=buckets, persistent=persistent,
                              **labels)


def reset(include_persistent: bool = False) -> None:
    """Reset the process-wide registry (scratch metrics only by default —
    dispatch routing counters and stage spans are persistent).

    >>> from repro_torch import obs
    >>> obs.counter("doc_scratch_total").inc()
    >>> obs.counter("doc_survivor_total", persistent=True).inc()
    >>> obs.reset()
    >>> obs.counter("doc_scratch_total").value       # re-created fresh
    0
    >>> obs.counter("doc_survivor_total", persistent=True).value
    1

    ``include_persistent=True`` wipes everything — on the *process-wide*
    registry that erases the dispatch routing evidence CI's gate reads,
    so the full wipe is demonstrated on a private registry:

    >>> reg = obs.Registry()
    >>> reg.counter("doc_all_total", persistent=True).inc()
    >>> reg.reset(include_persistent=True)
    >>> reg.counter("doc_all_total", persistent=True).value
    0
    """
    REGISTRY.reset(include_persistent=include_persistent)
