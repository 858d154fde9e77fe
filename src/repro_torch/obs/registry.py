"""Process-wide metrics registry: Counter / Gauge / Histogram (a copy of
:mod:`repro.obs.registry`, which is pure Python).

The primitives are deliberately plain host-side Python — incrementing a
counter is two dict operations, recording a histogram sample is a list
append — so the *write* path is cheap enough to leave wired into every
pipeline layer.  Anything device-related (fencing, syncing) lives in
:mod:`repro_torch.obs.spans`, gated behind :func:`repro_torch.obs.enabled`.

Histograms keep BOTH representations the observability layer needs:

* exponential ``le`` buckets (Prometheus-style cumulative counts on
  export), for cheap aggregation across processes;
* the raw recorded samples (up to :data:`MAX_SAMPLES`), so ``p50/p95/p99``
  are *exact* — :func:`percentile` implements numpy's default
  linear-interpolation definition and is tested against
  ``numpy.percentile`` directly.

Metrics created with ``persistent=True`` survive :meth:`Registry.reset`
(the analogue of ``dispatch.totals`` vs ``dispatch.stats``): the library's
own instrumentation — dispatch routing counters, stage spans — is
persistent, so a test session can reset scratch metrics without
erasing the process-lifetime ledgers the routing/coverage gates assert on.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "exp_buckets", "percentile", "DEFAULT_LATENCY_BUCKETS",
           "MAX_SAMPLES"]

# Raw-sample cap per histogram: beyond this, new samples still update
# count/sum/min/max and the buckets, but are no longer stored verbatim
# (percentiles then interpolate within the stored prefix — flagged via
# ``samples_capped`` in snapshots so readers know they are approximate).
MAX_SAMPLES = 100_000

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def exp_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` exponential bucket upper bounds: ``start * factor**i``.
    The implicit ``+Inf`` overflow bucket is always appended on export."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"exp_buckets needs start > 0, factor > 1, count >= 1; got "
            f"start={start}, factor={factor}, count={count}")
    return tuple(start * factor ** i for i in range(count))


# 100us .. ~52s in doublings: covers a kernel launch on real hardware up
# to a cold-trace CPU-interpret search.
DEFAULT_LATENCY_BUCKETS = exp_buckets(1e-4, 2.0, 20)


def percentile(samples: Sequence[float], p: float) -> float:
    """Exact percentile of ``samples`` (numpy's default linear
    interpolation — ``numpy.percentile(samples, p)``)."""
    if not 0 <= p <= 100:
        raise ValueError(f"percentile p={p} out of range [0, 100]")
    s = sorted(samples)
    if not s:
        raise ValueError("percentile of an empty sample set")
    if len(s) == 1:
        return float(s[0])
    rank = (p / 100.0) * (len(s) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "labels", "persistent", "value")

    def __init__(self, name: str, labels: Dict[str, str],
                 persistent: bool = False):
        self.name = name
        self.labels = dict(labels)
        self.persistent = persistent
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} increment must be >= 0")
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "persistent", "value")

    def __init__(self, name: str, labels: Dict[str, str],
                 persistent: bool = False):
        self.name = name
        self.labels = dict(labels)
        self.persistent = persistent
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exponential-bucket histogram with exact raw-sample percentiles."""

    __slots__ = ("name", "labels", "persistent", "bounds", "bucket_counts",
                 "count", "sum", "min", "max", "samples")

    def __init__(self, name: str, labels: Dict[str, str],
                 buckets: Optional[Sequence[float]] = None,
                 persistent: bool = False):
        bounds = tuple(buckets) if buckets is not None \
            else DEFAULT_LATENCY_BUCKETS
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(
                f"histogram {name} bucket bounds must be strictly "
                f"increasing, got {bounds}")
        self.name = name
        self.labels = dict(labels)
        self.persistent = persistent
        self.bounds = bounds
        # non-cumulative per-bucket counts; [-1] is the +Inf overflow
        self.bucket_counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.samples: List[float] = []

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.bucket_counts[self._bucket(v)] += 1
        if len(self.samples) < MAX_SAMPLES:
            self.samples.append(v)

    def _bucket(self, v: float) -> int:
        # Prometheus ``le`` semantics: a sample equal to a bound belongs
        # to that bound's bucket (first i with v <= bounds[i]).
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    @property
    def samples_capped(self) -> bool:
        return self.count > len(self.samples)

    def percentile(self, p: float) -> float:
        return percentile(self.samples, p)

    def cumulative_counts(self) -> List[int]:
        """Prometheus cumulative bucket counts (last entry == count)."""
        out, acc = [], 0
        for c in self.bucket_counts:
            acc += c
            out.append(acc)
        return out


class Registry:
    """Get-or-create store of metrics keyed by (name, sorted labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, LabelKey], object] = {}

    def _get(self, kind: str, cls, name: str, labels: Dict[str, str],
             persistent: bool, **kwargs):
        key = (kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels, persistent=persistent, **kwargs)
                self._metrics[key] = m
            return m

    def counter(self, name: str, persistent: bool = False,
                **labels: str) -> Counter:
        return self._get("counter", Counter, name, labels, persistent)

    def gauge(self, name: str, persistent: bool = False,
              **labels: str) -> Gauge:
        return self._get("gauge", Gauge, name, labels, persistent)

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None,
                  persistent: bool = False, **labels: str) -> Histogram:
        h = self._get("histogram", Histogram, name, labels, persistent,
                      buckets=buckets)
        if buckets is not None and tuple(buckets) != h.bounds:
            raise ValueError(
                f"histogram {name}{labels} already exists with buckets "
                f"{h.bounds}, asked for {tuple(buckets)}")
        return h

    def counters(self) -> List[Counter]:
        return [m for (k, _, _), m in sorted(self._metrics.items())
                if k == "counter"]

    def gauges(self) -> List[Gauge]:
        return [m for (k, _, _), m in sorted(self._metrics.items())
                if k == "gauge"]

    def histograms(self) -> List[Histogram]:
        return [m for (k, _, _), m in sorted(self._metrics.items())
                if k == "histogram"]

    def reset(self, include_persistent: bool = False) -> None:
        """Drop metrics (scratch only by default — the process-lifetime
        instrumentation ledgers survive unless ``include_persistent``)."""
        with self._lock:
            if include_persistent:
                self._metrics.clear()
            else:
                self._metrics = {k: m for k, m in self._metrics.items()
                                 if m.persistent}


# The process-wide default registry every instrumented layer writes to.
REGISTRY = Registry()
