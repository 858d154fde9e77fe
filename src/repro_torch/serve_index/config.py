"""Serving-core configuration: coalescing, batching, admission control
(a copy of :mod:`repro.serve_index.config`: host-only, so the port keeps
its own).

One frozen dataclass holds every operational knob of the request
coalescer and the concurrent-ingest writer.  The knobs fix a *finite
family of launch shapes*: queries are only ever searched at the
``q_buckets`` batch sizes with a fixed ``(n_probe, topk)``, so a warmed
server launches the same kernels at the same shapes for arbitrary mixed
traffic (:func:`repro_torch.bench.warm_replay.warm_replay` checks it).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Tuple

__all__ = ["ServeConfig", "SHED_POLICIES"]

# Admission-control policies for the bounded write queue (see
# ``IndexServer``):
#
#   "shed_inserts"  full queue sheds inserts (Backpressure raised to the
#                   producer) but admits deletes with a blocking put —
#                   deletes free space, so under pressure the index should
#                   prefer shrinking over growing.  The default.
#   "shed_all"      full queue sheds inserts AND deletes.
#   "block"         nothing is shed; producers block until the writer
#                   drains the queue (pure backpressure).
SHED_POLICIES = ("shed_inserts", "shed_all", "block")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Operational knobs of :class:`repro_torch.serve_index.IndexServer`.

    ``n_probe`` / ``topk`` are fixed per server so every coalesced batch
    shares the same search plan; run two servers over one index if two
    serving contracts are needed.

    >>> cfg = ServeConfig(n_probe=4, topk=3)
    >>> cfg.bucket_for(5)
    8
    >>> cfg.max_batch
    64
    """

    n_probe: int = 4
    topk: int = 1
    # Queries arriving within this window of the batch's first request are
    # coalesced into one padded launch (0.0 = launch as soon as the
    # coalescer thread wakes; still batches truly concurrent arrivals).
    coalesce_window_s: float = 0.002
    # Allowed padded batch sizes, strictly increasing.  A request batch of
    # n queries launches at the smallest bucket >= n; requests larger than
    # the last bucket are split into max-bucket chunks at submit time.
    q_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    # Bounded write queue (admission control): max pending insert/delete/
    # maintenance operations before the shed policy engages.
    queue_bound: int = 256
    shed_policy: str = "shed_inserts"
    # Max write ops the writer drains per view publish: larger values
    # amortize snapshot swaps under ingest bursts, smaller values shrink
    # the window between an accepted write and its visibility to queries.
    apply_batch: int = 8

    def __post_init__(self):
        if self.n_probe < 1:
            raise ValueError(f"n_probe={self.n_probe} must be >= 1")
        if self.topk < 1:
            raise ValueError(f"topk={self.topk} must be >= 1")
        if self.coalesce_window_s < 0:
            raise ValueError(
                f"coalesce_window_s={self.coalesce_window_s} must be >= 0")
        if not self.q_buckets:
            raise ValueError("q_buckets must be non-empty")
        if any(b < 1 for b in self.q_buckets) or \
                list(self.q_buckets) != sorted(set(self.q_buckets)):
            raise ValueError(
                f"q_buckets={self.q_buckets} must be strictly increasing "
                "positive sizes")
        if self.queue_bound < 1:
            raise ValueError(
                f"queue_bound={self.queue_bound} must be >= 1")
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy={self.shed_policy!r} must be one of "
                f"{SHED_POLICIES}")
        if self.apply_batch < 1:
            raise ValueError(
                f"apply_batch={self.apply_batch} must be >= 1")

    @property
    def max_batch(self) -> int:
        """Largest allowed coalesced batch (the last bucket)."""
        return self.q_buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= ``n`` (``n`` must not exceed ``max_batch``)."""
        if not 1 <= n <= self.max_batch:
            raise ValueError(
                f"batch of {n} queries outside bucket range "
                f"[1, {self.max_batch}]")
        return self.q_buckets[bisect.bisect_left(self.q_buckets, n)]
