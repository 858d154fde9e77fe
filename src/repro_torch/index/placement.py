"""List-to-device placement for data-partitioned (list-sharded) search
(a copy of :mod:`repro.index.placement`, which is pure numpy).

The scale-out unit of the index is the *inverted list*: a list's rows are
always scanned together (the fine stage gathers ``max_list`` candidate
slots from one contiguous range), so a list is atomic — it lives wholly on
one device.  Placement is therefore a bin-packing problem: assign
``n_lists`` lists with known row counts to ``n_shards`` devices so the
heaviest device carries as little as possible.

:func:`plan_placement` uses the classic greedy LPT (longest processing
time) heuristic: lists in decreasing row count, each to the currently
lightest shard.  Its makespan guarantee is what the acceptance bound in
the memory accounting relies on: when the heaviest shard received its last
list it was the *lightest* shard, so its prior load was at most the
average — hence

    max shard load <= total_rows / n_shards + max_list_rows

i.e. per-device occupancy is the perfect split plus at most one list's
worth.  Placement is recomputed from live per-list occupancy whenever a
segment is (re)sealed — in particular at ``compact()`` — and persisted in
snapshots (format 3).
"""

from __future__ import annotations

import numpy as np

__all__ = ["plan_placement", "placement_loads"]


def plan_placement(list_counts: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy occupancy-aware bin-pack: ``(n_lists,)`` row counts ->
    ``(n_lists,)`` int32 shard ids in ``[0, n_shards)``.

    Deterministic: lists are processed in decreasing count (ties by list
    id) and land on the lowest-id lightest shard, so the same occupancy
    vector always yields the same placement — snapshots restore to the
    exact layout they were written with.
    """
    counts = np.asarray(list_counts, np.int64)
    if counts.ndim != 1:
        raise ValueError(f"list_counts must be 1-D, got {counts.shape}")
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    placement = np.zeros(counts.shape[0], np.int32)
    if n_shards == 1:
        return placement
    loads = np.zeros(n_shards, np.int64)
    # np.lexsort: last key is primary -> decreasing count, ties by list id
    for l in np.lexsort((np.arange(counts.shape[0]), -counts)):
        s = int(np.argmin(loads))          # lowest id wins ties
        placement[l] = s
        loads[s] += counts[l]
    return placement


def placement_loads(placement: np.ndarray, list_counts: np.ndarray,
                    n_shards: int) -> np.ndarray:
    """Per-shard row totals ``(n_shards,)`` implied by a placement."""
    return np.bincount(np.asarray(placement),
                       weights=np.asarray(list_counts, np.float64),
                       minlength=n_shards).astype(np.int64)
