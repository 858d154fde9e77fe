"""Streaming segmented IVF-PQDTW index — the lifecycle layer (counterpart
of :mod:`repro.index`).

    insert   -> fresh series land in a fixed-capacity exact "hot" segment
                (searched with the exact LB cascade through
                ``core.lb_search``)
    flush    -> a full hot segment is *sealed*: PQ-encoded against the
                shared codebook and laid out as an inverted-list shard
    delete   -> tombstone masks in hot and sealed segments
    compact  -> sealed segments merge into one shard (dead rows dropped,
                inverted lists re-balanced)
    snapshot -> atomic tmp-dir/fsync/rename persistence in the reference's
                format 3; restores formats 1-3, written by either package

Search fans a query batch out over the hot segment and every sealed
segment and merges the per-shard top-k.  :func:`search_sharded`
(``planner.py``) runs the reference's partition plans (``"queries"``,
``"lists"``, ``"auto"``) on one card, its mesh a count of devices whose
work runs in turn.
"""

from .placement import placement_loads, plan_placement
from .planner import search_sharded
from .segments import HotBuffer, SealedSegment
from .streaming import IndexConfig, StreamingIndex
from .snapshot import latest_snapshot, restore_snapshot, save_snapshot

__all__ = [
    "HotBuffer", "SealedSegment",
    "IndexConfig", "StreamingIndex",
    "plan_placement", "placement_loads",
    "save_snapshot", "restore_snapshot", "latest_snapshot",
    "search_sharded",
]
