"""Segment containers for the streaming index (counterpart of
:mod:`repro.index.segments`).

* :class:`HotBuffer` — host-side fixed-capacity staging area for raw
  series (numpy; a copy of the reference's).  The search path uploads the
  buffers once per mutation and scans every live row exactly.
* :class:`SealedSegment` — an immutable device-resident inverted-list
  shard of PQ codes sharing the index-wide codebook.  Every flush-born
  segment is padded to the same width.

Partitioned layout (``n_shards > 1``): rows are ordered *shard-major* —
all lists placed on shard 0 (list-sorted), padding to ``shard_cap``, then
shard 1's lists, and so on — so shard ``s`` owns exactly the contiguous
row block ``[s * shard_cap, (s + 1) * shard_cap)``.  A list lives wholly
on one shard (:mod:`repro_torch.index.placement`), so every inverted list
stays a contiguous run.  ``n_shards == 1`` is the plain list-sorted
layout.

Row padding convention: dead rows carry ``ids == -1``, ``live == False``
and ``assign == n_lists`` (sorted past every real list, so no inverted
list ever addresses them — the ``live`` mask is a second line of defense).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _device
from ..core.ivf import build_lists
from .placement import placement_loads, plan_placement

__all__ = ["HotBuffer", "SealedSegment", "seal"]


@dataclasses.dataclass(frozen=True)
class SealedSegment:
    codes: torch.Tensor       # (n_shards*shard_cap, M) int32, shard-major
    ids: torch.Tensor         # (rows,) int32 external ids, -1 = padding
    live: torch.Tensor        # (rows,) bool, False = deleted or padding
    assign: torch.Tensor      # (rows,) int32 coarse list id, n_lists = pad
    list_start: torch.Tensor  # (n_lists,) int32
    list_len: torch.Tensor    # (n_lists,) int32
    placement: torch.Tensor   # (n_lists,) int32 shard id of each list
    max_list: int             # candidate width of the fine stage
    n_shards: int             # data-partition count of the layout
    shard_cap: int            # padded rows per shard block

    @property
    def rows(self) -> int:
        return self.codes.shape[0]

    @property
    def n_lists(self) -> int:
        return self.list_start.shape[0]

    def n_live(self) -> int:
        return int(self.live.sum())

    def tombstone(self, dead: np.ndarray) -> "SealedSegment":
        """New segment with ``dead`` (host bool mask over rows) deleted."""
        dead = torch.from_numpy(np.asarray(dead, bool)).to(self.live.device)
        return dataclasses.replace(self, live=self.live & ~dead)

    def shard_views(self) -> Tuple[torch.Tensor, ...]:
        """Per-shard blocks for the list-sharded planner.

        Returns ``(codes (n_shards, shard_cap, M), ids, live (n_shards,
        shard_cap), loc_start, loc_len (n_shards, n_lists))``, where the
        local list tables address rows *within* a shard block (lists placed
        elsewhere have length 0): block ``s`` holds exactly the lists placed
        on shard ``s``.
        """
        n, cap = self.n_shards, self.shard_cap
        M = self.codes.shape[1]
        sh = torch.arange(n, dtype=torch.int32,
                          device=self.codes.device)[:, None]
        own = self.placement[None, :] == sh
        loc_start = torch.where(own, self.list_start[None, :] - sh * cap,
                                0).to(torch.int32)
        loc_len = torch.where(own, self.list_len[None, :], 0).to(torch.int32)
        return (self.codes.reshape(n, cap, M), self.ids.reshape(n, cap),
                self.live.reshape(n, cap), loc_start, loc_len)


def seal(codes: np.ndarray, ids: np.ndarray, assign: np.ndarray,
         n_lists: int, rows: int, max_list: Optional[int] = None, *,
         n_shards: int = 1, shard_round: int = 1,
         device: _device.DeviceArg = None) -> SealedSegment:
    """Lay ``(n, M)`` codes out as a shard-major list-sorted segment, built
    on the host (numpy) and placed on ``device``.

    ``rows`` is the minimum total padded size (flush-born segments pass
    the hot capacity, so every flush-born segment has one shape); with
    ``n_shards > 1`` the total grows to ``n_shards * shard_cap`` where
    ``shard_cap`` covers the heaviest shard of a fresh occupancy-aware
    placement (:func:`plan_placement`), rounded up to a multiple of
    ``shard_round`` — flush callers round to ``ceil(rows / n_shards)``,
    compaction keeps the exact (tightest) width.

    ``max_list`` is the fine stage's candidate width; it defaults to the
    true longest list.  Flush-born segments pass ``rows == max_list ==
    hot capacity`` instead (one width for every segment regardless of list
    skew); compaction takes the default so the merged shard prunes with
    its true longest list.
    """
    n = len(ids)
    if n > rows:
        raise ValueError(f"cannot seal {n} rows into a {rows}-row segment")
    if shard_round < 1:
        raise ValueError(f"shard_round={shard_round} must be >= 1")
    order, start0, length, true_max = build_lists(assign, n_lists)
    if max_list is None:
        max_list = true_max
    placement = plan_placement(length, n_shards)
    loads = placement_loads(placement, length, n_shards)
    base = -(-rows // n_shards) if rows else 1
    shard_cap = max(1, base,
                    -(-int(max(loads.max(initial=0), 1)) // shard_round)
                    * shard_round)
    total = n_shards * shard_cap

    # Exclusive running offset of each list inside the shard-major layout:
    # lists grouped by (shard, list id), each shard block based at
    # s * shard_cap.
    ordL = np.lexsort((np.arange(n_lists), placement))
    lens = length[ordL].astype(np.int64)
    shard_of = placement[ordL]
    run = np.cumsum(lens) - lens                     # grouped exclusive sum
    first = np.searchsorted(shard_of, np.arange(n_shards))
    shard_base = np.where(first < n_lists, run[np.minimum(first,
                                                          n_lists - 1)], 0)
    new_start = np.empty(n_lists, np.int64)
    new_start[ordL] = (run - shard_base[shard_of]
                       + shard_of.astype(np.int64) * shard_cap)
    new_start = new_start.astype(np.int32)

    M = codes.shape[1]
    codes_p = np.zeros((total, M), np.int32)
    ids_p = np.full((total,), -1, np.int32)
    live_p = np.zeros((total,), bool)
    assign_p = np.full((total,), n_lists, np.int32)
    if n:
        sorted_assign = np.asarray(assign)[order]
        dest = new_start[sorted_assign] + (np.arange(n, dtype=np.int64)
                                           - start0[sorted_assign])
        codes_p[dest] = codes[order]
        ids_p[dest] = ids[order]
        live_p[dest] = True
        assign_p[dest] = sorted_assign
    dev = _device.resolve_device(device)
    return SealedSegment(
        codes=torch.from_numpy(codes_p).to(dev),
        ids=torch.from_numpy(ids_p).to(dev),
        live=torch.from_numpy(live_p).to(dev),
        assign=torch.from_numpy(assign_p).to(dev),
        list_start=torch.from_numpy(new_start).to(dev),
        list_len=torch.from_numpy(length).to(dev),
        placement=torch.from_numpy(placement).to(dev),
        max_list=int(max_list), n_shards=int(n_shards),
        shard_cap=int(shard_cap))


class HotBuffer:
    """Fixed-capacity staging buffer for raw series (host-side, mutable)."""

    def __init__(self, capacity: int, dim: int):
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.data = np.zeros((capacity, dim), np.float32)
        self.ids = np.full((capacity,), -1, np.int32)
        self.live = np.zeros((capacity,), bool)
        self.count = 0                      # filled slots (live or dead)

    @property
    def space(self) -> int:
        return self.capacity - self.count

    def n_live(self) -> int:
        return int(self.live.sum())

    def append(self, X: np.ndarray, ids: np.ndarray) -> int:
        """Write up to ``space`` rows; returns how many were taken."""
        take = min(self.space, len(ids))
        if take:
            lo = self.count
            self.data[lo:lo + take] = X[:take]
            self.ids[lo:lo + take] = ids[:take]
            self.live[lo:lo + take] = True
            self.count += take
        return take

    def tombstone(self, dead_ids: np.ndarray) -> int:
        hit = np.isin(self.ids, dead_ids) & self.live
        self.live &= ~hit
        return int(hit.sum())

    def take_live(self) -> Tuple[np.ndarray, np.ndarray]:
        """Drain: return (live rows, their ids) and reset the buffer."""
        rows = self.data[self.live].copy()
        ids = self.ids[self.live].copy()
        self.ids[:] = -1
        self.live[:] = False
        self.count = 0
        return rows, ids
