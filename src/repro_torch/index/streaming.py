"""StreamingIndex — LSM-style lifecycle over IVF-PQDTW shards (counterpart
of :mod:`repro.index.streaming`).

Write path (host-side, numpy): ``insert`` fills the fixed-capacity
:class:`~repro_torch.index.segments.HotBuffer`; a full buffer auto-
``flush``\\ es into a :class:`~repro_torch.index.segments.SealedSegment` —
PQ codes against the *shared* codebook, list-sorted under the *shared*
coarse quantizer.  Both quantizers are trained once (``bootstrap``) and
never change afterwards, which is what makes segments mergeable:
``compact`` concatenates live rows and re-balances the inverted lists
without touching a single code.

Read path (on the index's device): one coarse launch + one query-LUT
launch per subspace for the whole batch (shared by every segment), a
per-segment fine stage (:func:`repro_torch.core.ivf.fine_rank_batch`)
and an exact LB-cascade filter-and-refine scan of the hot buffer
(:func:`repro_torch.core.lb_search.filtered_topk`, the ``lb_refine``
kernel on the card), merged with a final stable top-k.  Tombstones are
masks, not re-layouts.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _device, obs
from ..core.dtw import euclidean_sq
from ..core.ivf import (TwoLevelCoarse, build_two_level, coarse_assign,
                        coarse_dists, fine_rank_batch, two_level_from_numpy,
                        validate_codebook, validate_n_probe)
from ..core.kmeans import dba_kmeans
from ..core.lb_search import filtered_topk
from ..core.measures import sqrt_rn
from ..core.pq import (PQCodebook, PQConfig, codebook_from_numpy, encode,
                       fit, memory_cost, query_lut_batch, segment)
from ..core.topk import smallest_k
from .segments import HotBuffer, SealedSegment, seal

__all__ = ["IndexConfig", "StreamingIndex", "search_impl"]

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Lifecycle hyper-parameters around a :class:`PQConfig` (the
    reference's fields, so a snapshot's config restores in either package).

    ``n_shards`` is the data-partition count of the sealed layout
    (:func:`repro_torch.index.planner.search_sharded` with
    ``partition="lists"`` walks one shard block at a time; ``n_shards ==
    1`` is the plain layout).  ``n_top_lists > 0`` enables the
    hierarchical (two-level) coarse quantizer with an ``n_probe_top``
    fan-out.

    ``band="adaptive"`` switches the hot-buffer elastic scan to per-pair
    alignment corridors (:mod:`repro_torch.core.corridor`): narrower
    registers, documented *approximate* results (each refined distance is
    an upper bound of the static one, equal where the corridor holds the
    optimal path); the certified-exact LB cascade applies to the default
    ``"static"`` band only.

    >>> cfg = IndexConfig(PQConfig(n_sub=2, codebook_size=4), n_lists=4)
    >>> cfg.coarse_window(48)
    5
    >>> IndexConfig(PQConfig(), n_lists=4, n_probe_top=2)
    Traceback (most recent call last):
        ...
    ValueError: n_probe_top=2 requires a two-level coarse quantizer (set n_top_lists > 0)
    """
    pq: PQConfig
    n_lists: int = 8
    hot_capacity: int = 128
    coarse_iters: int = 8
    coarse_window_frac: float = 0.1
    n_shards: int = 1
    n_top_lists: int = 0
    n_probe_top: int = 0
    band: str = "static"

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards={self.n_shards} must be >= 1")
        if self.band not in ("static", "adaptive"):
            raise ValueError(f"band={self.band!r} must be 'static' or "
                             f"'adaptive'")
        if self.n_top_lists:
            if not 1 <= self.n_top_lists <= self.n_lists:
                raise ValueError(
                    f"n_top_lists={self.n_top_lists} out of range: must "
                    f"satisfy 1 <= n_top_lists <= n_lists={self.n_lists}")
            if not 1 <= self.n_probe_top <= self.n_top_lists:
                raise ValueError(
                    f"n_probe_top={self.n_probe_top} out of range: must "
                    f"satisfy 1 <= n_probe_top <= n_top_lists="
                    f"{self.n_top_lists}")
        elif self.n_probe_top:
            raise ValueError(
                f"n_probe_top={self.n_probe_top} requires a two-level "
                f"coarse quantizer (set n_top_lists > 0)")

    def coarse_window(self, D: int) -> int:
        return max(1, int(round(self.coarse_window_frac * D)))


# ---------------------------------------------------------------------------
# Search math
# ---------------------------------------------------------------------------

def _scan_hot(data, ids, live, Q, q_valid=None, *, window: int, k: int,
              euclidean: bool, measure=None, with_stats: bool = False,
              band: str = "static"):
    """Exact scan of the hot buffer -> ``(Nq, k)`` distances, ids.

    The configured elastic measure (through the LB-cascade
    filter-and-refine top-k, whose dense fallback covers measures without
    pruning capability), or Euclidean under the PQ_ED baseline — the
    metric the sealed segments' LUTs encode, in sqrt space, so the merge
    is order-compatible.  ``q_valid (Nq,)`` masks padding queries (a
    coalesced or sharded batch): their rows come back ``inf`` / ``-1``
    and claim no refine work.  ``with_stats`` adds the cascade's
    telemetry.
    """
    if euclidean:
        dh = sqrt_rn(torch.clamp(euclidean_sq(Q, data), min=0.0))
        dh = torch.where(live[None, :], dh, _INF)
        if q_valid is not None:
            dh = torch.where(q_valid[:, None], dh, _INF)
        dk, idx = smallest_k(dh, k)
        out_ids = torch.where(torch.isfinite(dk), ids[idx],
                              torch.full_like(idx, -1, dtype=ids.dtype))
        if with_stats:
            # no elastic cascade under the PQ_ED baseline: an empty
            # telemetry record rather than a fake 0% pruning rate
            zero = torch.zeros((), dtype=torch.int64, device=Q.device)
            return dk, out_ids, {"n_bounded": zero, "n_refined": zero,
                                 "n_waves": zero,
                                 "refined_per_wave": zero[None]}
        return dk, out_ids
    d2, idx, st = filtered_topk(Q, data, window, k, valid=live,
                                measure=measure, q_valid=q_valid,
                                with_stats=with_stats, band=band)
    dh = sqrt_rn(torch.clamp(d2, min=0.0))
    idx = idx.long()
    out_ids = torch.where(idx >= 0, ids[idx.clamp(min=0)],
                          torch.full_like(idx, -1, dtype=ids.dtype))
    if with_stats:
        return dh, out_ids, st
    return dh, out_ids


def _merge_topk(parts_d, parts_i, *, topk: int):
    all_d = torch.cat(parts_d, dim=1)
    all_i = torch.cat(parts_i, dim=1)
    missing = topk - all_d.shape[1]
    if missing > 0:
        Nq = all_d.shape[0]
        all_d = torch.cat([all_d, all_d.new_full((Nq, missing), _INF)], 1)
        all_i = torch.cat([all_i, all_i.new_full((Nq, missing), -1)], 1)
    dk, best = smallest_k(all_d, topk)
    return dk, torch.gather(all_i, 1, best)


def _probe_tables(Q: torch.Tensor, coarse: torch.Tensor, cb: PQCodebook,
                  icfg: IndexConfig, dim: int,
                  two_level: Optional[TwoLevelCoarse] = None, *,
                  span: str = "index.search"):
    """The stages every sealed block of a search shares: coarse distances
    ``(Nq, n_lists)`` and per-query PQ tables ``(Nq, M, K)``, each in its
    ``{span}.coarse`` / ``{span}.lut`` span."""
    spec = icfg.pq.measure()
    with obs.span(f"{span}.coarse") as sp:
        dc = sp.fence(coarse_dists(
            Q, coarse, icfg.coarse_window(dim), measure=spec,
            two_level=two_level,
            n_probe_top=icfg.n_probe_top if two_level is not None
            else None))
    with obs.span(f"{span}.lut") as sp:
        qluts = sp.fence(query_lut_batch(
            segment(Q, icfg.pq), cb, icfg.pq.window(dim),
            not icfg.pq.is_elastic, spec))
    return dc, qluts


def _rank_blocks(blocks, dc: torch.Tensor, qluts: torch.Tensor, *,
                 n_probe: int, topk: int):
    """Fine-rank each sealed block ``(codes, ids, live, list_start,
    list_len, max_list)`` -> the lists of per-block ``(Nq, k)`` distances
    and ids."""
    parts_d, parts_i = [], []
    for codes, ids, live, start, length, max_list in blocks:
        k = min(topk, n_probe * max_list)
        if k < 1:
            continue
        d, i = fine_rank_batch(codes, ids, start, length, max_list, dc,
                               qluts, n_probe, k, live=live)
        parts_d.append(d)
        parts_i.append(i)
    return parts_d, parts_i


def _segment_blocks(segs: Tuple[SealedSegment, ...]):
    return ((sg.codes, sg.ids, sg.live, sg.list_start, sg.list_len,
             sg.max_list) for sg in segs)


def _hot_topk(hot, Q: torch.Tensor, q_valid, *, icfg: IndexConfig,
              dim: int, topk: int, with_stats: bool = False):
    """:func:`_scan_hot` over ``hot = (data, ids, live)`` under the
    index's configuration (the coarse window, its measure and band)."""
    data, ids, live = hot
    return _scan_hot(data, ids, live, Q, q_valid,
                     window=icfg.coarse_window(dim),
                     k=min(topk, data.shape[0]),
                     euclidean=not icfg.pq.is_elastic,
                     measure=icfg.pq.measure(), with_stats=with_stats,
                     band=icfg.band)


def _empty_topk(Nq: int, topk: int, device):
    return (torch.full((Nq, topk), _INF, device=device),
            torch.full((Nq, topk), -1, dtype=torch.int32, device=device))


def search_impl(coarse: torch.Tensor, cb: PQCodebook,
                segs: Tuple[SealedSegment, ...],
                hot: Optional[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]],
                Q: torch.Tensor, *, icfg: IndexConfig, n_probe: int,
                topk: int, dim: int,
                two_level: Optional[TwoLevelCoarse] = None,
                q_valid: Optional[torch.Tensor] = None,
                with_stats: bool = False):
    """Fan ``Q (Nq, D)`` out over every segment and merge top-k.

    ``segs`` is a (possibly empty) tuple of sealed segments; ``hot`` is
    ``(data (cap, D), ids (cap,), live (cap,))`` or None when the buffer is
    empty.  Returns ``(distances, ids)`` of shape ``(Nq, topk)``, ``inf``
    / ``-1`` where fewer than ``topk`` live rows exist.  Sealed rows are
    ranked by asymmetric PQDTW, hot rows by exact banded DTW (at the
    coarse window), both in sqrt space.  ``q_valid (Nq,)`` marks padding
    rows of a coalesced or sharded batch: they come back ``inf`` / ``-1``
    (the reference leaves them arbitrary; callers slice them off), claim
    no refine work in the hot scan and add nothing to its statistics.
    ``with_stats=True`` returns a third item, the hot scan's cascade
    telemetry (``None`` without a hot buffer).

    The stages run inside :func:`repro_torch.obs.span` blocks (coarse,
    lut, fine, hot, merge), fenced with a device sync only while obs is
    enabled.
    """
    Q = Q.to(torch.float32)
    parts_d, parts_i = [], []
    hot_stats = None

    if segs:
        dc, qluts = _probe_tables(Q, coarse, cb, icfg, dim, two_level)
        with obs.span("index.search.fine") as sp:
            parts_d, parts_i = _rank_blocks(_segment_blocks(segs), dc,
                                            qluts, n_probe=n_probe,
                                            topk=topk)
            sp.fence(parts_d)

    if hot is not None:
        with obs.span("index.search.hot") as sp:
            out = _hot_topk(hot, Q, q_valid, icfg=icfg, dim=dim, topk=topk,
                            with_stats=with_stats)
            if with_stats:
                d, i, hot_stats = out
            else:
                d, i = out
            sp.fence((d, i))
        parts_d.append(d)
        parts_i.append(i)

    if not parts_d:
        empty = _empty_topk(Q.shape[0], topk, Q.device)
        return empty + (None,) if with_stats else empty

    with obs.span("index.search.merge") as sp:
        d, i = _merge_topk(parts_d, parts_i, topk=topk)
        if q_valid is not None:
            d = torch.where(q_valid[:, None], d, _INF)
            i = torch.where(q_valid[:, None], i, torch.full_like(i, -1))
        sp.fence((d, i))
    if with_stats:
        return d, i, hot_stats
    return d, i


# ---------------------------------------------------------------------------
# The lifecycle object
# ---------------------------------------------------------------------------

class StreamingIndex:
    """Incrementally maintained IVF-PQDTW index (see module docstring) on
    one device (``cuda`` unless the caller passes ``device="cpu"``).

    Construct with :meth:`bootstrap` (trains the shared quantizers on a
    sample) or :meth:`from_parts` (pre-trained quantizers, e.g. carried in
    from the JAX package as numpy; the restore path).

    >>> import numpy as np
    >>> from repro_torch.core.pq import PQConfig
    >>> cfg = IndexConfig(
    ...     PQConfig(n_sub=2, codebook_size=4, use_prealign=False,
    ...              kmeans_iters=1, dba_iters=1),
    ...     n_lists=2, hot_capacity=4, coarse_iters=2)
    >>> X = np.sin(np.arange(12 * 16, dtype=np.float32)).reshape(12, 16)
    >>> idx = StreamingIndex.bootstrap(torch.Generator().manual_seed(0), X,
    ...                                cfg, device="cpu")
    >>> ids = idx.insert(X[:6])            # fills hot_capacity=4 -> 1 seal
    >>> [int(i) for i in ids[:3]], len(idx.segments)
    ([0, 1, 2], 1)
    >>> idx.delete([1])                    # tombstone by external id
    1
    >>> dist, out = idx.search(X[:2], n_probe=2, topk=1)
    >>> tuple(out.shape), bool(torch.isfinite(dist).all())
    ((2, 1), True)
    >>> idx.flush(); idx.compact()         # seal the tail, drop dead rows
    >>> len(idx.segments), idx.n_live()
    (1, 5)
    """

    def __init__(self, cfg: IndexConfig, coarse, cb: PQCodebook, dim: int,
                 two_level: Optional[TwoLevelCoarse] = None, *,
                 device: _device.DeviceArg = None):
        dev = _device.resolve_device(device)
        coarse = _device.to_tensor(coarse, dev, torch.float32)
        if coarse.shape[0] != cfg.n_lists:
            raise ValueError(
                f"coarse quantizer has {coarse.shape[0]} centroids, "
                f"config says n_lists={cfg.n_lists}")
        if cfg.hot_capacity < 1:
            raise ValueError(
                f"hot_capacity={cfg.hot_capacity} must be >= 1 (inserts "
                f"stage in the hot buffer before sealing)")
        cb = codebook_from_numpy(cb, dev)
        # every seal re-encodes through the prealign geometry, so a drifted
        # config would write segments of the wrong length
        validate_codebook(cb, cfg.pq, int(dim))
        self.cfg = cfg
        self.device = dev
        self.coarse = coarse
        self.cb = cb
        self.dim = int(dim)
        # hierarchical coarse quantizer: derived deterministically (a fixed
        # seed) from the frozen coarse centroids when the config asks for
        # one, unless a pre-built table is handed in (the restore path)
        if two_level is None and cfg.n_top_lists:
            two_level = build_two_level(
                torch.Generator().manual_seed(0), self.coarse,
                cfg.n_top_lists, cfg.coarse_window(self.dim),
                measure=cfg.pq.measure(), iters=cfg.coarse_iters)
        elif two_level is not None:
            two_level = two_level_from_numpy(two_level, dev)
        self.two_level = two_level
        self.hot = HotBuffer(cfg.hot_capacity, dim)
        self.segments: List[SealedSegment] = []
        # host-side mirrors of each segment's id array (immutable) and live
        # mask (updated alongside tombstone()), so the delete/accounting
        # paths never read the device
        self._seg_ids: List[np.ndarray] = []
        self._seg_live: List[np.ndarray] = []
        # every id physically resident anywhere (tombstoned rows included —
        # they occupy slots until flush/compact drops them)
        self._resident: set = set()
        # device copy of the hot buffer, rebuilt only after a mutation
        self._hot_device: Optional[Tuple] = None
        self.next_id = 0

    # -- construction -------------------------------------------------------

    @classmethod
    def bootstrap(cls, generator: Optional[torch.Generator], X_train,
                  cfg: IndexConfig, *,
                  device: _device.DeviceArg = None) -> "StreamingIndex":
        """Train the shared coarse + PQ quantizers on ``X_train`` (initial
        centroids drawn with ``generator``, coarse first) and return an
        *empty* index (the sample is not inserted)."""
        dev = _device.resolve_device(device)
        X_train = _device.to_tensor(X_train, dev, torch.float32)
        D = X_train.shape[-1]
        res = dba_kmeans(X_train, cfg.n_lists, iters=cfg.coarse_iters,
                         dba_iters=1, window=cfg.coarse_window(D),
                         measure=cfg.pq.measure(), generator=generator)
        cb = fit(X_train, cfg.pq, generator, device=dev)
        return cls(cfg, res.centroids, cb, D, device=dev)

    @classmethod
    def from_parts(cls, cfg: IndexConfig, coarse, cb, dim: int,
                   two_level=None, *,
                   device: _device.DeviceArg = None) -> "StreamingIndex":
        """An empty index around pre-trained quantizers: ``coarse`` and the
        codebook's and ``two_level``'s arrays as numpy or tensors (the
        reference's ``PQCodebook`` / ``TwoLevelCoarse`` carry across)."""
        return cls(cfg, coarse, cb, dim, two_level=two_level, device=device)

    # -- write path ---------------------------------------------------------

    def insert(self, X, ids: Optional[Sequence[int]] = None) -> np.ndarray:
        """Add series ``X (n, D)``; returns their external ids.  Flushes
        automatically whenever the hot buffer fills."""
        X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] != self.dim:
            raise ValueError(
                f"expected (n, {self.dim}) series, got {X.shape}")
        n = X.shape[0]
        if ids is None:
            out = np.arange(self.next_id, self.next_id + n, dtype=np.int32)
            self.next_id += n
        else:
            out = np.asarray(ids, np.int32)
            if len(out) != n:
                raise ValueError(f"{n} series but {len(out)} ids")
            if n and int(out.min()) < 0:
                raise ValueError(
                    "external ids must be >= 0 (-1 is the reserved "
                    "empty-slot / no-result sentinel)")
            if len(np.unique(out)) != n:
                raise ValueError("duplicate ids within one insert batch")
            clash = self._resident.intersection(out.tolist())
            if clash:
                raise ValueError(
                    f"ids already resident in the index: "
                    f"{sorted(clash)[:8]}")
            self.next_id = max(self.next_id, int(out.max(initial=-1)) + 1)
        self._resident.update(out.tolist())
        self._hot_device = None
        with obs.span("index.insert"):
            i = 0
            while i < n:
                i += self.hot.append(X[i:], out[i:])
                if self.hot.space == 0:
                    self.flush()
        if obs.enabled():
            obs.counter("index_inserted_total", persistent=True).inc(n)
            self._update_obs_gauges()
        return out

    def delete(self, ids: Sequence[int]) -> int:
        """Tombstone by external id; returns how many rows were hit."""
        dead = np.asarray(ids, np.int32)
        hit = self.hot.tombstone(dead)
        if hit:
            self._hot_device = None
        for s, sg in enumerate(self.segments):
            mask = np.isin(self._seg_ids[s], dead) & self._seg_live[s]
            if mask.any():
                self.segments[s] = sg.tombstone(mask)
                self._seg_live[s] = self._seg_live[s] & ~mask
                hit += int(mask.sum())
        if obs.enabled():
            obs.counter("index_deleted_total", persistent=True).inc(hit)
            self._update_obs_gauges()
        return hit

    def flush(self) -> None:
        """Seal the hot buffer's live rows into a new sealed segment."""
        with obs.span("index.flush"):
            dropped = self.hot.ids[(self.hot.ids >= 0) & ~self.hot.live]
            rows, ids = self.hot.take_live()
            self._resident.difference_update(dropped.tolist())
            self._hot_device = None
            if len(ids) == 0:
                return
            Xd = torch.from_numpy(rows).to(self.device)
            codes = encode(Xd, self.cb, self.cfg.pq,
                           device=self.device).cpu().numpy()
            assign = coarse_assign(
                Xd, self.coarse, self.cfg.coarse_window(self.dim),
                self.cfg.pq.measure()).cpu().numpy()
            cap = self.cfg.hot_capacity
            # shard_round = ceil(cap / n_shards): every flush-born segment
            # gets the same shard_cap regardless of list skew
            self._add_segment(seal(codes, ids, assign, self.cfg.n_lists,
                                   rows=cap, max_list=cap,
                                   n_shards=self.cfg.n_shards,
                                   shard_round=-(-cap // self.cfg.n_shards),
                                   device=self.device))
        if obs.enabled():
            obs.counter("index_sealed_rows_total",
                        persistent=True).inc(len(ids))
            self._update_obs_gauges()

    def compact(self) -> None:
        """Merge every sealed segment into one: tombstoned and padding rows
        are dropped, inverted lists re-balanced, and the fine stage's
        candidate width shrinks from the flush-time worst case back to the
        true longest merged list."""
        if not self.segments:
            return
        with obs.span("index.compact"):
            codes, ids, assign = [], [], []
            for s, sg in enumerate(self.segments):
                live = self._seg_live[s]
                dead = self._seg_ids[s][~live]
                self._resident.difference_update(dead[dead >= 0].tolist())
                codes.append(sg.codes.cpu().numpy()[live])
                ids.append(self._seg_ids[s][live])
                assign.append(sg.assign.cpu().numpy()[live])
            codes = np.concatenate(codes)
            ids = np.concatenate(ids)
            assign = np.concatenate(assign)
            self.segments, self._seg_ids, self._seg_live = [], [], []
            if len(ids):
                self._add_segment(seal(codes, ids, assign, self.cfg.n_lists,
                                       rows=len(ids),
                                       n_shards=self.cfg.n_shards,
                                       device=self.device))
        if obs.enabled():
            obs.counter("index_compactions_total", persistent=True).inc()
            self._update_obs_gauges()

    # -- read path ----------------------------------------------------------

    def search(self, Q, *, n_probe: int, topk: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-``topk`` live neighbors of ``Q (Nq, D)`` -> ``(dist, ids)``
        tensors on the index's device.

        With obs enabled (:func:`repro_torch.obs.enabled`) the search runs
        under stage spans and records the LB-cascade pruning telemetry
        (reading it is a deliberate device sync); the disabled path never
        asks for the telemetry, and its results are identical.
        """
        Q = self._validate(Q, n_probe, topk)
        if not obs.enabled():
            return search_impl(self.coarse, self.cb, tuple(self.segments),
                               self._hot_arrays(), Q,
                               icfg=self.cfg, n_probe=n_probe, topk=topk,
                               dim=self.dim, two_level=self.two_level)
        with obs.span("index.search") as sp:
            d, ids, hot_stats = search_impl(
                self.coarse, self.cb, tuple(self.segments),
                self._hot_arrays(), Q, icfg=self.cfg, n_probe=n_probe,
                topk=topk, dim=self.dim, two_level=self.two_level,
                with_stats=True)
            sp.fence((d, ids))
        self._record_search_obs(Q.shape[0], hot_stats)
        return d, ids

    def _record_search_obs(self, n_queries: int, hot_stats) -> None:
        """Feed one search's counters into the obs registry (obs on)."""
        obs.counter("index_searches_total", persistent=True).inc()
        obs.counter("index_queries_total",
                    persistent=True).inc(int(n_queries))
        if hot_stats is not None:
            bounded = int(hot_stats["n_bounded"])
            refined = int(hot_stats["n_refined"])
            if bounded:
                obs.counter("lb_candidates_bounded_total",
                            persistent=True).inc(bounded)
                obs.counter("lb_candidates_refined_total",
                            persistent=True).inc(refined)
                obs.counter("lb_candidates_pruned_total",
                            persistent=True).inc(bounded - refined)
                obs.counter("lb_refine_waves_total", persistent=True).inc(
                    int(hot_stats["n_waves"]))
                obs.histogram("lb_pruning_rate",
                              buckets=tuple(i / 10 for i in range(1, 11)),
                              persistent=True).record(
                    1.0 - refined / bounded)
        self._update_obs_gauges()

    def _update_obs_gauges(self) -> None:
        """Refresh the lifecycle gauges (host-side mirrors only)."""
        cap = self.cfg.hot_capacity
        obs.gauge("hot_fill", persistent=True).set(self.hot.count)
        obs.gauge("hot_occupancy", persistent=True).set(
            self.hot.count / cap)
        obs.gauge("n_segments", persistent=True).set(self.n_segments)
        sealed_resident = sum(int((ids >= 0).sum())
                              for ids in self._seg_ids)
        sealed_live = sum(int(live.sum()) for live in self._seg_live)
        resident = sealed_resident + self.hot.count
        live = sealed_live + self.hot.n_live()
        obs.gauge("tombstone_fraction", persistent=True).set(
            (resident - live) / resident if resident else 0.0)

    def _validate(self, Q, n_probe: int, topk: int) -> torch.Tensor:
        Q = _device.to_tensor(Q, self.device, torch.float32)
        if Q.dim() != 2 or Q.shape[1] != self.dim:
            raise ValueError(
                f"expected (n, {self.dim}) queries, got {tuple(Q.shape)}")
        validate_n_probe(n_probe, self.cfg.n_lists)
        if topk < 1:
            raise ValueError(f"topk={topk} must be >= 1")
        return Q

    def _add_segment(self, seg: SealedSegment,
                     host_ids: Optional[np.ndarray] = None,
                     host_live: Optional[np.ndarray] = None) -> None:
        self.segments.append(seg)
        self._seg_ids.append(seg.ids.cpu().numpy() if host_ids is None
                             else np.asarray(host_ids))
        self._seg_live.append(seg.live.cpu().numpy() if host_live is None
                              else np.asarray(host_live))
        ids = self._seg_ids[-1]
        self._resident.update(ids[ids >= 0].tolist())

    def _hot_arrays(self):
        if self.hot.count == 0:
            return None
        if self._hot_device is None:      # invalidated on any hot mutation
            self._hot_device = tuple(
                torch.from_numpy(a.copy()).to(self.device)
                for a in (self.hot.data, self.hot.ids, self.hot.live))
        return self._hot_device

    # -- accounting ---------------------------------------------------------

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    def n_live(self) -> int:
        return self.hot.n_live() + sum(
            int(live.sum()) for live in self._seg_live)

    def live_ids(self) -> np.ndarray:
        out = [self.hot.ids[self.hot.live]]
        out += [ids[live] for ids, live in zip(self._seg_ids,
                                               self._seg_live)]
        return np.sort(np.concatenate(out))

    def memory_cost(self) -> dict:
        """§3.4 accounting extended with the lifecycle-layer overheads."""
        rows = sum(sg.rows for sg in self.segments)
        return memory_cost(self.cfg.pq, self.dim, rows,
                           n_segments=self.n_segments,
                           n_lists=self.cfg.n_lists,
                           hot_capacity=self.cfg.hot_capacity,
                           n_devices=self.cfg.n_shards)

    def stats(self) -> dict:
        return dict(n_segments=self.n_segments, n_live=self.n_live(),
                    hot_fill=self.hot.count, next_id=self.next_id,
                    sealed_rows=sum(sg.rows for sg in self.segments),
                    max_lists=[sg.max_list for sg in self.segments])
