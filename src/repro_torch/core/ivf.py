"""IVF-PQDTW: inverted-file index for million-scale elastic search
(counterpart of :mod:`repro.core.ivf`).

A coarse DBA-k-means quantizer over *whole* series routes each database
series to one of ``n_lists`` inverted lists; queries compute ``n_lists``
coarse elastic distances (one all-pairs kernel launch for the batch),
probe the ``n_probe`` nearest lists, and evaluate the PQDTW asymmetric
distance only for candidates in those lists.  Lists share one global PQ
codebook over raw series (the Euclidean residual trick is unsound under
warping), so the coarse stage only prunes.

The fine stage is *segment-searchable*: :func:`fine_rank_batch` works on
bare list-layout tensors (codes / ids / list_start / list_len [+ a
tombstone mask]), so the streaming index (:mod:`repro_torch.index`) ranks
each sealed segment with the same code.  The reference vmaps a
one-query fine stage; here the batch is a dimension, processed in chunks
of queries so that no ``(queries, n_probe * max_list, M)`` code gather
exceeds :data:`GATHER_CHUNK_BYTES`.  Every ranking is a stable top-k
(lower index first among ties, as ``jax.lax.top_k``), so ids equal the
reference's.

Randomness: ``jax.random`` keys become ``torch.Generator``\\ s; the
training entry points also take explicit initial centroids.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _device
from ..kernels.pq_adc.ops import check_codes
from .dispatch import elastic_cdist, two_level_coarse
from .kmeans import dba_kmeans
from .lb import lb_lut
from .measures import MeasureArg
from .pq import (PQCodebook, PQConfig, adc_gather, codebook_from_numpy,
                 encode, fit, query_lut_batch, segment)
from .topk import smallest_k

__all__ = ["IVFPQIndex", "TwoLevelCoarse", "build_index", "build_lists",
           "build_two_level", "coarse_assign", "coarse_dists", "fine_rank",
           "fine_rank_batch", "search", "search_batch", "validate_n_probe",
           "validate_codebook", "ivf_index_from_numpy",
           "two_level_from_numpy", "GATHER_CHUNK_BYTES"]

# Cap on one (queries, n_probe * max_list, M) int64 code gather.
GATHER_CHUNK_BYTES = 256 << 20

_INF = float("inf")


def validate_codebook(cb: PQCodebook, cfg: PQConfig, D: int) -> None:
    """Reject a pre-trained codebook whose geometry disagrees with ``cfg``
    for series of length ``D`` (e.g. trained without pre-alignment)."""
    want = cfg.subseq_len(D)
    if cb.n_sub != cfg.n_sub or cb.subseq_len != want:
        raise ValueError(
            f"codebook geometry (n_sub={cb.n_sub}, subseq_len="
            f"{cb.subseq_len}) does not match config (n_sub={cfg.n_sub}, "
            f"subseq_len={want} for D={D}) — check the prealign settings "
            f"(use_prealign/tail_frac/snap_tail) the codebook was trained "
            f"with")


class IVFPQIndex(NamedTuple):
    coarse: torch.Tensor      # (n_lists, D) DBA centroids of whole series
    cb: PQCodebook            # shared PQ codebook (paper §3.1)
    codes: torch.Tensor       # (N, M) int32 PQ codes, list-sorted order
    ids: torch.Tensor         # (N,) int32 original indices, list-sorted
    list_start: torch.Tensor  # (n_lists,) int32 offset of each list
    list_len: torch.Tensor    # (n_lists,) int32
    max_list: int             # longest list
    coarse_window: int        # the band the lists were assigned with (the
                              # search-time default)

    @property
    def n_lists(self) -> int:
        return self.coarse.shape[0]


class TwoLevelCoarse(NamedTuple):
    """Hierarchical coarse quantizer: a k-means clustering of the coarse
    centroids themselves, so queries rank ``n_top`` top cells and fan out
    only to the probed cells' children."""
    top: torch.Tensor          # (n_top, D)
    child_idx: torch.Tensor    # (n_top, max_children) int32 into coarse
    child_valid: torch.Tensor  # (n_top, max_children) bool padding mask

    @property
    def n_top(self) -> int:
        return self.top.shape[0]

    @property
    def max_children(self) -> int:
        return self.child_idx.shape[1]


def ivf_index_from_numpy(index, device: _device.DeviceArg = None
                         ) -> IVFPQIndex:
    """Carry an index in: any 8-sequence in :class:`IVFPQIndex`'s field
    order (e.g. the reference's ``IVFPQIndex``), arrays as numpy."""
    dev = _device.resolve_device(device)
    coarse, cb, codes, ids, start, length, max_list, window = index
    check_codes(np.asarray(cb[1]).shape[-1], codes=np.asarray(codes))
    return IVFPQIndex(
        coarse=_device.to_tensor(coarse, dev, torch.float32),
        cb=codebook_from_numpy(cb, dev),
        codes=_device.to_tensor(codes, dev, torch.int32),
        ids=_device.to_tensor(ids, dev, torch.int32),
        list_start=_device.to_tensor(start, dev, torch.int32),
        list_len=_device.to_tensor(length, dev, torch.int32),
        max_list=int(max_list), coarse_window=int(window))


def two_level_from_numpy(two_level, device: _device.DeviceArg = None
                         ) -> TwoLevelCoarse:
    """Carry a two-level table in: ``(top, child_idx, child_valid)``, e.g.
    the reference's ``TwoLevelCoarse``."""
    dev = _device.resolve_device(device)
    top, child_idx, child_valid = two_level
    return TwoLevelCoarse(_device.to_tensor(top, dev, torch.float32),
                          _device.to_tensor(child_idx, dev, torch.int32),
                          _device.to_tensor(child_valid, dev, torch.bool))


def coarse_assign(X: torch.Tensor, coarse: torch.Tensor,
                  window: Optional[int],
                  measure: MeasureArg = None) -> torch.Tensor:
    """Route series ``X (N, D)`` to their nearest coarse centroid (first
    index among ties) -> ``(N,)`` int32 list ids."""
    return torch.argmin(elastic_cdist(X, coarse, window, measure=measure),
                        dim=1).to(torch.int32)


def build_lists(assign: np.ndarray, n_lists: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """List-sorted layout from a coarse assignment (host-side): ``(order,
    list_start, list_len, max_list)``, a stable sort permutation into list
    order plus the per-list offsets/lengths."""
    assign = np.asarray(assign)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    start = np.searchsorted(sorted_assign, np.arange(n_lists)).astype(np.int32)
    length = (np.searchsorted(sorted_assign, np.arange(n_lists), "right")
              - start).astype(np.int32)
    max_list = int(length.max()) if assign.size else 0
    return order, start, length, max_list


def build_two_level(generator: Optional[torch.Generator],
                    coarse: torch.Tensor, n_top: int,
                    window: Optional[int], measure: MeasureArg = None,
                    iters: int = 8, *,
                    init: Optional[torch.Tensor] = None) -> TwoLevelCoarse:
    """Cluster the ``(n_lists, D)`` coarse centroids into ``n_top`` top
    cells (elastic DBA k-means from ``init`` or drawn with ``generator``)
    and tabulate each cell's children as a padded table."""
    coarse = coarse.to(torch.float32)
    n_lists = coarse.shape[0]
    if not 1 <= n_top <= n_lists:
        raise ValueError(
            f"n_top={n_top} out of range: must satisfy 1 <= n_top <= "
            f"n_lists={n_lists}")
    if init is not None:
        init = _device.to_tensor(init, coarse.device, torch.float32)
    res = dba_kmeans(coarse, n_top, iters=iters, dba_iters=1, window=window,
                     measure=measure, init=init, generator=generator)
    assign = res.assignment.cpu().numpy()
    order, start, length, max_children = build_lists(assign, n_top)
    max_children = max(1, max_children)
    child_idx = np.zeros((n_top, max_children), np.int32)
    child_valid = np.zeros((n_top, max_children), bool)
    for t in range(n_top):
        kids = order[start[t]:start[t] + length[t]]
        child_idx[t, :len(kids)] = kids
        child_valid[t, :len(kids)] = True
    dev = coarse.device
    return TwoLevelCoarse(top=res.centroids,
                          child_idx=torch.from_numpy(child_idx).to(dev),
                          child_valid=torch.from_numpy(child_valid).to(dev))


def coarse_dists(Q: torch.Tensor, coarse: torch.Tensor,
                 window: Optional[int], measure: MeasureArg = None,
                 two_level: Optional[TwoLevelCoarse] = None,
                 n_probe_top: Optional[int] = None) -> torch.Tensor:
    """Coarse distance rows ``(Nq, n_lists)`` for the probe stage: the flat
    all-pairs cdist, or the hierarchical fan-out (``+inf`` outside the
    ``n_probe_top`` nearest top cells' children)."""
    if two_level is None:
        return elastic_cdist(Q, coarse, window, measure=measure)
    if n_probe_top is None:
        raise ValueError("two_level coarse search requires n_probe_top")
    return two_level_coarse(Q, two_level.top, coarse, two_level.child_idx,
                            two_level.child_valid, window,
                            n_probe_top=n_probe_top, measure=measure)


def build_index(generator: Optional[torch.Generator], X, cfg: PQConfig,
                n_lists: int, coarse_iters: int = 8,
                coarse_window_frac: float = 0.1, *,
                coarse=None, cb: Optional[PQCodebook] = None,
                device: _device.DeviceArg = None) -> IVFPQIndex:
    """Train coarse + fine quantizers (with ``generator``, in that order)
    and populate the inverted lists.  Pre-trained ``coarse`` centroids
    and/or a ``cb`` codebook skip the corresponding training stage."""
    dev = _device.resolve_device(device)
    X = _device.to_tensor(X, dev, torch.float32)
    D = X.shape[1]
    w = max(1, int(round(coarse_window_frac * D)))
    spec = cfg.measure()
    if coarse is None:
        res = dba_kmeans(X, n_lists, iters=coarse_iters, dba_iters=1,
                         window=w, measure=spec, generator=generator)
        coarse_cents, assign = res.centroids, res.assignment
    else:
        coarse_cents = _device.to_tensor(coarse, dev, torch.float32)
        if coarse_cents.shape[0] != n_lists:
            raise ValueError(
                f"pre-trained coarse quantizer has {coarse_cents.shape[0]} "
                f"centroids but n_lists={n_lists}")
        assign = coarse_assign(X, coarse_cents, w, spec)
    if cb is None:
        cb = fit(X, cfg, generator, device=dev)
    else:
        cb = codebook_from_numpy(cb, dev)
        validate_codebook(cb, cfg, D)
    codes = encode(X, cb, cfg, device=dev)

    order, start, length, max_list = build_lists(assign.cpu().numpy(),
                                                 n_lists)
    order_t = torch.from_numpy(order).to(dev)
    return IVFPQIndex(
        coarse=coarse_cents, cb=cb, codes=codes[order_t],
        ids=order_t.to(torch.int32),
        list_start=torch.from_numpy(start).to(dev),
        list_len=torch.from_numpy(length).to(dev),
        max_list=max_list, coarse_window=w)


def _rank_chunk(codes, ids, list_start, list_len, max_list, dc, qluts,
                n_probe, topk, live, lb_qluts, lb_budget):
    B = dc.shape[0]
    M = codes.shape[1]
    _, probes = smallest_k(dc, n_probe)                      # (B, P)
    offs = torch.arange(max_list, device=dc.device)
    start = list_start.long()[probes]
    length = list_len.long()[probes]
    valid = offs[None, None, :] < length[..., None]          # (B, P, ml)
    slots = torch.where(valid, start[..., None] + offs, 0).reshape(B, -1)
    # a two-level coarse stage leaves unprobed lists at +inf; if n_probe
    # exceeds the finite fan-out the probe top-k pads with such lists,
    # whose rows were never coarse-ranked (a no-op for flat distances)
    finite = torch.isfinite(torch.gather(dc, 1, probes))
    valid = (valid & finite[..., None]).reshape(B, -1)
    if live is not None:
        valid = valid & live[slots]
    cand_codes = codes[slots]                                # (B, cap, M)
    if lb_qluts is not None and lb_budget is not None \
            and lb_budget < slots.shape[1]:
        lb_d = torch.where(valid, adc_gather(lb_qluts, cand_codes), _INF)
        _, keep = smallest_k(lb_d, lb_budget)
        slots = torch.gather(slots, 1, keep)
        valid = torch.gather(valid, 1, keep)
        cand_codes = torch.gather(cand_codes, 1,
                                  keep[..., None].expand(-1, -1, M))
    d = torch.where(valid, adc_gather(qluts, cand_codes), _INF)
    dk, best = smallest_k(d, topk)
    out_ids = torch.where(torch.isfinite(dk),
                          ids[torch.gather(slots, 1, best)],
                          torch.full_like(best, -1, dtype=ids.dtype))
    return dk, out_ids.to(torch.int32)


def fine_rank_batch(codes: torch.Tensor, ids: torch.Tensor,
                    list_start: torch.Tensor, list_len: torch.Tensor,
                    max_list: int, dc: torch.Tensor, qluts: torch.Tensor,
                    n_probe: int, topk: int,
                    live: Optional[torch.Tensor] = None,
                    lb_qluts: Optional[torch.Tensor] = None,
                    lb_budget: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank one list-sorted shard against a batch of queries.

    ``dc (Nq, n_lists)`` coarse distances, ``qluts (Nq, M, K)`` asymmetric
    tables, ``live`` an optional ``(N,)`` tombstone mask (False = deleted).
    Returns ``(distances (Nq, topk), ids (Nq, topk) int32)`` with ``inf``
    / ``-1`` filling invalid slots, so shard results merge by a plain
    top-k.  ``lb_qluts (Nq, M, K)`` (:func:`repro_torch.core.lb.lb_lut`)
    with ``lb_budget`` keeps only the ``lb_budget`` candidates of smallest
    lower-bound ADC sum for the exact gather.
    """
    Nq = dc.shape[0]
    cap = max(1, n_probe * max_list)
    rows = max(1, GATHER_CHUNK_BYTES // (cap * codes.shape[1] * 8))
    parts = [_rank_chunk(codes, ids, list_start, list_len, max_list,
                         dc[s:s + rows], qluts[s:s + rows], n_probe, topk,
                         live,
                         None if lb_qluts is None else lb_qluts[s:s + rows],
                         lb_budget)
             for s in range(0, Nq, rows)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def fine_rank(codes: torch.Tensor, ids: torch.Tensor,
              list_start: torch.Tensor, list_len: torch.Tensor,
              max_list: int, dc: torch.Tensor, qlut: torch.Tensor,
              n_probe: int, topk: int, live: Optional[torch.Tensor] = None,
              lb_qlut: Optional[torch.Tensor] = None,
              lb_budget: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fine_rank_batch` for one query: ``dc (n_lists,)``, ``qlut
    (M, K)`` -> ``(distances (topk,), ids (topk,))``."""
    d, i = fine_rank_batch(codes, ids, list_start, list_len, max_list,
                           dc[None], qlut[None], n_probe, topk, live,
                           None if lb_qlut is None else lb_qlut[None],
                           lb_budget)
    return d[0], i[0]


def validate_n_probe(n_probe: int, n_lists: int) -> None:
    """Shared probe-budget check (monolithic and streaming indexes)."""
    if not 1 <= n_probe <= n_lists:
        raise ValueError(
            f"n_probe={n_probe} out of range: must satisfy "
            f"1 <= n_probe <= n_lists={n_lists}")


def _validate_probe(n_lists: int, max_list: int, n_probe: int,
                    topk: int, lb_budget: Optional[int] = None) -> None:
    validate_n_probe(n_probe, n_lists)
    cap = n_probe * max_list
    if not 1 <= topk <= cap:
        raise ValueError(
            f"topk={topk} out of range: must satisfy 1 <= topk <= "
            f"n_probe*max_list={cap} (n_probe={n_probe}, "
            f"max_list={max_list}); raise n_probe or shrink topk")
    if lb_budget is not None and not topk <= lb_budget <= cap:
        raise ValueError(
            f"lb_budget={lb_budget} out of range: must satisfy topk="
            f"{topk} <= lb_budget <= n_probe*max_list={cap}")


def search(index: IVFPQIndex, q, cfg: PQConfig, *, n_probe: int,
           topk: int = 1, coarse_window: Optional[int] = None,
           lb_budget: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single query ``q (D,)`` -> ``(distances (topk,), ids (topk,))``."""
    q = _device.to_tensor(q, index.coarse.device, torch.float32)
    d, ids = search_batch(index, q[None, :], cfg, n_probe=n_probe,
                          topk=topk, coarse_window=coarse_window,
                          lb_budget=lb_budget)
    return d[0], ids[0]


def search_batch(index: IVFPQIndex, Q, cfg: PQConfig, *, n_probe: int,
                 topk: int = 1, coarse_window: Optional[int] = None,
                 lb_budget: Optional[int] = None,
                 two_level: Optional[TwoLevelCoarse] = None,
                 n_probe_top: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched search over queries ``Q (Nq, D)`` on the index's device.

    The coarse stage and the asymmetric query tables take one dispatch
    launch each (one per subspace for the tables); the probe / gather /
    top-k tail is batched over the queries.  ``coarse_window`` defaults to
    the band the lists were assigned with.  ``lb_budget`` enables the
    cascaded LB pre-filter of the fine stage for measures with a sound
    Keogh cascade (ignored otherwise).  ``two_level`` + ``n_probe_top``
    switch the coarse stage to the hierarchical quantizer.
    """
    _validate_probe(index.n_lists, index.max_list, n_probe, topk, lb_budget)
    Q = _device.to_tensor(Q, index.coarse.device, torch.float32)
    D = Q.shape[-1]
    spec = cfg.measure()
    w = coarse_window if coarse_window is not None else index.coarse_window
    dc = coarse_dists(Q, index.coarse, w, measure=spec,
                      two_level=two_level, n_probe_top=n_probe_top)
    q_segs = segment(Q, cfg)                                # (Nq, M, S)
    qluts = query_lut_batch(q_segs, index.cb, cfg.window(D),
                            not cfg.is_elastic, spec)       # (Nq, M, K)
    if lb_budget is not None and spec is not None and not spec.has_keogh_lb:
        lb_budget = None     # the envelope table is no bound for it
    lb_luts = None
    if lb_budget is not None and lb_budget < n_probe * index.max_list:
        lb_luts = lb_lut(q_segs, index.cb.centroids, index.cb.env_upper,
                         index.cb.env_lower)                # (Nq, M, K)
    return fine_rank_batch(index.codes, index.ids, index.list_start,
                           index.list_len, index.max_list, dc, qluts,
                           n_probe, topk, lb_qluts=lb_luts,
                           lb_budget=lb_budget)
