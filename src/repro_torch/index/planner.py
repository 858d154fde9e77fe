"""Sharded query planner on one card (counterpart of
:mod:`repro.index.planner`).

The reference spreads a search over the 1-D ``search`` axis of a device
mesh.  On one card the mesh becomes a count, ``n_devices`` (default 1),
and each of its devices' work runs in turn on the index's device, with
the reference's partition semantics:

* ``"queries"`` — the index is shared; the query batch is padded to a
  multiple of ``n_devices`` and searched once through
  :func:`~repro_torch.index.streaming.search_impl` with the ``q_valid``
  padding mask, so padding rows claim no LB-cascade refine work.
* ``"lists"`` — the sealed segments are laid out shard-major with
  ``n_shards == n_devices``
  (:meth:`~repro_torch.index.segments.SealedSegment.shard_views`).  The
  coarse distances and query tables are computed once for the batch;
  then shard block ``s`` ranks its locally placed lists
  (:func:`~repro_torch.core.ivf.fine_rank_batch`), scans its stripe of
  the hot buffer (row ``r`` belongs to block ``r % n_devices``) and keeps
  a local top-k.  The partial top-k's are merged as the reference's
  ``all_gather`` fan-in merges them: every block's ``(Nq, topk)`` tile,
  block-major, re-ranked by one stable top-k.  Every candidate row is
  scanned by exactly one block, so the result equals the single-device
  plan's; only the order of exact distance ties can differ.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import obs
from ..core.topk import smallest_k
from ..launch.mesh import mesh_sizes, validate_search_mesh
from .streaming import (StreamingIndex, _empty_topk, _hot_topk, _merge_topk,
                        _probe_tables, _rank_blocks, search_impl)

__all__ = ["search_sharded"]

_PARTITIONS = ("auto", "queries", "lists")


def _pad_queries(Q: torch.Tensor, n_dev: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Pad ``Q`` to a multiple of ``n_dev`` rows; returns
    ``(Q_padded, q_valid, Nq)`` where ``q_valid`` marks the real rows."""
    Nq = Q.shape[0]
    pad = (-Nq) % n_dev
    if pad:
        Q = torch.cat([Q, Q.new_zeros((pad, Q.shape[1]))], 0)
    q_valid = torch.arange(Nq + pad, device=Q.device) < Nq
    return Q, q_valid, Nq


def _search_query_sharded(index: StreamingIndex, Q: torch.Tensor,
                          n_dev: int, n_probe: int, topk: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    Qp, q_valid, Nq = _pad_queries(Q, n_dev)
    with obs.span("sharded.execute") as sp:
        d, ids = sp.fence(search_impl(
            index.coarse, index.cb, tuple(index.segments),
            index._hot_arrays(), Qp, icfg=index.cfg, n_probe=n_probe,
            topk=topk, dim=index.dim, two_level=index.two_level,
            q_valid=q_valid))
    return d[:Nq], ids[:Nq]


def _validate_layout(index: StreamingIndex, n_dev: int) -> None:
    n_shards = index.cfg.n_shards
    if n_shards != n_dev:
        raise ValueError(
            f"index layout is sealed for n_shards={n_shards} but the plan "
            f"has {n_dev} devices — reseal the index "
            f"(IndexConfig(n_shards={n_dev}) + compact()) or pass "
            f"n_devices={n_shards}")
    for sg in index.segments:
        if sg.n_shards != n_dev:
            raise ValueError(
                f"list-sharded search over {n_dev} devices needs every "
                f"segment sealed with n_shards={n_dev}, found a segment "
                f"with n_shards={sg.n_shards} — set "
                f"IndexConfig(n_shards={n_dev}) and compact() (or flush "
                f"new data) to re-seal the layout")


def _search_list_sharded(index: StreamingIndex, Q: torch.Tensor,
                         n_dev: int, n_probe: int, topk: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    icfg = index.cfg
    _validate_layout(index, n_dev)
    Nq = Q.shape[0]
    segs = tuple(index.segments)
    hot = index._hot_arrays()
    if not segs and hot is None:
        return _empty_topk(Nq, topk, Q.device)
    # shared stages: every block probes with the same numbers, which is
    # what makes the fan-in merge exact
    if segs:
        dc, qluts = _probe_tables(Q, index.coarse, index.cb, icfg,
                                  index.dim, index.two_level,
                                  span="sharded")
    views = [sg.shard_views() for sg in segs]

    tiles_d, tiles_i = [], []
    with obs.span("sharded.device_scan") as sp:
        for s in range(n_dev):
            parts_d, parts_i = [], []
            if segs:
                parts_d, parts_i = _rank_blocks(
                    ((codes[s], ids[s], live[s], start[s], length[s],
                      sg.max_list)
                     for sg, (codes, ids, live, start, length)
                     in zip(segs, views)),
                    dc, qluts, n_probe=n_probe, topk=topk)
            if hot is not None:
                # the hot buffer in stripes: row r belongs to block
                # r % n_dev, so every live row is scanned exactly once
                stripe = tuple(a[s::n_dev].contiguous() for a in hot)
                if stripe[0].shape[0]:
                    d, i = _hot_topk(stripe, Q, None, icfg=icfg,
                                     dim=index.dim, topk=topk)
                    parts_d.append(d)
                    parts_i.append(i)
            if parts_d:
                d_loc, i_loc = _merge_topk(parts_d, parts_i, topk=topk)
            else:
                d_loc, i_loc = _empty_topk(Nq, topk, Q.device)
            tiles_d.append(d_loc)
            tiles_i.append(i_loc)
        sp.fence(tiles_d)
    with obs.span("sharded.fanin_merge") as sp:
        # the reference's all_gather + re-rank: (n_dev, Nq, topk) tiles,
        # block-major per query; empty slots carry inf / -1 and lose to
        # any real candidate
        all_d = torch.stack(tiles_d, 1).reshape(Nq, n_dev * topk)
        all_i = torch.stack(tiles_i, 1).reshape(Nq, n_dev * topk)
        dk, best = smallest_k(all_d, topk)
        return sp.fence((dk, torch.gather(all_i, 1, best)))


def search_sharded(index: StreamingIndex, Q, *, n_probe: int,
                   topk: int = 1, partition: str = "auto",
                   n_devices: Optional[int] = None, mesh=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:meth:`StreamingIndex.search` under a partition plan ->
    ``(dist, ids)`` on the index's device.

    ``partition`` selects the plan (module docstring): ``"queries"`` pads
    the batch to a multiple of ``n_devices`` and masks the padding,
    ``"lists"`` walks the ``n_devices`` shard blocks of a layout sealed
    with ``n_shards == n_devices`` and merges their partial top-k's.
    ``"auto"`` picks ``"lists"`` when the layout matches
    (``cfg.n_shards == n_devices > 1``) and ``"queries"`` otherwise.
    ``n_devices`` defaults to 1: the reference's mesh on one card.
    ``mesh``, a ``("search",)`` mesh (:func:`~repro_torch.launch.mesh.
    make_search_mesh`, or a ``DeviceMesh`` of that axis), gives the count
    instead, and a list-sharded plan checks the layout against it with
    :func:`~repro_torch.launch.mesh.validate_search_mesh` (the
    reference's error); each of its devices' blocks still runs in turn on
    the index's device.

    >>> import numpy as np
    >>> from repro_torch.core.pq import PQConfig
    >>> from repro_torch.index.streaming import IndexConfig
    >>> cfg = IndexConfig(
    ...     PQConfig(n_sub=2, codebook_size=4, use_prealign=False,
    ...              kmeans_iters=1, dba_iters=1),
    ...     n_lists=2, hot_capacity=4, coarse_iters=2)
    >>> X = np.sin(np.arange(8 * 16, dtype=np.float32)).reshape(8, 16)
    >>> idx = StreamingIndex.bootstrap(torch.Generator().manual_seed(0), X,
    ...                                cfg, device="cpu")
    >>> _ = idx.insert(X)
    >>> dist, ids = search_sharded(idx, X[:2], n_probe=2, topk=1)
    >>> tuple(ids.shape), int(ids[0, 0])
    ((2, 1), 0)
    """
    if partition not in _PARTITIONS:
        raise ValueError(
            f"partition={partition!r} must be one of {_PARTITIONS}")
    n_dev = 1 if n_devices is None else int(n_devices)
    if mesh is not None:
        sizes = mesh_sizes(mesh)
        if "search" not in sizes:
            validate_search_mesh(mesh, index.cfg.n_shards)   # raises
        if n_devices is not None and n_dev != sizes["search"]:
            raise ValueError(f"n_devices={n_devices} but the mesh has "
                             f"{sizes['search']} devices on 'search'")
        n_dev = sizes["search"]
    if n_dev < 1:
        raise ValueError(f"n_devices={n_devices} must be >= 1")
    Q = index._validate(Q, n_probe, topk)
    if partition == "auto":
        partition = ("lists" if n_dev > 1 and index.cfg.n_shards == n_dev
                     else "queries")
    if partition == "lists" and mesh is not None:
        validate_search_mesh(mesh, index.cfg.n_shards)
    with obs.span("sharded.search"):
        if partition == "lists":
            return _search_list_sharded(index, Q, n_dev, n_probe, topk)
        return _search_query_sharded(index, Q, n_dev, n_probe, topk)
