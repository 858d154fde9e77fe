"""Immutable point-in-time index views — the read side of the serving core
(counterpart of :mod:`repro.serve_index.view`).

A :class:`IndexView` holds everything
:func:`repro_torch.index.streaming.search_impl` needs — the frozen
quantizers, the tuple of sealed segments, a device copy of the hot buffer
— as state that no writer touches after capture:

* sealed segments are copy-on-write already (``SealedSegment`` is a
  frozen dataclass; a tombstone builds a *new* segment, and the index's
  segment list is only re-pointed, never changed in place), so a view's
  segment tuple stays consistent through any later seal or compaction;
* the hot buffer is the one mutable structure, so capture copies the
  writer's host staging arrays into fresh tensors on the index's device —
  its own copy, never the index's cached upload.

Searching a view is therefore safe from any thread while the writer
changes the underlying :class:`~repro_torch.index.streaming.
StreamingIndex`, and gives the same bits as searching a quiesced index in
the captured state: the same ``search_impl``, the same kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..index.streaming import StreamingIndex, search_impl

__all__ = ["IndexView"]


@dataclasses.dataclass(frozen=True)
class IndexView:
    """One consistent, immutable snapshot of a streaming index.

    ``version`` is the publish sequence number: the writer bumps it on
    every snapshot swap, and every :class:`~repro_torch.serve_index.
    server.SearchResult` records the version it was computed against.
    """

    cfg: object                   # repro_torch.index.IndexConfig (frozen)
    dim: int
    device: torch.device
    coarse: torch.Tensor
    cb: object                    # repro_torch.core.pq.PQCodebook
    segments: Tuple              # tuple of SealedSegment (frozen)
    hot: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    two_level: Optional[object]
    version: int = 0

    @classmethod
    def capture(cls, index: StreamingIndex, version: int = 0) -> "IndexView":
        """Snapshot ``index`` (must not race with writes: while a server
        runs, its writer thread is the only caller)."""
        hot = None
        if index.hot.count:
            # torch.tensor copies: the view's tensors must not alias the
            # writer's mutable numpy staging buffers, nor the index's
            # cached upload of them
            hot = tuple(torch.tensor(a, device=index.device)
                        for a in (index.hot.data, index.hot.ids,
                                  index.hot.live))
        return cls(cfg=index.cfg, dim=index.dim, device=index.device,
                   coarse=index.coarse, cb=index.cb,
                   segments=tuple(index.segments), hot=hot,
                   two_level=index.two_level, version=version)

    def n_live(self) -> int:
        """Live rows visible to this view."""
        hot_live = int(self.hot[2].sum()) if self.hot is not None else 0
        return hot_live + sum(sg.n_live() for sg in self.segments)

    def search(self, Q: torch.Tensor, *, n_probe: int, topk: int = 1,
               q_valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-``topk`` neighbours within this snapshot -> ``(dist, ids)``
        on the view's device.

        The math of :meth:`StreamingIndex.search` (it is the same
        ``search_impl``); ``q_valid`` marks the padding rows of a
        coalesced batch, as in the sharded planner.
        """
        Q = torch.as_tensor(Q, dtype=torch.float32).to(self.device)
        if q_valid is not None:
            q_valid = torch.as_tensor(q_valid).to(self.device)
        return search_impl(self.coarse, self.cb, self.segments, self.hot,
                           Q, icfg=self.cfg, n_probe=n_probe, topk=topk,
                           dim=self.dim, two_level=self.two_level,
                           q_valid=q_valid)
