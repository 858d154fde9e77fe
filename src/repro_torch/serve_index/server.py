"""The serving core: coalesced queries + concurrent ingest over one index
(counterpart of :mod:`repro.serve_index.server`).

:class:`IndexServer` wraps a :class:`~repro_torch.index.streaming.
StreamingIndex` with the two halves production traffic needs:

* **Read path** — a :class:`~repro_torch.serve_index.coalescer.
  QueryCoalescer` merges concurrent search requests into bucketed padded
  searches against the latest published :class:`~repro_torch.serve_index.
  view.IndexView`.  Searches take no lock on the index: a seal or
  compaction on the writer thread is invisible until its finished state
  is published as a new immutable view (the swap is one reference
  assignment).  On the card they still queue behind the writer's device
  work, which runs on the same stream (below).
* **Write path** — inserts, deletes and maintenance (flush/compact) are
  applied by a single writer thread that owns the underlying index,
  feeding from a *bounded* queue.  Admission control is the queue bound
  plus a shed policy (:data:`~repro_torch.serve_index.config.
  SHED_POLICIES`): under sustained overload the server sheds inserts
  (raising :class:`Backpressure` to the producer) while still admitting
  deletes, instead of growing an unbounded backlog.  After applying a
  batch of write ops the writer captures and publishes a fresh view;
  write futures resolve only after the publish, so
  ``insert(...).result()`` implies the rows are visible to later queries.

The server runs on the index's device.  The client threads, the
coalescer thread and the writer thread all launch work on that device's
current stream (the default stream, unless a caller sets another), so
their launches run in the order they were made: a view's hot copy and a
new segment's arrays are written before any search that can see them
is launched.  The price is that searches serialise with the writer's
device work: a search launched after a seal's encode kernels runs after
them, and a search's per-wave device reads wait for them too.

Every stage is metered through :mod:`repro_torch.obs` (queue depth,
coalesced batch sizes, shed counts, snapshot-swap latency), and costs
nothing with obs disabled.  With obs on, a span's fence synchronises the
whole device, so under load a span's time includes the other threads'
work in flight.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _device, obs
from ..core.ivf import validate_n_probe
from ..index.streaming import StreamingIndex
from .coalescer import QueryCoalescer
from .config import ServeConfig
from .view import IndexView

__all__ = ["IndexServer", "Backpressure", "SearchResult"]


class Backpressure(RuntimeError):
    """Raised to a producer when admission control sheds its write."""


class SearchResult(NamedTuple):
    """One request's answer: distances/ids plus the view version that
    produced them (every row of one request shares a version — the whole
    coalesced batch ran against a single immutable snapshot)."""
    dist: torch.Tensor   # (n, topk) float32, on the index's device
    ids: torch.Tensor    # (n, topk) int32, -1 where < topk live rows
    version: int


class _Op(NamedTuple):
    kind: str            # "insert" | "delete" | "flush" | "compact" | "barrier"
    payload: tuple
    future: Future


_STOP = object()


class IndexServer:
    """Concurrent serving front-end over a :class:`StreamingIndex`.

    The server takes ownership of the index: while it is running, all
    mutation must go through :meth:`insert` / :meth:`delete` /
    :meth:`flush` / :meth:`compact` (the writer thread is the only code
    touching the underlying object) and all searches through
    :meth:`search` / :meth:`submit_search`.  Use as a context manager::

        with IndexServer(index, ServeConfig(n_probe=4, topk=3)) as srv:
            srv.insert(X).result()            # applied + visible
            d, nn = srv.search(Q)             # coalesced with other threads

    ``on_publish`` (optional) is called with every newly published
    :class:`IndexView` from the writer thread — a seam for tests and for
    replication/backup hooks; it must not mutate the index.
    """

    # Threading contract, enforced statically (RS301 in
    # repro_torch.analysis): these fields are owned by the writer thread
    # and may only be (re)bound from the methods below; readers see them
    # through the immutable published IndexView, never directly.
    _WRITER_ONLY = frozenset({"_index", "_version", "_view"})
    _WRITER_METHODS = frozenset({"_writer_loop", "_apply", "_publish"})

    def __init__(self, index: StreamingIndex,
                 cfg: Optional[ServeConfig] = None,
                 on_publish=None):
        self.cfg = cfg if cfg is not None else ServeConfig()
        validate_n_probe(self.cfg.n_probe, index.cfg.n_lists)
        self._index = index
        self._on_publish = on_publish
        self._version = 0
        self._view = IndexView.capture(index, version=0)
        self._wq: "queue.Queue" = queue.Queue(maxsize=self.cfg.queue_bound)
        self._coalescer = QueryCoalescer(self._run_batch, self.cfg,
                                         index.device)
        self._writer = threading.Thread(
            target=self._writer_loop, name="repro-torch-serve-writer",
            daemon=True)
        self._started = False
        self._stopped = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "IndexServer":
        if self._started:
            raise RuntimeError("server already started")
        self._started = True
        self._coalescer.start()
        self._writer.start()
        return self

    def stop(self) -> None:
        """Graceful shutdown: queued writes are applied and queued queries
        answered before the threads exit."""
        if not self._started or self._stopped:
            return
        self._stopped = True
        self._wq.put(_STOP)               # blocking: always admitted
        self._writer.join()
        self._coalescer.stop()

    def __enter__(self) -> "IndexServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- read path -----------------------------------------------------------

    def submit_search(self, Q) -> Future:
        """Enqueue ``Q (n, D)`` (numpy or a tensor on any device) for the
        next coalesced batch; the future resolves to a
        :class:`SearchResult`."""
        Q = np.ascontiguousarray(_device.to_host(Q), np.float32)
        if Q.ndim != 2 or Q.shape[1] != self._index.dim:
            raise ValueError(
                f"expected (n, {self._index.dim}) queries, got {Q.shape}")
        if Q.shape[0] == 0:
            raise ValueError("empty query batch")
        return self._coalescer.submit(Q)

    def search(self, Q, timeout: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Blocking convenience wrapper -> ``(dist, ids)`` like
        :meth:`StreamingIndex.search` (``n_probe``/``topk`` are fixed by
        the :class:`ServeConfig`)."""
        r = self.submit_search(Q).result(timeout)
        return r.dist, r.ids

    def _run_batch(self, Qp: torch.Tensor, q_valid: torch.Tensor,
                   n_real: int) -> SearchResult:
        view = self._view                 # one atomic read: the whole batch
        d, ids = view.search(Qp, n_probe=self.cfg.n_probe,
                             topk=self.cfg.topk, q_valid=q_valid)
        return SearchResult(d, ids, view.version)

    # -- write path ----------------------------------------------------------

    def insert(self, X: np.ndarray, ids: Optional[Sequence[int]] = None
               ) -> Future:
        """Admit an insert; resolves to the assigned external ids.  Raises
        :class:`Backpressure` immediately when the queue is full under a
        shedding policy."""
        X = np.asarray(_device.to_host(X), np.float32)
        return self._submit_write("insert", (X, ids))

    def delete(self, ids: Sequence[int]) -> Future:
        """Admit a delete (tombstone); resolves to the hit count.  Under
        the default ``shed_inserts`` policy deletes are never shed — a
        full queue blocks the caller instead (deletes free space)."""
        return self._submit_write(
            "delete", (np.asarray(_device.to_host(ids), np.int32),))

    def flush(self) -> Future:
        """Request a seal of the hot buffer (maintenance; never shed)."""
        return self._submit_write("flush", ())

    def compact(self) -> Future:
        """Request a compaction (maintenance; never shed)."""
        return self._submit_write("compact", ())

    def quiesce(self, timeout: Optional[float] = None) -> int:
        """Wait until every previously admitted write is applied and
        published; returns the version of the resulting view."""
        fut = self._submit_write("barrier", ())
        return fut.result(timeout)

    def _submit_write(self, kind: str, payload: tuple) -> Future:
        if not self._started or self._stopped:
            raise RuntimeError("server is not running")
        fut: Future = Future()
        op = _Op(kind, payload, fut)
        sheddable = (kind == "insert" if self.cfg.shed_policy ==
                     "shed_inserts" else
                     kind in ("insert", "delete")
                     if self.cfg.shed_policy == "shed_all" else False)
        if sheddable:
            try:
                self._wq.put_nowait(op)
            except queue.Full:
                if obs.enabled():
                    obs.counter("serving_shed_total", persistent=True,
                                op=kind).inc()
                raise Backpressure(
                    f"write queue full ({self.cfg.queue_bound} pending): "
                    f"{kind} shed under policy "
                    f"{self.cfg.shed_policy!r}") from None
        else:
            self._wq.put(op)              # backpressure: block the producer
        if obs.enabled():
            obs.gauge("serving_write_queue_depth",
                      persistent=True).set(self._wq.qsize())
        return fut

    def _writer_loop(self) -> None:
        while True:
            op = self._wq.get()
            stop = op is _STOP
            ops = [] if stop else [op]
            while not stop and len(ops) < self.cfg.apply_batch:
                try:
                    nxt = self._wq.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                ops.append(nxt)
            if ops:
                self._apply(ops)
            if stop:
                return

    def _apply(self, ops) -> None:
        index = self._index
        outcomes = []                     # (op, ok, value_or_exc)
        with obs.span("serving.apply"):
            for op in ops:
                try:
                    if op.kind == "insert":
                        outcomes.append((op, True, index.insert(*op.payload)))
                    elif op.kind == "delete":
                        outcomes.append((op, True, index.delete(*op.payload)))
                    elif op.kind == "flush":
                        index.flush()
                        outcomes.append((op, True, None))
                    elif op.kind == "compact":
                        index.compact()
                        outcomes.append((op, True, None))
                    # "barrier": resolved with the published version below
                except BaseException as e:   # noqa: BLE001 - forwarded
                    outcomes.append((op, False, e))
        version = self._publish()
        # futures resolve only after the publish: a completed write is a
        # *visible* write
        for op, ok, val in outcomes:
            (op.future.set_result if ok else op.future.set_exception)(val)
        for op in ops:
            if op.kind == "barrier":
                op.future.set_result(version)
        if obs.enabled():
            obs.gauge("serving_write_queue_depth",
                      persistent=True).set(self._wq.qsize())

    def _publish(self) -> int:
        t0 = time.perf_counter()
        with obs.span("serving.snapshot_swap"):
            self._version += 1
            view = IndexView.capture(self._index, self._version)
            self._view = view             # the swap: one atomic rebind
        if obs.enabled():
            obs.histogram("serving_snapshot_swap_seconds",
                          persistent=True).record(time.perf_counter() - t0)
            obs.counter("serving_view_swaps_total", persistent=True).inc()
            obs.gauge("serving_view_version",
                      persistent=True).set(view.version)
        if self._on_publish is not None:
            self._on_publish(view)
        return view.version

    # -- introspection -------------------------------------------------------

    @property
    def view(self) -> IndexView:
        """The currently published immutable snapshot."""
        return self._view

    @property
    def version(self) -> int:
        return self._view.version

    def pressure(self) -> float:
        """Write-queue occupancy in [0, 1] — the backpressure signal a
        producer can watch to pace itself before shedding starts."""
        return self._wq.qsize() / self.cfg.queue_bound

    def stats(self) -> dict:
        """Host-side serving stats (no device reads)."""
        return dict(version=self._view.version,
                    n_segments=len(self._view.segments),
                    write_queue_depth=self._wq.qsize(),
                    pressure=self.pressure())
