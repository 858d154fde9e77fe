"""Request-coalescing query batcher (counterpart of
:mod:`repro.serve_index.coalescer`).

Queries submitted from any number of client threads are merged into one
padded search per coalescing window: the first pending request opens a
window of ``ServeConfig.coalesce_window_s``, every request arriving before
it closes (or before the batch reaches the largest bucket) joins the
batch, and the batch is searched at the smallest ``q_buckets`` size that
fits, its real rows flagged by a ``q_valid`` mask, as in the sharded
planner's padded query blocks.  Launch shapes come from the finite bucket
family, so a warmed server answers mixed traffic with the same launches
per request size every time.

The batch is padded on the host and goes to the device in one copy: one
float32 buffer holding the padded queries and then the mask.  Each
request's rows are sliced out of the device result.

The coalescer is index-agnostic: it owns request queuing and padding and
hands the search to a ``run_batch(Q_padded, q_valid, n_real)`` callable
(the server's, which binds the current :class:`~repro_torch.serve_index.
view.IndexView`).  A failed batch fails every request in it; later
batches are unaffected.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, List

import numpy as np
import torch

from .. import obs
from .config import ServeConfig

__all__ = ["QueryCoalescer"]


class _Pending:
    __slots__ = ("Q", "future", "t_submit")

    def __init__(self, Q: np.ndarray, future: Future):
        self.Q = Q
        self.future = future
        self.t_submit = time.monotonic()


def _chain_chunks(futures: List[Future]) -> Future:
    """One future resolving to the row-concatenation of chunk futures
    (for requests larger than the largest bucket)."""
    out: Future = Future()
    remaining = [len(futures)]
    lock = threading.Lock()

    def done(_):
        with lock:
            remaining[0] -= 1
            if remaining[0]:
                return
        try:
            parts = [f.result() for f in futures]
        except BaseException as e:           # noqa: BLE001 - forwarded
            out.set_exception(e)
            return
        out.set_result(parts[0]._replace(
            dist=torch.cat([p.dist for p in parts], 0),
            ids=torch.cat([p.ids for p in parts], 0),
            version=min(p.version for p in parts)))

    for f in futures:
        f.add_done_callback(done)
    return out


class QueryCoalescer:
    """Batches concurrent search requests into bucketed padded searches on
    ``device``."""

    def __init__(self, run_batch: Callable, cfg: ServeConfig,
                 device: torch.device):
        self._run_batch = run_batch
        self.cfg = cfg
        self.device = torch.device(device)
        self._pending: List[_Pending] = []
        self._pending_rows = 0
        self._cond = threading.Condition()
        self._stop = False
        self._thread: threading.Thread = threading.Thread(
            target=self._loop, name="repro-torch-serve-coalescer",
            daemon=True)

    # -- client side ---------------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Stop the worker; already-queued requests are still answered."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join()

    def submit(self, Q: np.ndarray) -> Future:
        """Enqueue ``Q (n, D)``; resolves to a ``SearchResult``.  Requests
        wider than the largest bucket are split into bucket-sized chunks
        (their results re-concatenated)."""
        maxb = self.cfg.max_batch
        if Q.shape[0] > maxb:
            futs = [self._submit_one(Q[i:i + maxb])
                    for i in range(0, Q.shape[0], maxb)]
            return _chain_chunks(futs)
        return self._submit_one(Q)

    def _submit_one(self, Q: np.ndarray) -> Future:
        fut: Future = Future()
        with self._cond:
            if self._stop:
                raise RuntimeError("coalescer is stopped")
            self._pending.append(_Pending(Q, fut))
            self._pending_rows += Q.shape[0]
            if obs.enabled():
                obs.gauge("serving_pending_queries",
                          persistent=True).set(self._pending_rows)
            self._cond.notify_all()
        return fut

    # -- worker side ---------------------------------------------------------

    def _take_batch(self) -> List[_Pending]:
        """Block until a batch is ready (window elapsed or bucket full);
        returns [] only when stopping with nothing queued."""
        maxb = self.cfg.max_batch
        with self._cond:
            while not self._pending and not self._stop:
                self._cond.wait()
            if not self._pending:
                return []
            deadline = self._pending[0].t_submit + self.cfg.coalesce_window_s
            while (not self._stop and self._pending_rows < maxb
                   and (left := deadline - time.monotonic()) > 0):
                self._cond.wait(timeout=left)
            batch, rows = [], 0
            while self._pending and rows + self._pending[0].Q.shape[0] <= maxb:
                p = self._pending.pop(0)
                rows += p.Q.shape[0]
                batch.append(p)
            self._pending_rows -= rows
            if obs.enabled():
                obs.gauge("serving_pending_queries",
                          persistent=True).set(self._pending_rows)
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                return                        # stopped and drained
            self._execute(batch)

    def _upload(self, batch: List[_Pending], n_real: int, bucket: int):
        """The padded batch and its mask on the device, in one copy."""
        D = batch[0].Q.shape[1]
        host = np.zeros(bucket * (D + 1), np.float32)
        host[:n_real * D] = np.concatenate([p.Q for p in batch],
                                           axis=0).reshape(-1)
        host[bucket * D:bucket * D + n_real] = 1.0
        buf = torch.from_numpy(host).to(self.device)
        return buf[:bucket * D].view(bucket, D), buf[bucket * D:] > 0

    def _execute(self, batch: List[_Pending]) -> None:
        n_real = sum(p.Q.shape[0] for p in batch)
        bucket = self.cfg.bucket_for(n_real)
        try:
            with obs.span("serving.batch_search") as sp:
                Qp, q_valid = self._upload(batch, n_real, bucket)
                result = self._run_batch(Qp, q_valid, n_real)
                sp.fence((result.dist, result.ids))
        except BaseException as e:            # noqa: BLE001 - forwarded
            for p in batch:
                p.future.set_exception(e)
            return
        if obs.enabled():
            obs.counter("serving_batches_total", persistent=True,
                        bucket=str(bucket)).inc()
            obs.counter("serving_queries_total", persistent=True).inc(n_real)
            # the bucket layout is part of the metric identity: servers
            # with different configs in one process get distinct series
            obs.histogram("serving_batch_queries", persistent=True,
                          q_buckets=",".join(map(str, self.cfg.q_buckets)),
                          buckets=tuple(float(b) for b in
                                        self.cfg.q_buckets)).record(n_real)
            now = time.monotonic()
            wait_h = obs.histogram("serving_coalesce_wait_seconds",
                                   persistent=True)
            for p in batch:
                wait_h.record(now - p.t_submit)
        row = 0
        for p in batch:
            n = p.Q.shape[0]
            p.future.set_result(result._replace(
                dist=result.dist[row:row + n], ids=result.ids[row:row + n]))
            row += n
