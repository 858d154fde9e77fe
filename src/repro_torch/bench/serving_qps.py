"""Closed-loop serving benchmark on the port: sustained mixed traffic
through the coalescing :class:`~repro_torch.serve_index.IndexServer` (the
torch leg of ``benchmarks/serving_qps.py``).

Concurrent client threads submit small search requests (1-4 queries) in
a closed loop while, in the ``mixed`` scenario, an ingest thread inserts,
deletes and compacts through the bounded write queue, for a fixed wall
time.  Per scenario (``read_only``, ``mixed``):

* achieved QPS (completed queries / wall time) and per-request p50/p99
  latency, coalescing wait included, so the numbers are end to end;
* write throughput, shed count, view swaps, and the mean coalesced batch
  (from the serving obs counters);
* ``stage_s``: the seconds each obs stage span recorded during the
  scenario (search stages, the writer's apply, snapshot swaps).  A span's
  fence waits for the whole device, so under load each stage also holds
  the other threads' work in flight: a breakdown of where the threads
  wait, not of the card's own time.

The sizes are the reference's: 8192 random walks of length 128, 8
clients, 10 s by default; ``--quick`` 1024 x 96, 4 clients, 3 s;
``--smoke`` 192 x 48, 2 clients, 0.6 s.  The record goes to
``experiments/bench/hw_<cuda|cpu>_serving_qps.json``.

    python -m repro_torch.bench.serving_qps [--quick | --smoke] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from .. import _device, obs
from ..core.pq import PQConfig
from ..data.timeseries import random_walks
from ..index import IndexConfig, StreamingIndex
from ..serve_index import Backpressure, IndexServer, ServeConfig
from ._writer import Bench, OUT_DIR, device_args

__all__ = ["run", "main", "SIZES"]

# (n_rows, dim, duration_s, clients) of the reference's three sizes
SIZES = {"full": (8192, 128, 10.0, 8), "quick": (1024, 96, 3.0, 4),
         "smoke": (192, 48, 0.6, 2)}


def _build(n_rows: int, dim: int, n_lists: int, hot_capacity: int,
           device: torch.device) -> StreamingIndex:
    cfg = IndexConfig(
        pq=PQConfig(n_sub=4, codebook_size=32, use_prealign=False,
                    kmeans_iters=3, dba_iters=1),
        n_lists=n_lists, hot_capacity=hot_capacity, coarse_iters=4)
    index = StreamingIndex.bootstrap(
        torch.Generator().manual_seed(0),
        random_walks(min(n_rows, 512), dim, seed=0), cfg, device=device)
    index.insert(random_walks(n_rows, dim, seed=1))
    index.compact()
    return index


def _counter_value(name: str, **labels) -> int:
    return obs.counter(name, persistent=True, **labels).value


def _batches_total() -> int:
    return sum(c["value"] for c in obs.snapshot()["counters"]
               if c["name"] == "serving_batches_total")


def _stage_seconds() -> dict:
    return {h["labels"]["stage"]: h["sum"]
            for h in obs.snapshot()["histograms"]
            if h["name"] == "stage_seconds"}


def _drive(srv: IndexServer, Q: np.ndarray, dim: int, duration_s: float,
           n_clients: int, ingest: bool) -> dict:
    """Run the closed loop for ``duration_s``; returns the scenario row."""
    deadline = time.monotonic() + duration_s
    lock = threading.Lock()
    latencies: list = []
    totals = {"queries": 0, "inserted": 0, "deleted": 0, "shed": 0}
    errors: list = []
    q0 = _counter_value("serving_queries_total")
    b0 = _batches_total()
    s0 = _stage_seconds()
    v0 = srv.version

    def client(seed: int) -> None:
        rng = np.random.default_rng(seed)
        mine, done = [], 0
        while time.monotonic() < deadline:
            n = int(rng.integers(1, 5))
            q = Q[rng.integers(0, len(Q), size=n)]
            t0 = time.perf_counter()
            srv.submit_search(q).result()
            mine.append(time.perf_counter() - t0)
            done += n
        with lock:
            latencies.extend(mine)
            totals["queries"] += done

    def ingester() -> None:
        rng = np.random.default_rng(4242)
        resident: list = []
        it = 0
        while time.monotonic() < deadline:
            it += 1
            try:
                if resident and rng.random() < 0.35:
                    k = min(8, len(resident))
                    victims, resident[:k] = resident[:k], []
                    srv.delete(victims).result()
                    totals["deleted"] += k
                else:
                    ids = srv.insert(
                        rng.standard_normal((8, dim)).astype(np.float32)
                    ).result()
                    resident.extend(int(i) for i in ids)
                    totals["inserted"] += len(ids)
                if it % 32 == 0:
                    srv.compact().result()
            except Backpressure:
                totals["shed"] += 1
                time.sleep(0.001)

    def guarded(fn, *args):
        try:
            fn(*args)
        except BaseException as e:               # noqa: BLE001 - re-raised
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(client, s))
               for s in range(n_clients)]
    if ingest:
        threads.append(threading.Thread(target=guarded, args=(ingester,)))
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    srv.quiesce()
    if errors:
        raise errors[0]

    n_batches = _batches_total() - b0
    n_batched = _counter_value("serving_queries_total") - q0
    stage_s = {k: v - s0.get(k, 0.0) for k, v in _stage_seconds().items()
               if v > s0.get(k, 0.0)}
    return dict(
        wall_s=wall,
        qps=totals["queries"] / wall,
        p50_ms=1e3 * obs.percentile(latencies, 50.0),
        p99_ms=1e3 * obs.percentile(latencies, 99.0),
        requests=len(latencies),
        queries=totals["queries"],
        mean_coalesced=(n_batched / n_batches) if n_batches else 0.0,
        inserted=totals["inserted"],
        deleted=totals["deleted"],
        shed=totals["shed"],
        view_swaps=srv.version - v0,
        view_version=srv.version,
        stage_s=dict(sorted(stage_s.items())),
    )


def run(size: str = "full", device: _device.DeviceArg = None,
        out_dir: str = OUT_DIR) -> Bench:
    """Both scenarios at ``size`` (a key of :data:`SIZES`) on ``device``;
    returns the saved :class:`Bench`."""
    dev = _device.resolve_device(device)
    n_rows, dim, duration, clients = SIZES[size]
    bench = Bench("serving_qps", dev, out_dir)
    scfg = ServeConfig(n_probe=4, topk=3)
    with obs.override(True):            # the bench reads serving counters
        for scenario, ingest in (("read_only", False), ("mixed", True)):
            index = _build(n_rows, dim, n_lists=8,
                           hot_capacity=max(64, dim), device=dev)
            Q = random_walks(64, dim, seed=9)
            with IndexServer(index, scfg) as srv:
                # reach every bucket the traffic can coalesce into (each
                # client submits <= 4 queries), so steady state is measured
                reachable = [b for b in scfg.q_buckets
                             if b <= 4 * clients] or [scfg.q_buckets[0]]
                for n in reachable:
                    srv.submit_search(Q[:n]).result()
                row = _drive(srv, Q, dim, duration, clients, ingest)
            bench.add(scenario=scenario, n_rows=n_rows, dim=dim,
                      clients=clients, **row)

    mixed = next(r for r in bench.rows if r["scenario"] == "mixed")
    bench.save(headline=dict(
        size=size, measure="dtw",
        scenario="mixed insert/query/delete, closed loop",
        duration_s=duration, clients=clients, qps=mixed["qps"],
        p50_ms=mixed["p50_ms"], p99_ms=mixed["p99_ms"],
        shed=mixed["shed"]))
    return bench


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--quick", action="store_true",
                       help="the reference's quick size")
    group.add_argument("--smoke", action="store_true",
                       help="the reference's smoke size")
    device_args(ap)
    args = ap.parse_args(argv)
    size = "quick" if args.quick else "smoke" if args.smoke else "full"
    run(size, args.device, args.out)


if __name__ == "__main__":
    main()
