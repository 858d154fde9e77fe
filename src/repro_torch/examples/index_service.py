"""Streaming index service loop: ingest -> query -> compact -> snapshot
(the port of ``examples/index_service.py``).

    python -m repro_torch.examples.index_service [--iters N] [--chunk C] \\
        [--device cpu]
    python -m repro_torch.examples.index_service --serve [--device cpu]

Simulates the paper's §4.1 "real-time similarity search" service as a
lifecycle: quantizers bootstrapped on a historical sample, a stream of
fresh series arriving in chunks (hot segment -> sealed IVF-PQ shards),
interleaved queries, deletions of stale ids, a compaction, and a
crash-safe snapshot (:mod:`repro_torch.index.snapshot`) that a
"restarted" service restores and keeps serving from; the one-card
planner (:func:`repro_torch.index.search_sharded`) must agree with it.
It runs on the card unless given ``--device cpu``.

The service runs with the observability layer on (:mod:`repro_torch.
obs`): each round's ingest and query land in ``service.*`` spans on top of
the library's own ``index.*`` stage spans, and the exit summary reports
per-stage p50/p99 latency, the LB-cascade pruning rate and the dispatch
routing counters.

``--serve`` drives the same stream through the serving core
(:mod:`repro_torch.serve_index`): client threads submit queries that a
coalescer merges into padded batches, while ingest, deletes and a
compaction flow through the writer thread and publish immutable
snapshots.  No search waits for a seal to be published, but on the card
searches share the writer's stream, so they queue behind its kernels.
"""

import argparse
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core import measures
from repro_torch.core.pq import PQConfig
from repro_torch.data.timeseries import random_walks
from repro_torch.index import (IndexConfig, StreamingIndex,
                               restore_snapshot, save_snapshot,
                               search_sharded)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=12,
                    help="ingest/query rounds")
    ap.add_argument("--chunk", type=int, default=24,
                    help="series inserted per round")
    ap.add_argument("--length", type=int, default=96, help="series length")
    ap.add_argument("--prealign", action="store_true",
                    help="MODWT pre-aligned ingestion (§3.5): every seal "
                         "encodes through the fused prealign_encode path")
    ap.add_argument("--measure", default="dtw",
                    help="elastic measure for every stage (coarse routing, "
                         "PQ codebooks, hot-segment scan): a registry name, "
                         "optionally with params ('msm:c=0.5')")
    ap.add_argument("--no-obs", action="store_true",
                    help="leave the observability layer off (the exit "
                         "report is skipped)")
    ap.add_argument("--serve", action="store_true",
                    help="drive the stream through the serving core "
                         "(repro_torch.serve_index): coalesced concurrent "
                         "queries + writer-thread ingest")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    D = args.length
    spec = measures.resolve(args.measure)

    if not args.no_obs:
        obs.enable()
    try:
        _run(args, dev, D, spec)
    finally:
        if not args.no_obs:
            obs.disable()


def _run(args, dev, D, spec):
    # --- bootstrap the shared quantizers on a historical sample ------------
    sample = random_walks(128, D, seed=0)
    cfg = IndexConfig(
        pq=PQConfig(n_sub=4, codebook_size=32,
                    metric=spec.name, measure_params=spec.params,
                    use_prealign=args.prealign, exact_encode=args.prealign,
                    kmeans_iters=3, dba_iters=1),
        n_lists=8, hot_capacity=64, coarse_iters=4)
    t0 = time.perf_counter()
    index = StreamingIndex.bootstrap(torch.Generator().manual_seed(0),
                                     sample, cfg, device=dev)
    print(f"bootstrap: n_lists={cfg.n_lists} hot_capacity={cfg.hot_capacity}"
          f" measure={spec.label} on {dev}"
          f" ({time.perf_counter() - t0:.2f}s)")

    if args.serve:
        serve_demo(index, args)
        return

    # --- serve the stream ---------------------------------------------------
    queries = random_walks(8, D, seed=99)
    rng = np.random.default_rng(1)
    ingest_h = obs.histogram("stage_seconds", persistent=True,
                             stage="service.ingest")
    query_h = obs.histogram("stage_seconds", persistent=True,
                            stage="service.query")
    for it in range(args.iters):
        fresh = random_walks(args.chunk, D, seed=100 + it)
        t0 = time.perf_counter()
        with obs.span("service.ingest"):
            ids = index.insert(fresh)
        t_ins = time.perf_counter() - t0

        if it % 3 == 2 and index.next_id > 8:   # retire a few stale series
            stale = rng.choice(index.next_id, size=4, replace=False)
            index.delete(stale)

        t0 = time.perf_counter()
        with obs.span("service.query") as sp:
            d, nn = index.search(queries, n_probe=4, topk=3)
            sp.fence(d)
        d.cpu()
        t_q = time.perf_counter() - t0
        s = index.stats()
        print(f"round {it:02d}: +{len(ids)} ids "
              f"({len(ids) / max(t_ins, 1e-9):,.0f}/s), "
              f"query {t_q * 1e3:.1f}ms, segments={s['n_segments']} "
              f"live={s['n_live']} hot={s['hot_fill']}")

    # --- compact ------------------------------------------------------------
    index.flush()                   # seal whatever is still staged in hot
    t0 = time.perf_counter()
    index.compact()
    max_list = index.segments[0].max_list if index.segments else 0
    print(f"compact: -> {index.n_segments} segment "
          f"(max_list={max_list}) in {time.perf_counter() - t0:.2f}s")
    d, nn = index.search(queries, n_probe=4, topk=3)
    print(f"post-compact top-1 ids: {nn[:, 0].tolist()}")

    # --- snapshot, 'crash', restore, keep serving ---------------------------
    with tempfile.TemporaryDirectory() as snapdir:
        path = save_snapshot(snapdir, index)
        print(f"snapshot: {path}")
        restored = restore_snapshot(snapdir, device=dev)
        d2, nn2 = restored.search(queries, n_probe=4, topk=3)
        same = bool(torch.equal(nn, nn2))
        print(f"restore: {restored.stats()['n_live']} live rows, "
              f"search identical: {same}")
        assert same, "restored index must reproduce pre-snapshot results"

        # the planner on one card: one device, and the query batch padded
        # to four devices' blocks
        for n_dev in (1, 4):
            _, nn3 = search_sharded(restored, queries, n_probe=4, topk=3,
                                    n_devices=n_dev)
            assert torch.equal(nn2, nn3)
        print("sharded planner agrees with single-device search")

    mem = index.memory_cost()
    print(f"memory: index {mem['index_bytes'] / 1e3:.1f}KB vs raw "
          f"{mem['raw_bytes'] / 1e3:.1f}KB "
          f"({mem['compression']:.1f}x codes-only compression)")

    # --- exit observability summary ------------------------------------------
    if obs.enabled() and ingest_h.count and query_h.count:
        print()
        print(f"service ingest p50/p99: {ingest_h.percentile(50) * 1e3:.1f}"
              f"ms / {ingest_h.percentile(99) * 1e3:.1f}ms "
              f"over {ingest_h.count} rounds")
        print(f"service query  p50/p99: {query_h.percentile(50) * 1e3:.1f}"
              f"ms / {query_h.percentile(99) * 1e3:.1f}ms "
              f"over {query_h.count} rounds")
        print()
        print(obs.render(obs.snapshot(), title="index service obs summary"))


def serve_demo(index, args):
    """--serve: concurrent clients + ingest through the serving core."""
    from repro_torch.serve_index import Backpressure, IndexServer, ServeConfig

    D = args.length
    queries = random_walks(8, D, seed=99)
    scfg = ServeConfig(n_probe=4, topk=3, q_buckets=(1, 2, 4, 8))
    answered = []
    client_errors = []
    stop = threading.Event()

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            rows = rng.choice(len(queries), size=int(rng.integers(1, 4)),
                              replace=False)
            try:
                _, ids = srv.search(queries[rows])
            except Exception as exc:      # surface, don't swallow
                client_errors.append(exc)
                return
            answered.append(ids.shape[0])

    t0 = time.perf_counter()
    with IndexServer(index, scfg) as srv:
        for b in scfg.q_buckets:    # reach each padded bucket once
            srv.search(queries[:b])
        print(f"serve: warmed {len(scfg.q_buckets)} query buckets "
              f"({time.perf_counter() - t0:.2f}s)")

        clients = [threading.Thread(target=client, args=(7 + i,))
                   for i in range(3)]
        for t in clients:
            t.start()
        shed = 0
        t0 = time.perf_counter()
        for it in range(args.iters):
            fresh = random_walks(args.chunk, D, seed=200 + it)
            try:
                srv.insert(fresh).result()      # resolved == visible
            except Backpressure:
                shed += 1
                continue
            if it % 3 == 2:
                srv.delete(np.arange(it, it + 3))
            if it == args.iters // 2:
                # seal the staged rows so later searches take the full
                # coarse -> LUT -> fine sealed path, then merge segments
                srv.flush().result()
                srv.compact().result()
        wall = time.perf_counter() - t0
        stop.set()
        for t in clients:
            t.join()
        version = srv.quiesce()
        st = srv.stats()
        n_live = int(srv.view.n_live())

    if client_errors:
        raise client_errors[0]
    n_q = sum(answered)
    print(f"serve: {len(answered)} requests / {n_q} queries from 3 clients "
          f"({n_q / max(wall, 1e-9):,.0f} q/s) alongside "
          f"{args.iters} ingest rounds, {shed} shed")
    print(f"serve: view version {version}, {n_live} live rows, "
          f"write queue {st['write_queue_depth']} "
          f"(pressure {st['pressure']:.2f})")
    assert n_q > 0 and st["version"] == version

    if obs.enabled():
        print()
        print(obs.render(obs.snapshot(), title="serving obs summary"))


if __name__ == "__main__":
    main()
