"""The port's serving core (``repro_torch.serve_index``, CPU route) against
the contract of ``tests/test_serving.py`` and against the JAX package.

Searches made during a concurrent insert/seal/compact storm are
bit-identical to searching the snapshot they report; a completed write
is visible; a view is immune to later writes; the three shed policies;
coalescing into one bucket and chunking of oversized requests; the warm
replay gate (``dispatch.stats`` per request, counted per call); graceful
stop, metrics and spans.  One parity case runs the same operations
through the JAX ``IndexServer`` and the port's: ids equal, distances
within ``rtol=1e-5, atol=1e-4``.  The quantizers are the JAX package's,
carried across by ``from_parts``.  Also: the dispatch ledger keeps exact
totals under eight threads.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import pq as jpq
from repro.data.timeseries import cbf
from repro import index as jindex
from repro import serve_index as jserve
from repro_torch import obs
from repro_torch.bench.warm_replay import warm_replay
from repro_torch.core import dispatch
from repro_torch.core import pq as tpq
from repro_torch.core.measures import resolve
from repro_torch.index import IndexConfig, StreamingIndex
from repro_torch.kernels import _build
from repro_torch.serve_index import (SHED_POLICIES, Backpressure,
                                     IndexServer, ServeConfig)

TOL = dict(rtol=1e-5, atol=1e-4)
PQ_KW = dict(n_sub=4, codebook_size=8, use_prealign=False, kmeans_iters=2,
             dba_iters=1)
IDX_KW = dict(n_lists=4, hot_capacity=12, coarse_iters=3)


@pytest.fixture(scope="module")
def data():
    X, _ = cbf(n_per_class=12, length=48, seed=0)    # 36 series
    Q, _ = cbf(n_per_class=2, length=48, seed=7)     # 6 queries
    return X.astype(np.float32), Q.astype(np.float32)


@pytest.fixture(scope="module")
def booted(data):
    """Quantizers trained by the JAX package (pure-JAX route)."""
    X, _ = data
    jcfg = jindex.IndexConfig(pq=jpq.PQConfig(**PQ_KW), **IDX_KW)
    with jdispatch.use_backend("jax"):
        return jindex.StreamingIndex.bootstrap(jax.random.PRNGKey(0), X,
                                               jcfg)


def _fresh(booted):
    cfg = IndexConfig(pq=tpq.PQConfig(**PQ_KW), **IDX_KW)
    return StreamingIndex.from_parts(cfg, np.asarray(booted.coarse),
                                     booted.cb, booted.dim, device="cpu")


@pytest.fixture
def obs_on():
    with obs.override(True):
        yield


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

class TestServeConfig:
    def test_bucket_for(self):
        cfg = ServeConfig()
        assert [cfg.bucket_for(n) for n in (1, 2, 3, 5, 64)] == \
            [1, 2, 4, 8, 64]
        with pytest.raises(ValueError):
            cfg.bucket_for(65)
        with pytest.raises(ValueError):
            cfg.bucket_for(0)

    @pytest.mark.parametrize("kw", [
        dict(q_buckets=(4, 2)), dict(q_buckets=()), dict(q_buckets=(0, 1)),
        dict(shed_policy="drop_tables"), dict(queue_bound=0),
        dict(coalesce_window_s=-1.0), dict(n_probe=0), dict(topk=0),
        dict(apply_batch=0)])
    def test_validation(self, kw):
        with pytest.raises(ValueError):
            ServeConfig(**kw)

    def test_shed_policies_are_the_references(self):
        assert SHED_POLICIES == jserve.SHED_POLICIES
        assert set(SHED_POLICIES) == {"shed_inserts", "shed_all", "block"}

    def test_server_rejects_n_probe_beyond_lists(self, booted):
        with pytest.raises(ValueError, match="n_probe"):
            IndexServer(_fresh(booted), ServeConfig(n_probe=5))


# ---------------------------------------------------------------------------
# bit-identical searches under a concurrent write storm
# ---------------------------------------------------------------------------

class TestConcurrentBitIdentity:
    @pytest.mark.parametrize("window", [0.001, 0.0])
    def test_search_during_storm_bit_identical(self, data, booted, window):
        """Client threads search while the writer seals, compacts and
        deletes.  Each result is searched again afterwards on the retained
        view it reports (its rows alone, unpadded): ids and distances equal
        bit for bit."""
        X, Q = data
        idx = _fresh(booted)
        idx.insert(X[:24])
        views = {}
        results = []
        res_lock = threading.Lock()
        cfg = ServeConfig(n_probe=4, topk=3, coalesce_window_s=window)

        def searcher(seed):
            rng = np.random.default_rng(seed)
            for _ in range(5):
                rows = rng.integers(0, len(Q), size=int(rng.integers(1, 4)))
                q = Q[rows]
                r = srv.submit_search(q).result(timeout=120)
                with res_lock:
                    results.append((q, r))

        with IndexServer(idx, cfg, on_publish=lambda v:
                         views.setdefault(v.version, v)) as srv:
            views[srv.view.version] = srv.view
            threads = [threading.Thread(target=searcher, args=(s,))
                       for s in range(3)]
            for t in threads:
                t.start()
            storm = [srv.insert(X[24:]), srv.delete([1, 5, 17]),
                     srv.flush(), srv.insert(X[:6] + 0.25),
                     srv.compact(), srv.delete([2])]
            for f in storm:
                f.result(timeout=120)
            for t in threads:
                t.join()
            srv.quiesce(timeout=120)

        assert len(results) == 15
        assert len(views) >= 2
        for q, r in results:
            d_ref, i_ref = views[r.version].search(q, n_probe=4, topk=3)
            assert torch.equal(r.ids, i_ref)
            assert torch.equal(r.dist, d_ref)

    def test_completed_write_is_visible(self, data, booted):
        X, _ = data
        idx = _fresh(booted)
        with IndexServer(idx, ServeConfig(n_probe=4, topk=1,
                                          coalesce_window_s=0.0)) as srv:
            ids = srv.insert(X[:10]).result(timeout=120)
            _, nn = srv.search(X[:3], timeout=120)
            assert set(nn[:, 0].tolist()) <= set(ids.tolist())
            assert srv.delete(ids[:2]).result(timeout=120) == 2
            _, nn2 = srv.search(X[:3], timeout=120)
            assert not set(nn2[:, 0].tolist()) & set(ids[:2].tolist())

    def test_view_is_immune_to_later_writes(self, data, booted):
        """A captured view answers the same after the hot buffer it copied
        is changed and sealed, and its hot copy shares no memory with the
        writer's staging arrays or the index's cached upload."""
        X, Q = data
        idx = _fresh(booted)
        with IndexServer(idx, ServeConfig(n_probe=4, topk=2,
                                          coalesce_window_s=0.0)) as srv:
            srv.insert(X[:8]).result(timeout=120)     # hot-only state
            view = srv.view
            cached = idx._hot_arrays()
            for mine, staged, up in zip(view.hot, (idx.hot.data, idx.hot.ids,
                                                   idx.hot.live), cached):
                assert mine.data_ptr() != up.data_ptr()
                assert not np.shares_memory(mine.numpy(), staged)
            d0, i0 = view.search(Q, n_probe=4, topk=2)
            srv.insert(X[8:30]).result(timeout=120)   # mutates + seals hot
            srv.compact().result(timeout=120)
            d1, i1 = view.search(Q, n_probe=4, topk=2)
            assert torch.equal(i0, i1) and torch.equal(d0, d1)
            assert view.n_live() == 8


# ---------------------------------------------------------------------------
# admission control / backpressure
# ---------------------------------------------------------------------------

class TestBackpressure:
    def _wedged(self, booted, **kw):
        """A server whose writer never drains (not started): the bounded
        queue fills deterministically."""
        srv = IndexServer(_fresh(booted), ServeConfig(**kw))
        srv._started = True
        return srv

    def test_shed_inserts_full_queue(self, booted, obs_on):
        srv = self._wedged(booted, queue_bound=2, shed_policy="shed_inserts")
        X = np.zeros((1, booted.dim), np.float32)
        srv.flush(), srv.flush()
        assert srv.pressure() == 1.0
        before = obs.counter("serving_shed_total", persistent=True,
                             op="insert").value
        with pytest.raises(Backpressure):
            srv.insert(X)
        assert obs.counter("serving_shed_total", persistent=True,
                           op="insert").value == before + 1

    def test_shed_inserts_admits_deletes(self, booted):
        srv = self._wedged(booted, queue_bound=2, shed_policy="shed_inserts")
        srv.flush()
        fut = srv.delete([0])
        assert not fut.done()
        assert srv._wq.qsize() == 2

    def test_shed_all_sheds_deletes_too(self, booted, obs_on):
        srv = self._wedged(booted, queue_bound=1, shed_policy="shed_all")
        srv.flush()
        before = obs.counter("serving_shed_total", persistent=True,
                             op="delete").value
        with pytest.raises(Backpressure):
            srv.delete([0])
        assert obs.counter("serving_shed_total", persistent=True,
                           op="delete").value == before + 1

    def test_block_policy_blocks_until_drained(self, booted):
        srv = self._wedged(booted, queue_bound=1, shed_policy="block")
        srv.flush()
        X = np.zeros((1, booted.dim), np.float32)
        t = threading.Thread(target=lambda: srv.insert(X), daemon=True)
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive()                       # blocked, not shed
        srv._wq.get()                             # writer-side drain
        t.join(timeout=10)
        assert not t.is_alive()

    def test_rejects_writes_when_not_running(self, booted):
        srv = IndexServer(_fresh(booted), ServeConfig())
        with pytest.raises(RuntimeError):
            srv.insert(np.zeros((1, booted.dim), np.float32))

    def test_search_validates_shape(self, booted):
        srv = IndexServer(_fresh(booted), ServeConfig())
        srv._started = True
        with pytest.raises(ValueError):
            srv.submit_search(np.zeros((2, booted.dim + 1), np.float32))
        with pytest.raises(ValueError):
            srv.submit_search(np.zeros((0, booted.dim), np.float32))


# ---------------------------------------------------------------------------
# coalescer: bucketing, windowing, the warm path
# ---------------------------------------------------------------------------

class TestCoalescer:
    def test_concurrent_requests_coalesce_into_one_bucket(self, data,
                                                          booted, obs_on):
        """Three 1-query requests inside one window search as one padded
        bucket-4 batch against one snapshot, each equal to its own rows'
        search."""
        X, Q = data
        idx = _fresh(booted)
        idx.insert(X[:16])
        cfg = ServeConfig(n_probe=2, topk=1, coalesce_window_s=0.25)
        with IndexServer(idx, cfg) as srv:
            before = obs.counter("serving_batches_total", persistent=True,
                                 bucket="4").value
            futs = [srv.submit_search(Q[i:i + 1]) for i in range(3)]
            rs = [f.result(timeout=120) for f in futs]
            after = obs.counter("serving_batches_total", persistent=True,
                                bucket="4").value
            view = srv.view
        assert after == before + 1
        assert len({r.version for r in rs}) == 1
        for i, r in enumerate(rs):
            assert tuple(r.dist.shape) == (1, 1) == tuple(r.ids.shape)
            d, ids = view.search(Q[i:i + 1], n_probe=2, topk=1)
            assert torch.equal(r.ids, ids) and torch.equal(r.dist, d)

    def test_oversized_request_is_chunked(self, data, booted):
        """Requests wider than the largest bucket split into chunks whose
        re-concatenated rows equal the direct index search bit for bit."""
        X, Q = data
        idx = _fresh(booted)
        idx.insert(X[:20])
        idx.flush()
        d_direct, i_direct = idx.search(Q, n_probe=2, topk=2)
        cfg = ServeConfig(n_probe=2, topk=2, coalesce_window_s=0.0,
                          q_buckets=(1, 2, 4))
        with IndexServer(idx, cfg) as srv:
            r = srv.submit_search(Q).result(timeout=120)   # 6 > bucket 4
        assert tuple(r.dist.shape) == (6, 2)
        assert torch.equal(r.ids, i_direct) and torch.equal(r.dist, d_direct)

    def test_padded_batch_rows_are_inert(self, data, booted):
        """The padded rows of a bucket come back inf / -1 and the real rows
        equal the unpadded search."""
        X, Q = data
        idx = _fresh(booted)
        idx.insert(X[:20])
        with IndexServer(idx, ServeConfig(n_probe=2, topk=3)) as srv:
            view = srv.view
        Qp = np.concatenate([Q[:3], np.zeros((5, Q.shape[1]), np.float32)])
        q_valid = torch.arange(8) < 3
        d, i = view.search(Qp, n_probe=2, topk=3, q_valid=q_valid)
        d0, i0 = view.search(Q[:3], n_probe=2, topk=3)
        assert torch.equal(i[:3], i0) and torch.equal(d[:3], d0)
        assert bool(torch.isinf(d[3:]).all()) and bool((i[3:] == -1).all())

    def test_warm_replay_gate(self, data, booted):
        """After a warm pass over every bucket, two serial replays give the
        same dispatch calls per request size (the CPU route counts every
        call), build nothing and load nothing."""
        X, Q = data
        idx = _fresh(booted)
        idx.insert(X[:20])
        idx.flush()
        cfg = ServeConfig(n_probe=2, topk=1, coalesce_window_s=0.0,
                          q_buckets=(1, 2, 4))
        with IndexServer(idx, cfg) as srv:
            report = warm_replay(srv, Q)
        assert report["ok"], report["failures"]
        assert report["sizes"] == [1, 2, 3, 4]
        assert not report["lib_loaded"]
        assert report["reserved_bytes"] == [0, 0]
        for n in report["sizes"]:
            calls = report["dispatch"][n]
            assert calls and all(k.endswith("'torch')") for k in calls)
            assert not report["launches"][n]      # no kernel on the CPU

    @pytest.mark.parametrize("change", ["dispatch", "load"])
    def test_warm_replay_catches_a_change(self, data, booted, monkeypatch,
                                          change):
        """The gate fails when the last replay dispatches differently or
        loads the kernel library: every coarse search of it makes one
        extra dispatch call, or the library appears loaded."""
        X, Q = data
        idx = _fresh(booted)
        idx.insert(X[:20])
        idx.flush()
        cfg = ServeConfig(n_probe=2, topk=1, coalesce_window_s=0.0,
                          q_buckets=(1, 2))
        calls = {"n": 0}
        from repro_torch.index import streaming
        real = streaming.coarse_dists

        def coarse(*a, **kw):
            calls["n"] += 1
            if calls["n"] > 4:                    # warm-up + first replay
                if change == "dispatch":
                    dispatch._count("elastic_cdist", "torch")
                else:
                    _build._lib = object()
            return real(*a, **kw)

        monkeypatch.setattr(streaming, "coarse_dists", coarse)
        monkeypatch.setattr(_build, "_lib", None)
        with IndexServer(idx, cfg) as srv:
            report = warm_replay(srv, Q, sizes=[1, 2])
        assert not report["ok"]
        if change == "dispatch":
            assert any("launches differ" in f for f in report["failures"])
        else:
            assert report["failures"] == ["the kernel library was loaded "
                                          "during a replay"]

    def test_graceful_stop_answers_queued_requests(self, data, booted):
        X, Q = data
        idx = _fresh(booted)
        idx.insert(X[:12])
        cfg = ServeConfig(n_probe=2, topk=1, coalesce_window_s=0.2)
        srv = IndexServer(idx, cfg).start()
        futs = [srv.submit_search(Q[:2]) for _ in range(3)]
        srv.stop()
        for f in futs:
            assert tuple(f.result(timeout=5).ids.shape) == (2, 1)
        with pytest.raises(RuntimeError):
            srv.submit_search(Q[:1])


# ---------------------------------------------------------------------------
# serving telemetry
# ---------------------------------------------------------------------------

class TestServingObs:
    def test_serving_metrics_populate(self, data, booted, obs_on):
        X, Q = data
        idx = _fresh(booted)
        q0 = obs.counter("serving_queries_total", persistent=True).value
        with IndexServer(idx, ServeConfig(n_probe=2, topk=1,
                                          coalesce_window_s=0.0)) as srv:
            srv.insert(X[:16]).result(timeout=120)
            srv.search(Q[:2], timeout=120)
            st = srv.stats()
        assert obs.counter("serving_queries_total",
                           persistent=True).value >= q0 + 2
        assert obs.counter("serving_view_swaps_total",
                           persistent=True).value >= 1
        assert obs.gauge("serving_view_version",
                         persistent=True).value >= 1
        assert obs.histogram("serving_snapshot_swap_seconds",
                             persistent=True).count >= 1
        assert obs.histogram("serving_coalesce_wait_seconds",
                             persistent=True).count >= 1
        assert st["version"] >= 1 and st["n_segments"] == 1

    def test_serving_spans_recorded(self, data, booted, obs_on):
        X, Q = data
        idx = _fresh(booted)
        with IndexServer(idx, ServeConfig(n_probe=2, topk=1,
                                          coalesce_window_s=0.0)) as srv:
            srv.insert(X[:16]).result(timeout=120)
            srv.search(Q[:2], timeout=120)
        snap = obs.snapshot()
        stages = {h["labels"].get("stage") for h in snap["histograms"]
                  if h["name"] == "stage_seconds"}
        names = {c["name"] for c in snap["counters"]} | {
            g["name"] for g in snap["gauges"]} | {
            h["name"] for h in snap["histograms"]}
        assert {"serving.apply", "serving.snapshot_swap",
                "serving.batch_search"} <= stages
        assert {"serving_batches_total", "serving_queries_total",
                "serving_batch_queries", "serving_pending_queries",
                "serving_write_queue_depth"} <= names


# ---------------------------------------------------------------------------
# the JAX package's server on the same operations
# ---------------------------------------------------------------------------

def test_parity_with_the_reference_server(data, booted):
    """Serial writes through both servers (each resolved before the next),
    a search after each: ids equal, distances within tolerance."""
    X, Q = data
    j = jindex.StreamingIndex.from_parts(booted.cfg, booted.coarse,
                                         booted.cb, booted.dim)
    t = _fresh(booted)
    steps = [("insert", (X[:20],)), ("delete", ([1, 5, 17],)),
             ("insert", (X[20:30] + 0.25,)), ("flush", ()),
             ("compact", ()), ("delete", ([2, 21],))]
    jcfg = jserve.ServeConfig(n_probe=3, topk=3, coalesce_window_s=0.0)
    tcfg = ServeConfig(n_probe=3, topk=3, coalesce_window_s=0.0)
    with jdispatch.use_backend("jax"), jserve.IndexServer(j, jcfg) as js, \
            IndexServer(t, tcfg) as ts:
        for op, args in steps:
            want = getattr(js, op)(*args).result(timeout=120)
            got = getattr(ts, op)(*args).result(timeout=120)
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(want))
            jd, ji = js.search(Q, timeout=120)
            td, ti = ts.search(Q, timeout=120)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
        assert js.version == ts.version


# ---------------------------------------------------------------------------
# counters shared by the server's threads
# ---------------------------------------------------------------------------

def test_dispatch_count_is_exact_under_threads():
    """Eight threads hammer ``dispatch._count``: the ledgers and the obs
    counter gain exactly the calls made."""
    spec = resolve("msm")
    key, mkey = ("hammer_op", "torch"), ("hammer_op[msm]", "torch")
    counter = obs.REGISTRY.counter("dispatch_total", persistent=True,
                                   op="hammer_op", backend="torch",
                                   kind="call", measure="msm")
    t0, m0 = dispatch.totals.get(key, 0), dispatch.totals.get(mkey, 0)
    c0 = counter.value
    n_threads, n_calls = 8, 4000
    start = threading.Barrier(n_threads)

    def hammer():
        start.wait()
        for _ in range(n_calls):
            dispatch._count("hammer_op", "torch", spec)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    total = n_threads * n_calls
    assert dispatch.totals[key] == t0 + total
    assert dispatch.totals[mkey] == m0 + total
    assert counter.value == c0 + total
    dispatch.stats.pop(key, None)
    dispatch.stats.pop(mkey, None)


def test_launch_count_is_exact_under_threads():
    """``_build.count_launch`` from eight threads loses no increment."""
    before = _build.LAUNCHES["dtw_band"]

    def hammer():
        for _ in range(4000):
            _build.count_launch("dtw_band")

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert _build.LAUNCHES["dtw_band"] == before + 8 * 4000
    _build.LAUNCHES["dtw_band"] = before


def test_library_loads_once_under_threads(monkeypatch):
    """Eight threads asking for the kernel library at once load it once
    (the loader is faked: no compiler here)."""
    loads = []

    class _Fn:
        pass

    class FakeCDLL:
        def __init__(self, path):
            loads.append(path)
            time.sleep(0.05)              # a slow load invites a race

        def __getattr__(self, name):
            fn = _Fn()
            self.__dict__[name] = fn
            return fn

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: "libfake.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeCDLL)
    got = []
    start = threading.Barrier(8)

    def load():
        start.wait()
        got.append(_build.lib())

    threads = [threading.Thread(target=load) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert loads == ["libfake.so"]
    assert len(got) == 8 and all(h is got[0] for h in got)
