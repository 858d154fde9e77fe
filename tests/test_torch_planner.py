"""The port's query padding and one-card planner
(``repro_torch.index.planner``, CPU route) against the JAX package and
against the port's own single-device search: the counterparts of
``TestQueryValidMask`` and the single-device ``TestListShardedPlanner``
cases of ``tests/test_sharded.py``.

Masked query rows are inert (``inf`` / ``-1``, no refine work) and leave
the real rows as the JAX package's unpadded search gives them;
``SealedSegment.shard_views`` equals the reference's on the same seal; the
``"queries"``, ``"lists"`` and ``"auto"`` plans equal the direct search
for 1, 2 and 4 devices on one card; a layout that disagrees with the
device count raises; and ``search_sharded`` on one device equals the JAX
package's on its one-device CPU mesh.  Ids identical; distances within
``rtol=1e-5, atol=1e-4`` against the JAX package, bit for bit against the
port's own direct search.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import lb_search as jlb_search
from repro.core import pq as jpq
from repro.data.timeseries import cbf
from repro import index as jindex
from repro.index import segments as jsegments
from repro_torch.core import lb_search as tlb_search
from repro_torch.core import pq as tpq
from repro_torch import index as tindex
from repro_torch.index import search_sharded
from repro_torch.index import segments as tsegments
from repro_torch.index.streaming import search_impl

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


def _pair(booted, **kw):
    jcfg = dataclasses.replace(booted.cfg, **kw)
    tcfg = tindex.IndexConfig(pq=tpq.PQConfig(**PQ_KW), **{**IDX_KW, **kw})
    j = jindex.StreamingIndex.from_parts(jcfg, booted.coarse, booted.cb,
                                         booted.dim)
    t = tindex.StreamingIndex.from_parts(tcfg, np.asarray(booted.coarse),
                                         booted.cb, booted.dim, device="cpu")
    return j, t


def _fresh(booted, **kw):
    return _pair(booted, **kw)[1]


def _padded(Q, pad):
    Qp = np.concatenate([Q, np.zeros((pad, Q.shape[1]), Q.dtype)])
    return Qp, np.arange(len(Qp)) < len(Q)


def _same(got, want):
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
    np.testing.assert_allclose(np.asarray(gd), np.asarray(wd), **TOL)


def _identical(got, want):
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# ---------------------------------------------------------------------------
# query padding
# ---------------------------------------------------------------------------

class TestQueryValidMask:
    @pytest.mark.parametrize("measure", [None, "msm"])
    def test_masked_rows_inert(self, data, measure):
        """Padded query rows return inf / -1, leave the real rows as the
        JAX package's unpadded search gives them, and claim no refine
        work."""
        X, Q = data
        Qp, q_valid = _padded(Q, 3)
        with jdispatch.use_backend("jax"):
            jd, ji, _ = jlb_search.filtered_topk(
                jnp.asarray(Q), jnp.asarray(X), 5, 4, measure=measure)
        d, i, st = tlb_search.filtered_topk(
            torch.from_numpy(Qp), torch.from_numpy(X), 5, 4,
            measure=measure, q_valid=torch.from_numpy(q_valid),
            with_stats=True)
        _same((d[:len(Q)], i[:len(Q)]), (jd, ji))
        assert bool(torch.isinf(d[len(Q):]).all())
        assert bool((i[len(Q):] == -1).all())
        assert int(st["n_bounded"]) == len(Q) * len(X)
        assert int(st["n_refined"]) <= len(Q) * len(X)

    @pytest.mark.parametrize("euclidean", [False, True])
    def test_search_impl_padding(self, data, booted, euclidean):
        """``search_impl`` with ``q_valid`` over sealed segments and the hot
        buffer: the real rows equal the JAX package's masked search and the
        port's unpadded one; the padded rows are inf / -1; the hot scan's
        statistics count the real queries only."""
        X, Q = data
        kw = dict(pq=tpq.PQConfig(**PQ_KW, metric="euclidean")) \
            if euclidean else {}
        t = _fresh(booted)
        if euclidean:
            t = tindex.StreamingIndex.from_parts(
                dataclasses.replace(t.cfg, **kw), t.coarse, t.cb, t.dim,
                device="cpu")
        t.insert(X[:30])
        t.delete([3, 27])
        Qp, q_valid = _padded(Q, 2)
        args = (t.coarse, t.cb, tuple(t.segments), t._hot_arrays())
        kws = dict(icfg=t.cfg, n_probe=3, topk=4, dim=t.dim)
        d, i, st = search_impl(*args, torch.from_numpy(Qp),
                               q_valid=torch.from_numpy(q_valid),
                               with_stats=True, **kws)
        d0, i0, st0 = search_impl(*args, torch.from_numpy(Q),
                                  with_stats=True, **kws)
        _identical((d[:len(Q)], i[:len(Q)]), (d0, i0))
        assert bool(torch.isinf(d[len(Q):]).all())
        assert bool((i[len(Q):] == -1).all())
        assert int(st["n_bounded"]) == int(st0["n_bounded"])
        if not euclidean:
            j, _ = _pair(booted)
            j.insert(X[:30])
            j.delete([3, 27])
            with jdispatch.use_backend("jax"):
                jd, ji = j.search(Q, n_probe=3, topk=4)
            _same((d[:len(Q)], i[:len(Q)]), (jd, ji))

    def test_sharded_padding_excluded_from_hot_scan(self, data, booted):
        """search_sharded on a batch that does not divide (hot rows only,
        so the whole result comes from the masked scan) equals the
        unpadded direct search."""
        X, Q = data
        idx = _fresh(booted)
        idx.insert(X[:8])
        want = idx.search(Q[:3], n_probe=2, topk=4)
        for n_dev in (2, 4):
            _identical(search_sharded(idx, Q[:3], n_probe=2, topk=4,
                                      partition="queries",
                                      n_devices=n_dev), want)


# ---------------------------------------------------------------------------
# the shard-major layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_views_equal_the_references(n_shards):
    rng = np.random.default_rng(n_shards)
    n, M, n_lists = 40, 4, 6
    codes = rng.integers(0, 8, size=(n, M)).astype(np.int32)
    ids = rng.permutation(100)[:n].astype(np.int32)
    assign = rng.integers(0, n_lists, size=n).astype(np.int32)
    kw = dict(n_shards=n_shards, shard_round=3)
    want = jsegments.seal(codes, ids, assign, n_lists, rows=48,
                          **kw).shard_views()
    got = tsegments.seal(codes, ids, assign, n_lists, rows=48,
                         device="cpu", **kw).shard_views()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the planner on one card
# ---------------------------------------------------------------------------

class TestListShardedPlanner:
    @pytest.mark.parametrize("n_dev", [1, 2, 4])
    @pytest.mark.parametrize("partition", ["queries", "lists", "auto"])
    def test_matches_direct(self, data, booted, n_dev, partition):
        """Every plan equals the direct search of the same index: sealed
        segments (flush-born and compacted) plus a hot buffer, with
        tombstones, on a layout sealed for ``n_dev`` shards."""
        X, Q = data
        idx = _fresh(booted, n_shards=n_dev)
        idx.insert(X[:30])                       # 2 sealed + 6 hot
        idx.delete([2, 13])
        want = idx.search(Q, n_probe=3, topk=4)
        got = search_sharded(idx, Q, n_probe=3, topk=4, partition=partition,
                             n_devices=n_dev)
        _identical(got, want)
        idx.compact()
        idx.insert(X[30:])
        _identical(search_sharded(idx, Q, n_probe=3, topk=4,
                                  partition=partition, n_devices=n_dev),
                   idx.search(Q, n_probe=3, topk=4))

    def test_auto_partition_selects_lists(self, data, booted, monkeypatch):
        from repro_torch.index import planner
        X, Q = data
        idx = _fresh(booted, n_shards=2)
        idx.insert(X[:30])
        taken = []
        monkeypatch.setattr(planner, "_search_list_sharded",
                            lambda *a: taken.append("lists") or
                            planner._search_query_sharded(*a))
        search_sharded(idx, Q, n_probe=3, topk=4, n_devices=2)
        search_sharded(idx, Q, n_probe=3, topk=4)          # one device
        assert taken == ["lists"]

    def test_layout_mismatch_raises(self, data, booted):
        X, Q = data
        idx = _fresh(booted, n_shards=2)
        idx.insert(X[:12])
        with pytest.raises(ValueError, match="n_shards"):
            search_sharded(idx, Q, n_probe=2, topk=2, partition="lists")
        with pytest.raises(ValueError, match="n_shards"):
            search_sharded(idx, Q, n_probe=2, topk=2, partition="lists",
                           n_devices=4)

    def test_search_mesh_gives_the_count_and_checks_the_layout(
            self, data, booted):
        """A ``make_search_mesh`` mesh stands for ``n_devices``; a list
        plan checks the layout with ``validate_search_mesh``."""
        from repro_torch.launch.mesh import make_host_mesh, make_search_mesh
        X, Q = data
        idx = _fresh(booted, n_shards=2)
        idx.insert(X[:30])
        _identical(search_sharded(idx, Q, n_probe=3, topk=4,
                                  mesh=make_search_mesh(2)),
                   search_sharded(idx, Q, n_probe=3, topk=4, n_devices=2))
        with pytest.raises(ValueError, match=r"make_search_mesh\(2\)"):
            search_sharded(idx, Q, n_probe=3, topk=4, partition="lists",
                           mesh=make_search_mesh(4))
        with pytest.raises(ValueError, match="expected a 1-D"):
            search_sharded(idx, Q, n_probe=3, mesh=make_host_mesh())

    def test_partition_arg_validation(self, data, booted):
        _, Q = data
        idx = _fresh(booted)
        with pytest.raises(ValueError, match="partition"):
            search_sharded(idx, Q, n_probe=2, partition="bogus")
        with pytest.raises(ValueError, match="n_devices"):
            search_sharded(idx, Q, n_probe=2, n_devices=0)

    @pytest.mark.parametrize("n_dev", [1, 2])
    def test_empty_and_hot_only_list_sharded(self, data, booted, n_dev):
        X, Q = data
        idx = _fresh(booted, n_shards=n_dev)
        d, ids = search_sharded(idx, Q, n_probe=2, topk=3,
                                partition="lists", n_devices=n_dev)
        assert bool(torch.isinf(d).all()) and bool((ids == -1).all())
        idx.insert(X[:6])                        # hot only, no segments
        _identical(search_sharded(idx, Q, n_probe=2, topk=3,
                                  partition="lists", n_devices=n_dev),
                   idx.search(Q, n_probe=2, topk=3))

    @pytest.mark.parametrize("partition", ["queries", "lists"])
    def test_one_device_equals_the_references(self, data, booted,
                                              partition):
        """On one device the port's plan equals the JAX package's
        ``search_sharded`` on its one-device CPU mesh."""
        from repro.index import search_sharded as jsearch_sharded
        from repro.launch.mesh import make_search_mesh
        X, Q = data
        j, t = _pair(booted)
        for idx in (j, t):
            idx.insert(X[:30])
            idx.delete([2, 13])
        with jdispatch.use_backend("jax"):
            want = jsearch_sharded(j, Q, n_probe=3, topk=4,
                                   partition=partition,
                                   mesh=make_search_mesh(1))
        _same(search_sharded(t, Q, n_probe=3, topk=4, partition=partition,
                             n_devices=1), want)
