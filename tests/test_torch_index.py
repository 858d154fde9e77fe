"""The port's streaming IVF-PQDTW index (``repro_torch.index``, CPU route)
held against the JAX package: the same insert/delete/flush/compact/search
sequence from the same quantizers, the same accounting and layout, and
snapshots that either package writes and the port restores.

Ids identical; distances within ``rtol=1e-5, atol=1e-4``.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import pq as jpq
from repro.data.timeseries import cbf
from repro import index as jindex
from repro.index import placement as jplacement
from repro.index import segments as jsegments
from repro_torch.core import pq as tpq
from repro_torch import index as tindex
from repro_torch.index import placement as tplacement
from repro_torch.index import segments as tsegments

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-4)
PQ_KW = dict(n_sub=4, codebook_size=8, use_prealign=False, kmeans_iters=2,
             dba_iters=1)


def _cfgs(**kw):
    base = dict(n_lists=4, hot_capacity=12, coarse_iters=3)
    base.update(kw)
    return (jindex.IndexConfig(pq=jpq.PQConfig(**PQ_KW), **base),
            tindex.IndexConfig(pq=tpq.PQConfig(**PQ_KW), **base))


@pytest.fixture(scope="module")
def data():
    X, _ = cbf(n_per_class=12, length=48, seed=0)    # 36 series
    Q, _ = cbf(n_per_class=2, length=48, seed=7)     # 6 queries
    X = X.astype(np.float32)
    Q = np.concatenate([Q.astype(np.float32), X[[4, 30]]])
    return X, Q


@pytest.fixture(scope="module")
def booted(data):
    """Quantizers trained by the JAX package (pure-JAX route)."""
    X, _ = data
    jcfg, _ = _cfgs()
    with jdispatch.use_backend("jax"):
        return jindex.StreamingIndex.bootstrap(jax.random.PRNGKey(0), X,
                                               jcfg)


def _pair(booted, **kw):
    jcfg, tcfg = _cfgs(**kw)
    j = jindex.StreamingIndex.from_parts(jcfg, booted.coarse, booted.cb,
                                         booted.dim)
    t = tindex.StreamingIndex.from_parts(tcfg, np.asarray(booted.coarse),
                                         booted.cb, booted.dim,
                                         two_level=j.two_level, device=CPU)
    return j, t


def _same_search(j, t, Q, n_probe, topk):
    with jdispatch.use_backend("jax"):
        want_d, want_i = j.search(Q, n_probe=n_probe, topk=topk)
    got_d, got_i = t.search(Q, n_probe=n_probe, topk=topk)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)


@pytest.mark.parametrize("kw", [{}, dict(n_top_lists=2, n_probe_top=1)],
                         ids=["flat", "two_level"])
def test_lifecycle_matches_jax(data, booted, kw):
    X, Q = data
    j, t = _pair(booted, **kw)
    for idx in (j, t):
        np.testing.assert_array_equal(idx.insert(X[:30]), np.arange(30))
    assert t.n_segments == j.n_segments == 2 and t.hot.count == 6
    for n_probe, topk in ((1, 1), (4, 5)):
        _same_search(j, t, Q, n_probe, topk)
    assert t.delete([3, 15, 28, 99]) == j.delete([3, 15, 28, 99]) == 3
    _same_search(j, t, Q, 2, 4)
    for idx in (j, t):
        idx.insert(X[30:])
        idx.flush()
    assert t.n_segments == j.n_segments == 3 and t.hot.count == 0
    _same_search(j, t, Q, 4, 6)
    for idx in (j, t):
        idx.delete([0, 33])
        idx.compact()
    assert t.n_segments == j.n_segments == 1
    np.testing.assert_array_equal(t.live_ids(), j.live_ids())
    assert t.stats() == j.stats()
    _same_search(j, t, Q, 3, 5)
    _same_search(j, t, Q, 4, 34)


def test_hot_only_search_matches_jax(data, booted):
    """A hot buffer alone: the exact LB-cascade scan (with a query that is
    a buffered row, and tombstones)."""
    X, Q = data
    j, t = _pair(booted)
    for idx in (j, t):
        idx.insert(X[:10])
        idx.delete([4])
    _same_search(j, t, Q, 1, 3)


def test_euclidean_metric_matches_jax(data):
    X, Q = data
    pq = dict(PQ_KW, metric="euclidean")
    jcfg = jindex.IndexConfig(pq=jpq.PQConfig(**pq), n_lists=4,
                              hot_capacity=12, coarse_iters=3)
    tcfg = tindex.IndexConfig(pq=tpq.PQConfig(**pq), n_lists=4,
                              hot_capacity=12, coarse_iters=3)
    with jdispatch.use_backend("jax"):
        j = jindex.StreamingIndex.bootstrap(jax.random.PRNGKey(0), X, jcfg)
    t = tindex.StreamingIndex.from_parts(tcfg, np.asarray(j.coarse), j.cb,
                                         j.dim, device=CPU)
    for idx in (j, t):
        idx.insert(X[:20])
    _same_search(j, t, Q, 2, 3)


@pytest.mark.parametrize("kw", [dict(n_segments=3, n_lists=4,
                                     hot_capacity=12),
                                dict(n_segments=2, n_lists=64,
                                     hot_capacity=2560, n_devices=4),
                                {}])
def test_memory_cost_matches(kw):
    want = jpq.memory_cost(jpq.PQConfig(), 512, 6144, **kw)
    got = tpq.memory_cost(tpq.PQConfig(), 512, 6144, **kw)
    assert got == want


def test_index_memory_cost_matches(data, booted):
    X, _ = data
    j, t = _pair(booted)
    for idx in (j, t):
        idx.insert(X[:30])
    assert t.memory_cost() == j.memory_cost()


@pytest.mark.parametrize("n_shards,shard_round", [(1, 1), (3, 5)])
def test_seal_and_placement_match(n_shards, shard_round):
    rng = np.random.default_rng(n_shards)
    n, n_lists = 40, 6
    codes = rng.integers(0, 8, (n, 4)).astype(np.int32)
    ids = rng.permutation(100)[:n].astype(np.int32)
    assign = rng.integers(0, n_lists, n).astype(np.int32)
    want = jsegments.seal(codes, ids, assign, n_lists, rows=48,
                          n_shards=n_shards, shard_round=shard_round)
    got = tsegments.seal(codes, ids, assign, n_lists, rows=48,
                         n_shards=n_shards, shard_round=shard_round,
                         device=CPU)
    for f in ("codes", "ids", "live", "assign", "list_start", "list_len",
              "placement"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert (got.max_list, got.n_shards, got.shard_cap) == (
        want.max_list, want.n_shards, want.shard_cap)
    counts = rng.integers(0, 50, 9)
    p = tplacement.plan_placement(counts, 4)
    np.testing.assert_array_equal(p, jplacement.plan_placement(counts, 4))
    np.testing.assert_array_equal(
        tplacement.placement_loads(p, counts, 4),
        jplacement.placement_loads(p, counts, 4))


def _filled(idx, X):
    idx.insert(X[:30])            # 2 sealed segments + 6 hot rows
    idx.delete([2, 17, 29])       # sealed and hot tombstones
    return idx


@pytest.mark.parametrize("kw", [{}, dict(n_top_lists=2, n_probe_top=2)],
                         ids=["flat", "two_level"])
def test_port_restores_jax_snapshot(data, booted, tmp_path, kw):
    X, Q = data
    j, _ = _pair(booted, **kw)
    _filled(j, X)
    path = jindex.save_snapshot(str(tmp_path), j)
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["format"] == 3
    t = tindex.restore_snapshot(str(tmp_path), device=CPU)
    assert t.stats() == j.stats() and t.next_id == j.next_id
    assert (t.two_level is None) == (j.two_level is None)
    _same_search(j, t, Q, 3, 5)
    for idx in (j, t):
        idx.insert(X[30:])        # the restored index keeps living
    _same_search(j, t, Q, 4, 4)


def test_port_snapshot_roundtrips(data, booted, tmp_path):
    X, Q = data
    j, t = _pair(booted)
    _filled(t, X)
    d0, i0 = t.search(Q, n_probe=4, topk=5)
    tindex.save_snapshot(str(tmp_path), t)
    back = tindex.restore_snapshot(str(tmp_path), device=CPU)
    d1, i1 = back.search(Q, n_probe=4, topk=5)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    assert back.stats() == t.stats()
    np.testing.assert_array_equal(back.live_ids(), t.live_ids())
    # the JAX package restores the port's snapshot to the same answers
    with jdispatch.use_backend("jax"):
        jback = jindex.restore_snapshot(str(tmp_path))
        jd, ji = jback.search(Q, n_probe=4, topk=5)
    np.testing.assert_array_equal(np.asarray(ji), i0.numpy())
    np.testing.assert_allclose(np.asarray(jd), d0.numpy(), **TOL)
    assert tindex.latest_snapshot(str(tmp_path)) == 0


def test_snapshot_rejects_measure_mismatch(data, booted, tmp_path):
    X, _ = data
    _, t = _pair(booted)
    path = tindex.save_snapshot(str(tmp_path), t)
    man = os.path.join(path, "manifest.json")
    with open(man) as f:
        manifest = json.load(f)
    manifest["measure"] = {"name": "erp", "params": {"g": 0.0}}
    with open(man, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="measure record"):
        tindex.restore_snapshot(str(tmp_path), device=CPU)


def test_validation_errors(data, booted):
    X, Q = data
    _, t = _pair(booted)
    with pytest.raises(ValueError, match="n_probe"):
        t.search(Q, n_probe=5)
    with pytest.raises(ValueError, match="topk"):
        t.search(Q, n_probe=1, topk=0)
    with pytest.raises(ValueError, match="series"):
        t.insert(np.zeros((2, 7), np.float32))
    with pytest.raises(ValueError, match="duplicate ids"):
        t.insert(X[:2], ids=[5, 5])
    t.insert(X[:3], ids=[7, 8, 9])
    with pytest.raises(ValueError, match="already resident"):
        t.insert(X[:1], ids=[8])
    with pytest.raises(ValueError, match="hot_capacity"):
        tindex.StreamingIndex.from_parts(
            dataclasses.replace(t.cfg, hot_capacity=0), t.coarse, t.cb,
            t.dim, device=CPU)
    empty = tindex.StreamingIndex.from_parts(t.cfg, t.coarse, t.cb, t.dim,
                                             device=CPU)
    d, ids = empty.search(Q, n_probe=1, topk=3)
    assert torch.isinf(d).all() and (ids == -1).all()


@pytest.mark.parametrize("fmt", [1, 2])
def test_port_restores_older_formats(data, booted, tmp_path, fmt):
    """Formats 1-2 predate the scale-out state: segments load as the
    single-shard layout (format 1 also predates the measure record)."""
    X, Q = data
    j, _ = _pair(booted)
    _filled(j, X)
    path = jindex.save_snapshot(str(tmp_path), j)
    man = os.path.join(path, "manifest.json")
    with open(man) as f:
        manifest = json.load(f)
    manifest["format"] = fmt
    if fmt == 1:
        del manifest["measure"]
    for s in range(len(manifest["segments"])):
        os.remove(os.path.join(path, f"seg{s:04d}_placement.npy"))
    with open(man, "w") as f:
        json.dump(manifest, f)
    t = tindex.restore_snapshot(str(tmp_path), device=CPU)
    assert all(sg.n_shards == 1 and sg.shard_cap == sg.rows
               for sg in t.segments)
    _same_search(j, t, Q, 4, 5)
