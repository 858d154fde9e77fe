"""The port's IVF-PQDTW (``repro_torch.core.ivf``, CPU route) held against
the JAX package, from a coarse quantizer, codebook and two-level table that
the JAX package built and the port carries in.

Ids and codes identical; distances within ``rtol=1e-5, atol=1e-4``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import ivf as jivf
from repro.core import kmeans as jkmeans
from repro.core import lb as jlb
from repro.core import pq as jpq
from repro.data.timeseries import make_dataset
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import ivf as tivf
from repro_torch.core import lb as tlb
from repro_torch.core import pq as tpq

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-4)
KW = dict(n_sub=4, codebook_size=8, kmeans_iters=2, dba_iters=1)


@pytest.fixture(scope="module")
def built():
    """A reference index over CBF series (D=48), its two-level table, and
    queries, some of which are database rows."""
    X, _ = make_dataset("cbf", 20, 48, seed=3)
    Q, _ = make_dataset("cbf", 3, 48, seed=4)
    Q = np.concatenate([Q, X[[5, 17]]])
    jcfg = jpq.PQConfig(**KW)
    with jdispatch.use_backend("jax"):
        index = jivf.build_index(jax.random.PRNGKey(0), X, jcfg, n_lists=6,
                                 coarse_iters=2)
        tl = jivf.build_two_level(jax.random.PRNGKey(1), index.coarse, 3,
                                  index.coarse_window, iters=2)
    return X, Q, jcfg, tpq.PQConfig(**KW), index, tl


def _np(x):
    return np.array(x)


def test_build_lists_matches():
    assign = np.random.default_rng(0).integers(0, 7, 50)
    for got, want in zip(tivf.build_lists(assign, 9),
                         jivf.build_lists(assign, 9)):
        np.testing.assert_array_equal(got, want)


def test_lb_lut_matches(built):
    X, Q, jcfg, tcfg, index, _ = built
    q_segs = _np(jpq.segment(Q, jcfg))
    cb = index.cb
    want = jlb.lb_lut(q_segs, cb.centroids, cb.env_upper, cb.env_lower)
    tcb = tpq.codebook_from_numpy(cb, CPU)
    got = tlb.lb_lut(torch.from_numpy(q_segs), tcb.centroids,
                     tcb.env_upper, tcb.env_lower)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_build_index_from_reference_quantizers(built):
    X, _, _, tcfg, index, _ = built
    got = tivf.build_index(None, X, tcfg, n_lists=6, coarse=index.coarse,
                           cb=index.cb, device=CPU)
    for name in ("codes", "ids", "list_start", "list_len"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(index, name)), name)
    assert (got.max_list, got.coarse_window) == (index.max_list,
                                                 index.coarse_window)
    carried = tivf.ivf_index_from_numpy(index, CPU)
    assert torch.equal(carried.codes, got.codes)


@pytest.mark.parametrize("n_probe,topk,lb_budget", [
    (1, 1, None), (2, 5, None), (6, 10, None), (3, 4, 6), (6, 3, 3)])
def test_search_batch_matches(built, n_probe, topk, lb_budget):
    X, Q, jcfg, tcfg, index, _ = built
    topk = min(topk, n_probe * index.max_list)
    if lb_budget is not None:
        lb_budget = max(topk, min(lb_budget, n_probe * index.max_list))
    with jdispatch.use_backend("jax"):
        want_d, want_i = jivf.search_batch(index, Q, jcfg, n_probe=n_probe,
                                           topk=topk, lb_budget=lb_budget)
    tindex = tivf.ivf_index_from_numpy(index, CPU)
    got_d, got_i = tivf.search_batch(tindex, Q, tcfg, n_probe=n_probe,
                                     topk=topk, lb_budget=lb_budget)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), _np(want_i))
    np.testing.assert_allclose(got_d.numpy(), _np(want_d), **TOL)
    d1, i1 = tivf.search(tindex, Q[0], tcfg, n_probe=n_probe, topk=topk,
                         lb_budget=lb_budget)
    assert torch.equal(i1, got_i[0])


@pytest.mark.parametrize("chunk", [None, 1])
def test_fine_rank_live_and_budget_match(built, monkeypatch, chunk):
    """The segment-level fine stage with a tombstone mask and the LB
    pre-filter, query by query in the reference, batched in the port (in
    one chunk, or one query per chunk)."""
    X, Q, jcfg, tcfg, index, _ = built
    if chunk is not None:
        monkeypatch.setattr(tivf, "GATHER_CHUNK_BYTES", chunk)
    live = np.random.default_rng(2).random(index.codes.shape[0]) > 0.3
    with jdispatch.use_backend("jax"):
        dc = _np(jivf.coarse_dists(Q, index.coarse, index.coarse_window))
        q_segs = jpq.segment(Q, jcfg)
        qluts = _np(jpq.query_lut_batch(q_segs, index.cb, jcfg.window(48),
                                        measure=jcfg.measure()))
    lbl = _np(jlb.lb_lut(q_segs, index.cb.centroids, index.cb.env_upper,
                         index.cb.env_lower))
    n_probe, topk, budget = 3, 4, 7
    want = [jivf.fine_rank(index.codes, index.ids, index.list_start,
                           index.list_len, index.max_list, dc[q], qluts[q],
                           n_probe, topk, live=live, lb_qlut=lbl[q],
                           lb_budget=budget) for q in range(len(Q))]
    t = tivf.ivf_index_from_numpy(index, CPU)
    got_d, got_i = tivf.fine_rank_batch(
        t.codes, t.ids, t.list_start, t.list_len, t.max_list,
        torch.from_numpy(dc), torch.from_numpy(qluts), n_probe, topk,
        live=torch.from_numpy(live), lb_qluts=torch.from_numpy(lbl),
        lb_budget=budget)
    np.testing.assert_array_equal(got_i.numpy(),
                                  np.stack([_np(w[1]) for w in want]))
    np.testing.assert_allclose(got_d.numpy(),
                               np.stack([_np(w[0]) for w in want]), **TOL)
    one_d, one_i = tivf.fine_rank(
        t.codes, t.ids, t.list_start, t.list_len, t.max_list,
        torch.from_numpy(dc[0]), torch.from_numpy(qluts[0]), n_probe, topk,
        live=torch.from_numpy(live), lb_qlut=torch.from_numpy(lbl[0]),
        lb_budget=budget)
    assert torch.equal(one_i, got_i[0])


@pytest.mark.parametrize("n_probe_top", [1, 2, 3])
def test_two_level_coarse_matches(built, n_probe_top):
    X, Q, jcfg, tcfg, index, tl = built
    with jdispatch.use_backend("jax"):
        want = _np(jivf.coarse_dists(Q, index.coarse, index.coarse_window,
                                     two_level=tl, n_probe_top=n_probe_top))
        want_d, want_i = jivf.search_batch(index, Q, jcfg, n_probe=4,
                                           topk=3, two_level=tl,
                                           n_probe_top=n_probe_top)
    t = tivf.ivf_index_from_numpy(index, CPU)
    ttl = tivf.two_level_from_numpy(tl, CPU)
    tdispatch.reset_stats()
    got = tivf.coarse_dists(torch.from_numpy(Q), t.coarse, t.coarse_window,
                            two_level=ttl, n_probe_top=n_probe_top)
    assert tdispatch.stats[("two_level_coarse", "torch")] == 1
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(want))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got_d, got_i = tivf.search_batch(t, Q, tcfg, n_probe=4, topk=3,
                                     two_level=ttl, n_probe_top=n_probe_top)
    np.testing.assert_array_equal(got_i.numpy(), _np(want_i))
    np.testing.assert_allclose(got_d.numpy(), _np(want_d), **TOL)


def test_build_two_level_from_reference_init(built):
    _, _, _, _, index, tl = built
    init = _np(jkmeans._init_centroids(jax.random.PRNGKey(1), index.coarse,
                                       3))
    got = tivf.build_two_level(None, torch.from_numpy(_np(index.coarse)), 3,
                               index.coarse_window, iters=2,
                               init=torch.from_numpy(init))
    np.testing.assert_array_equal(got.child_idx.numpy(), _np(tl.child_idx))
    np.testing.assert_array_equal(got.child_valid.numpy(),
                                  _np(tl.child_valid))
    np.testing.assert_allclose(got.top.numpy(), _np(tl.top), **TOL)


def test_probe_validation():
    with pytest.raises(ValueError, match="n_probe"):
        tivf.validate_n_probe(0, 4)
    with pytest.raises(ValueError, match="topk"):
        tivf._validate_probe(4, 3, 2, 7)
    with pytest.raises(ValueError, match="lb_budget"):
        tivf._validate_probe(4, 3, 2, 2, lb_budget=1)
