"""The port's PQ pipeline (CPU route) held against the JAX package:
``fit`` from the reference's own initial centroids, ``encode`` with a
codebook carried across by ``codebook_from_numpy``, both PQ distances,
and the 1-NN predictions."""

import jax
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import kmeans as jkmeans
from repro.core import knn as jknn
from repro.core import pq as jpq
from repro.data.timeseries import make_dataset
from repro_torch.core import knn as tknn
from repro_torch.core import pq as tpq

CPU = "cpu"


def _cfg_pair(**kw):
    return jpq.PQConfig(**kw), tpq.PQConfig(**kw)


@pytest.fixture(scope="module")
def data():
    X, y = make_dataset("cbf", 8, 64, seed=0)
    Q, yq = make_dataset("cbf", 4, 64, seed=100)
    return X, y, Q, yq


@pytest.fixture(scope="module")
def ref_fit(data):
    """The reference's codebook (pure-JAX route) and its initial
    centroids, drawn exactly as ``repro.core.pq.fit`` draws them."""
    X = data[0]
    jcfg, _ = _cfg_pair(n_sub=4, codebook_size=6, kmeans_iters=2,
                        dba_iters=1)
    key = jax.random.PRNGKey(0)
    with jdispatch.use_backend("jax"):
        cb = jpq.fit(key, X, jcfg)
        segs = jpq.segment(X, jcfg)
    keys = jax.random.split(key, jcfg.n_sub)
    init = np.stack([np.asarray(jkmeans._init_centroids(
        keys[m], segs[:, m], jcfg.codebook_size))
        for m in range(jcfg.n_sub)])
    return cb, init


def test_fit_from_reference_init_matches(data, ref_fit):
    X = data[0]
    cb_ref, init = ref_fit
    _, tcfg = _cfg_pair(n_sub=4, codebook_size=6, kmeans_iters=2,
                        dba_iters=1)
    cb = tpq.fit(X, tcfg, init_centroids=init, device=CPU)
    for got, want in zip(cb, cb_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("metric", ["dtw", "euclidean"])
def test_codebook_from_centroids_rebuilds_fit_tables(data, metric):
    """``fit``'s LUT and envelopes are ``codebook_from_centroids`` of its
    centroids, bit for bit."""
    X = data[0]
    _, tcfg = _cfg_pair(n_sub=4, codebook_size=6, kmeans_iters=2,
                        dba_iters=1, metric=metric)
    cb = tpq.fit(X, tcfg, torch.Generator().manual_seed(0), device=CPU)
    again = tpq.codebook_from_centroids(cb.centroids, tcfg, X.shape[1])
    for got, want in zip(again, cb):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(n_sub=4, codebook_size=6),                        # LB filter
    dict(n_sub=4, codebook_size=6, refine_frac=0.5),       # LB filter, T=3
    dict(n_sub=4, codebook_size=6, exact_encode=True),     # fused kernel
    dict(n_sub=4, codebook_size=6, exact_encode=True, fused_encode=False),
])
def test_encode_codes_identical(data, ref_fit, kw):
    X, _, Q, _ = data
    jcfg, tcfg = _cfg_pair(kmeans_iters=2, dba_iters=1, **kw)
    cb_ref = ref_fit[0]
    cb = tpq.codebook_from_numpy(cb_ref, device=CPU)
    with jdispatch.use_backend("jax"):
        want, want_ok = jpq.encode_with_stats(np.concatenate([X, Q]),
                                              cb_ref, jcfg)
    got, ok = tpq.encode_with_stats(np.concatenate([X, Q]), cb, tcfg,
                                    device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))


def test_uses_fused_prealign_mirrors_reference():
    for kw in (dict(), dict(exact_encode=True), dict(metric="euclidean"),
               dict(exact_encode=True, use_prealign=False),
               dict(metric="erp"), dict(refine_frac=1.0)):
        jcfg, tcfg = _cfg_pair(**kw)
        assert tpq.uses_fused_prealign(tcfg) == jpq.uses_fused_prealign(jcfg)
        assert (tcfg.tail(512), tcfg.window(512), tcfg.refine_t(),
                tcfg.subseq_len(512)) == (jcfg.tail(512), jcfg.window(512),
                                          jcfg.refine_t(),
                                          jcfg.subseq_len(512))


def test_distances_close(data, ref_fit):
    X, _, Q, _ = data
    jcfg, tcfg = _cfg_pair(n_sub=4, codebook_size=6)
    cb_ref = ref_fit[0]
    cb = tpq.codebook_from_numpy(cb_ref, device=CPU)
    with jdispatch.use_backend("jax"):
        codes_ref = jpq.encode(X, cb_ref, jcfg)
        sym_ref = jpq.cdist_sym(codes_ref, codes_ref, cb_ref.lut)
        asym_ref = jpq.cdist_asym(Q, codes_ref, cb_ref, jcfg)
    codes = np.asarray(codes_ref)
    sym = tpq.cdist_sym(codes, codes, cb.lut, device=CPU)
    asym = tpq.cdist_asym(Q, codes, cb, tcfg, device=CPU)
    np.testing.assert_allclose(sym.numpy(), np.asarray(sym_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(asym.numpy(), np.asarray(asym_ref),
                               rtol=1e-5, atol=1e-5)


def test_knn_predictions_identical(data, ref_fit):
    X, y, Q, _ = data
    jcfg, tcfg = _cfg_pair(n_sub=4, codebook_size=6)
    cb_ref = ref_fit[0]
    cb = tpq.codebook_from_numpy(cb_ref, device=CPU)
    with jdispatch.use_backend("jax"):
        codes_ref = jpq.encode(X, cb_ref, jcfg)
        want_sym = jknn.knn_classify_sym(codes_ref, y, Q, cb_ref, jcfg)
        want_asym = jknn.knn_classify_asym(codes_ref, y, Q, cb_ref, jcfg)
        want_nn = jknn.nn_dtw_exact(X, y, Q, window=6)
    codes = tpq.encode(X, cb, tcfg, device=CPU)
    got_sym = tknn.knn_classify_sym(codes, y, Q, cb, tcfg, device=CPU)
    got_asym = tknn.knn_classify_asym(codes, y, Q, cb, tcfg, device=CPU)
    got_nn = tknn.nn_dtw_exact(X, y, Q, window=6, device=CPU)
    np.testing.assert_array_equal(got_sym.numpy(), np.asarray(want_sym))
    np.testing.assert_array_equal(got_asym.numpy(), np.asarray(want_asym))
    np.testing.assert_array_equal(got_nn.numpy(), np.asarray(want_nn))


def test_euclidean_baseline_encode_identical(data):
    X = data[0]
    jcfg, tcfg = _cfg_pair(n_sub=4, codebook_size=5, metric="euclidean",
                           kmeans_iters=3)
    with jdispatch.use_backend("jax"):
        cb_ref = jpq.fit(jax.random.PRNGKey(1), X, jcfg)
        want = jpq.encode(X, cb_ref, jcfg)
    got = tpq.encode(X, tpq.codebook_from_numpy(cb_ref, device=CPU), tcfg,
                     device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_codebook_round_trip(ref_fit):
    cb = tpq.codebook_from_numpy(ref_fit[0], device=CPU)
    back = tpq.codebook_to_numpy(cb)
    for a, b in zip(back, ref_fit[0]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (cb.n_sub, cb.codebook_size, cb.subseq_len) == (4, 6, 18)


def test_memory_cost_matches_reference():
    for D, n in ((128, 1000), (512, 6144)):
        jcfg, tcfg = _cfg_pair()
        want = jpq.memory_cost(jcfg, D, n)
        got = tpq.memory_cost(tcfg, D, n)
        assert got == {k: want[k] for k in got}


def test_fit_draws_from_generator():
    X, _ = make_dataset("cbf", 4, 32, seed=3)
    cfg = tpq.PQConfig(n_sub=2, codebook_size=3, kmeans_iters=1,
                       dba_iters=1)
    a = tpq.fit(X, cfg, torch.Generator().manual_seed(5), device=CPU)
    b = tpq.fit(X, cfg, torch.Generator().manual_seed(5), device=CPU)
    np.testing.assert_array_equal(a.centroids.numpy(), b.centroids.numpy())
    with pytest.raises(ValueError, match="Generator"):
        tpq.fit(X, cfg, device=CPU)


def test_entry_points_need_a_card_or_cpu(monkeypatch, data):
    """With no card and no explicit ``device="cpu"`` every entry point
    raises instead of running quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, Q, _ = data
    cfg = tpq.PQConfig(n_sub=4, codebook_size=6)
    cb = tpq.PQCodebook(*(torch.zeros(s) for s in
                          ((4, 6, 18), (4, 6, 6), (4, 6, 18), (4, 6, 18))))
    codes = np.zeros((3, 4), np.int32)
    calls = [
        lambda: tpq.fit(X, cfg, torch.Generator()),
        lambda: tpq.encode(X, cb, cfg),
        lambda: tpq.cdist_sym(codes, codes, cb.lut),
        lambda: tpq.cdist_asym(Q, codes, cb, cfg),
        lambda: tknn.knn_classify_sym(codes, y[:3], Q, cb, cfg),
        lambda: tknn.knn_classify_asym(codes, y[:3], Q, cb, cfg),
        lambda: tknn.nn_dtw_exact(X, y, Q),
        lambda: tpq.codebook_from_numpy(tpq.codebook_to_numpy(cb)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("name", ["repro_torch.core.pq",
                                  "repro_torch.core.dispatch"])
def test_module_doctests(name):
    import doctest
    import importlib
    result = doctest.testmod(importlib.import_module(name), verbose=False)
    assert result.attempted > 0 and result.failed == 0
