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


def test_codes_are_checked_once_a_tensor(monkeypatch):
    """``check_codes`` reads a tensor's extremes once: codes ``encode``
    made, or a caller's checked before and not written since, pass with
    no read (the 1-NN entry points over encoded codes read nothing); a
    write in place checks them again, and a bad code then raises."""
    from repro_torch.kernels.pq_adc import ops as adc_ops
    reads = []
    aminmax = torch.aminmax
    monkeypatch.setattr(torch, "aminmax",
                        lambda t: reads.append(t) or aminmax(t))
    cfg = tpq.PQConfig(n_sub=2, codebook_size=2, use_prealign=False,
                       kmeans_iters=1, dba_iters=1)
    X = torch.arange(32, dtype=torch.float32).reshape(4, 8) / 10.0
    cb = tpq.fit(X, cfg, torch.Generator().manual_seed(0), device="cpu")
    codes = tpq.encode(X, cb, cfg, device="cpu")
    labels = torch.arange(4)
    tknn.knn_classify_sym(codes, labels, X, cb, cfg, device="cpu")
    tknn.knn_classify_asym(codes, labels, X, cb, cfg, device="cpu")
    tpq.cdist_sym(codes, codes, cb.lut, device="cpu")
    assert reads == []
    mine = codes.clone()                     # a caller's own tensor
    tpq.cdist_sym(mine, codes, cb.lut, device="cpu")
    tpq.cdist_asym(X, mine, cb, cfg, device="cpu")
    assert len(reads) == 1
    mine[0, 0] = 2
    with pytest.raises(adc_ops.CodeRangeError, match="codes_a holds"):
        tpq.cdist_sym(mine, codes, cb.lut, device="cpu")
    assert len(reads) == 2


def _old_lb_filter_pairs(segs, cb, T):
    """``lb_filter_pairs`` as it was written before the filter became a
    dispatch op: the bounds a subspace at a time, a stable sort, the
    zipped pairs."""
    from repro_torch.core.lb import cascade_bound
    N, M, S = segs.shape
    lbs = torch.stack([
        cascade_bound(segs[:, m, None, :], cb.centroids[m][None],
                      cb.env_upper[m][None], cb.env_lower[m][None])
        for m in range(M)], dim=1)
    srt = torch.sort(lbs, dim=-1, stable=True)
    cand = srt.indices[..., :T]
    next_lb = srt.values[..., T]
    m_idx = torch.arange(M)[None, :, None]
    qs = segs[:, :, None, :].expand(N, M, T, S).reshape(-1, S)
    cs = cb.centroids[m_idx, cand].reshape(-1, S)
    return cand, next_lb, qs, cs


def _filter_problem(case):
    """Segments and a codebook with its envelopes: random walks, or with
    duplicated centroids, constant segments and centroids (equal bounds),
    or NaN points (at an end: every bound NaN; inside: a zero term)."""
    from repro_torch.core.lb import keogh_envelope
    g = torch.Generator().manual_seed(11)
    N, M, K, S, T = 37, 3, 9, 12, 4
    if case in ("k4_t1", "k4_t3"):
        K, T = 4, int(case[-1])
    segs = torch.randn(N, M, S, generator=g).cumsum(-1)
    cents = torch.randn(M, K, S, generator=g).cumsum(-1)
    if case == "ties":
        cents[:, 1::3] = cents[:, 0::3][:, :cents[:, 1::3].shape[1]]
        cents[:, 2], cents[:, 5] = 1.0, -1.0
        segs[::4] = 0.0
    if case == "nan":
        segs[0, :, 0] = float("nan")
        segs[1, 0, S // 2] = float("nan")
        segs[2, 2, S - 1] = float("nan")
    up, lo = keogh_envelope(cents, 2)
    cb = tpq.PQCodebook(cents, torch.zeros(M, K, K), up, lo)
    return segs, cb, T


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("case", ["random", "ties", "nan", "k4_t1",
                                  "k4_t3"])
def test_lb_filter_plain_route_is_the_old_filter(case):
    """The dispatch op's plain route, and ``lb_filter_pairs`` through it,
    give what the filter gave before it was an op, bit for bit."""
    from repro_torch.core import dispatch as tdispatch
    segs, cb, T = _filter_problem(case)
    want = _old_lb_filter_pairs(segs, cb, T)
    got = tpq.lb_filter_pairs(segs, cb, T)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))
    cand, next_lb = tdispatch.lb_filter(segs, cb.centroids, cb.env_upper,
                                        cb.env_lower, T)
    assert torch.equal(cand, want[0])
    assert torch.equal(_bits(next_lb), _bits(want[1]))


@pytest.mark.parametrize("kw,calls", [
    (dict(), 1),                                          # the LB path
    (dict(exact_encode=True), 0),                         # fused kernel
    (dict(exact_encode=True, fused_encode=False), 0),     # full scan
])
def test_lb_filter_dispatched_once_an_lb_encode(data, ref_fit, kw, calls):
    from repro_torch.core import dispatch as tdispatch
    _, tcfg = _cfg_pair(n_sub=4, codebook_size=6, kmeans_iters=2,
                        dba_iters=1, **kw)
    cb = tpq.codebook_from_numpy(ref_fit[0], device=CPU)
    tdispatch.reset_stats()
    tpq.encode(data[0], cb, tcfg, device=CPU)
    assert tdispatch.stats.get(("lb_filter", "torch"), 0) == calls
    assert ("lb_filter", "cuda") not in tdispatch.stats


def test_undecided_ranks_are_the_close_unequal_neighbours():
    """A rank below T is open where a neighbour in the stable order lies
    within ``rtol`` and is another exact bound, equal in float32 or not;
    distant bounds, and ties of equal exact bounds, leave it decided."""
    from repro_torch.kernels.lb_cascade.ref import undecided_ranks
    bounds = torch.tensor([[[5.0, 1.0, 2.0, 2.0, 2.000002, 9.0]]])
    exact = bounds.double()
    assert undecided_ranks(bounds, exact, 4, 1e-5).tolist() == [
        [[False, False, True, True]]]
    assert not undecided_ranks(bounds, exact, 4, 1e-7).any()
    exact[0, 0, 3] += 1e-9                # 2.0 and 2.0 only in float32
    assert undecided_ranks(bounds, exact, 4, 1e-7).tolist() == [
        [[False, True, True, False]]]
