"""The port's adaptive alignment corridors (``repro_torch.core.corridor``),
the adaptive sweep, cascade, search and index (CPU route) and its tuner
table, held against the JAX package on the same seeded numpy inputs.

Corridors, certificates and top-k ids are identical.  Adaptive costs are
bit-equal for dtw, erp and msm: the port sweeps the same cells in the same
order, with the reference's fused multiply-add and its log-depth ERP
border.  WDTW is bit-equal wherever the two packages' ``exp`` give the
same weights, and otherwise within the weights' one-ulp difference
(``rtol=1e-6``).  ``lb_refine`` flags are compared with thresholds no
bound comes near, distances where the flags agree.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import corridor as jcorr
from repro.core import dispatch as jdispatch
from repro.core import pq as jpq
from repro.core.lb import keogh_envelope as jenvelope
from repro.core.lb_search import filtered_topk as jfiltered_topk
from repro.data.timeseries import cbf
from repro.kernels import tune as jtune
from repro.kernels.dtw_band.kernel import band_width as jband_width
from repro import index as jindex
from repro_torch.core import corridor as tcorr
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import measures as tmeasures
from repro_torch.core import pq as tpq
from repro_torch.core.dtw import dtw_batch
from repro_torch.core.lb import cascade_bound
from repro_torch.core.lb_search import filtered_topk
from repro_torch import index as tindex
from repro_torch.kernels import tune as ttune
from repro_torch.kernels.dtw_band.ops import band_width, dtw_band_adaptive
from repro_torch.kernels.dtw_band.ref import prefix_sum

MEASURES = ("dtw", "wdtw:g=0.1", "erp:g=0.3", "msm:c=0.5")
TOL = dict(rtol=1e-5, atol=1e-4)
INF = np.float32(np.inf)


def _walks(seed, n, L):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.standard_normal((n, L)), 1).astype(np.float32),
            np.cumsum(rng.standard_normal((n, L)), 1).astype(np.float32))


def _cbf(seed, n, L):
    X, _ = cbf(n_per_class=-(-2 * n // 3), length=L, seed=seed)
    X = X.astype(np.float32)[np.random.default_rng(seed).permutation(len(X))]
    return X[:n], X[n:2 * n]


def _warped(seed, n, L, drift=3):
    """B is A under small monotone time warps plus noise: corridors
    converge on such pairs (the reference test's generator)."""
    rng = np.random.default_rng(seed)
    A = np.cumsum(rng.normal(size=(n, L)), axis=1).astype(np.float32)
    B = np.empty_like(A)
    for i in range(n):
        off = np.clip(np.cumsum(rng.integers(-1, 2, size=L)), -drift, drift)
        B[i] = A[i, np.clip(np.arange(L) + off, 0, L - 1)]
    return A, (B + rng.normal(scale=0.05, size=B.shape)).astype(np.float32)


DATA = {"walks": _walks, "cbf": _cbf, "warped": _warped}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


# -- corridor construction ---------------------------------------------------

@pytest.mark.parametrize("data", sorted(DATA))
@pytest.mark.parametrize("L,window", [(64, 6), (128, 12), (128, None),
                                      (24, 5)])
def test_build_corridor_matches_jax(data, L, window):
    A, B = DATA[data](L + (window or 0), 9, L)
    want = jcorr.build_corridor(A, B, window)
    got = tcorr.build_corridor(_t(A), _t(B), window)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _np(w))


@pytest.mark.parametrize("factor,radius", [(4, 0), (8, 2), (16, 1),
                                           (32, 2)])
def test_build_corridor_options_match_jax(factor, radius):
    """Other projection grids, down to the ``Lc < 4`` static fallback
    (L=64 at factor 32: Lc = 2)."""
    A, B = _walks(factor, 6, 64)
    want = jcorr.build_corridor(A, B, 9, factor=factor, radius=radius)
    got = tcorr.build_corridor(_t(A), _t(B), 9, factor=factor,
                               radius=radius)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    if factor == 32:
        lo_s, hi_s = tcorr.static_band(64, 9)
        assert torch.equal(got[0], lo_s.expand(6, -1))
        assert torch.equal(got[1], hi_s.expand(6, -1))


@pytest.mark.parametrize("L,window", [(1, None), (7, 0), (33, 3), (64, None),
                                      (128, 200)])
def test_static_band_matches_jax(L, window):
    for g, w in zip(tcorr.static_band(L, window),
                    jcorr.static_band(L, window)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _np(w))


@pytest.mark.parametrize("width", [1, 8, 32])
def test_clip_dilate_width_match_jax(width):
    A, B = _walks(11, 5, 96)
    lo, hi = jcorr.build_corridor(A, B, 9)
    tlo, thi = _t(_np(lo)), _t(_np(hi))
    for g, w in zip(tcorr.clip_to_width(tlo, thi, width),
                    jcorr.clip_to_width(lo, hi, width)):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    for g, w in zip(tcorr.dilate(tlo, thi, 96, 9),
                    jcorr.dilate(lo, hi, 96, 9)):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    np.testing.assert_array_equal(tcorr.corridor_width(tlo, thi).numpy(),
                                  _np(jcorr.corridor_width(lo, hi)))


@pytest.mark.parametrize("data", sorted(DATA))
def test_corridor_invariants(data):
    L, w = 96, 9
    A, B = DATA[data](3, 6, L)
    lo, hi = (x.numpy() for x in tcorr.build_corridor(_t(A), _t(B), w))
    lo_s, hi_s = (x.numpy() for x in tcorr.static_band(L, w))
    assert lo.shape == (6, 2 * L - 1)
    assert (lo[:, 0] == 0).all() and (lo[:, -1] == L - 1).all()
    step = np.diff(lo, axis=1)
    assert ((step >= 0) & (step <= 1)).all()
    assert (lo >= lo_s).all() and (hi <= hi_s).all() and (hi >= lo).all()


def test_paa_matches_jax():
    X, _ = _walks(2, 4, 61)                 # 61 = 7 * 8 + 5: padded tail
    for factor in (4, 8):
        np.testing.assert_array_equal(tcorr.paa(_t(X), factor).numpy(),
                                      _np(jcorr.paa(X, factor)))


# -- adaptive sweep ------------------------------------------------------------

def _weights_agree(measure, L):
    """Do both packages' WDTW weights agree to the bit at this length?"""
    import jax
    import jax.numpy as jnp
    spec = tmeasures.resolve(measure)
    if not spec.uses_position:
        return True
    g = spec.param("g")
    want = jax.jit(lambda d: 2.0 / (1.0 + jnp.exp(
        -g * (d.astype(jnp.float32) - 0.5 * L))))(jnp.arange(L))
    got = tmeasures.wdtw_weights(spec, L, torch.device("cpu"))
    return np.array_equal(got.numpy(), _np(want))


def _assert_bits(got, want, measure, L):
    if _weights_agree(measure, L):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("data,L,window", [("walks", 64, 6),
                                           ("cbf", 128, 12),
                                           ("walks", 128, 40)])
def test_corridor_sweep_matches_jax(measure, data, L, window):
    A, B = DATA[data](7, 8, L)
    width = jtune.adaptive_width(L, window)
    lo, hi = jcorr.clip_to_width(*jcorr.build_corridor(A, B, window), width)
    want = _np(jcorr.corridor_sweep(A, B, lo, hi, window=window,
                                    width=width, measure=measure))
    got = tcorr.corridor_sweep(_t(A), _t(B), _t(_np(lo)), _t(_np(hi)),
                               window=window, width=width, measure=measure)
    assert got.shape == (8, 1)
    _assert_bits(got.numpy(), want, measure, L)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("L,window", [(64, 6), (128, 12)])
def test_certify_adaptive_matches_jax(measure, L, window):
    A, B = _walks(L + window, 10, L)
    width = jtune.adaptive_width(L, window)
    lo, hi = jcorr.build_corridor(A, B, window)
    want = _np(jcorr.certify_adaptive(A, B, lo, hi, window=window,
                                      width=width, measure=measure))
    got = tcorr.certify_adaptive(_t(A), _t(B), _t(_np(lo)), _t(_np(hi)),
                                 window=window, width=width,
                                 measure=measure)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("L,window", [(64, 6), (128, 12), (40, None)])
def test_static_corridor_equals_static_band(measure, L, window):
    """With the static band as every pair's corridor and the reference's
    static width, the adaptive sweep is the static route to the bit."""
    A, B = _walks(3 * L, 7, L)
    lo, hi = tcorr.static_band(L, window)
    got = dtw_band_adaptive(_t(A), _t(B), (lo.expand(7, -1),
                                           hi.expand(7, -1)),
                            band_width(L, window), window, measure)
    np.testing.assert_array_equal(
        got.numpy(), dtw_batch(_t(A), _t(B), window, measure).numpy())


def test_prefix_sum_is_the_reference_scan():
    """ERP's borders: the log-depth scan of the reference kernel, which a
    running sum does not reproduce on every input."""
    from repro.kernels.dtw_band.kernel import _prefix_sum
    x = np.abs(np.random.default_rng(0).standard_normal((5, 100))).astype(
        np.float32) * 1e3
    np.testing.assert_array_equal(prefix_sum(_t(x)).numpy(),
                                  _np(_prefix_sum(x, 100)))


@pytest.mark.parametrize("backend", ["jax", "pallas_interpret"])
def test_elastic_pairwise_adaptive_matches_jax(backend):
    A, B = _warped(3, 8, 64, drift=2)
    with jdispatch.use_backend(backend):
        want = _np(jdispatch.elastic_pairwise(A, B, 6, band="adaptive"))
    tdispatch.reset_stats()
    got = tdispatch.elastic_pairwise(_t(A), _t(B), 6, band="adaptive")
    np.testing.assert_array_equal(got.numpy(), want)
    assert tdispatch.stats[("elastic_pairwise_adaptive", "torch")] == 1
    assert tdispatch.stats[("elastic_pairwise_adaptive[dtw]", "torch")] == 1
    assert ("elastic_pairwise", "torch") not in tdispatch.stats


def test_adaptive_upper_bound_and_certified_equal():
    """Anti-correlated walks under a tight corridor (factor 4, radius 0,
    width 8): adaptive >= static everywhere, equal where certified."""
    A, B = _walks(5, 12, 64)
    lo, hi = tcorr.clip_to_width(*tcorr.build_corridor(
        _t(A), _t(B), 16, factor=4, radius=0), 8)
    static = tdispatch.elastic_pairwise(_t(A), _t(B), 16)
    adaptive = tdispatch.elastic_pairwise(_t(A), _t(B), 16, band="adaptive",
                                          corridor=(lo, hi), width=8)
    assert bool((adaptive >= static).all())
    cert = tcorr.certify_adaptive(_t(A), _t(B), lo, hi, window=16, width=8)
    assert 0 < int(cert.sum()) < 12
    assert torch.equal(adaptive[cert], static[cert])
    assert bool((adaptive[~cert] > static[~cert]).any())


# -- adaptive cascade, search, index ---------------------------------------------

def _thresholds(lb):
    th = np.where(np.arange(len(lb)) % 2 == 0, lb * 1.5 + 0.1,
                  lb * 0.5 - 0.1).astype(np.float32)
    th[3::7] = -INF
    th[5::7] = INF
    return th


@pytest.mark.parametrize("data,L,window", [("walks", 64, 6),
                                           ("cbf", 128, 12),
                                           ("warped", 64, None)])
def test_lb_refine_adaptive_matches_jax(data, L, window):
    A, B = DATA[data](L, 21, L)
    w_env = L - 1 if window is None else window
    up, lo = (_np(e) for e in jenvelope(A, w_env))
    lb = cascade_bound(*map(_t, (B, A, up, lo))).numpy()
    th = _thresholds(lb)
    with jdispatch.use_backend("jax"):
        want_d, want_f = (_np(x) for x in jdispatch.lb_refine(
            A, B, up, lo, th, window, band="adaptive"))
    tdispatch.reset_stats()
    got_d, got_f = tdispatch.lb_refine(*map(_t, (A, B, up, lo, th)), window,
                                       band="adaptive")
    assert tdispatch.stats[("lb_refine_adaptive", "torch")] == 1
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    assert 0 < want_f.sum() < 21
    # refined: the corridor cost, to the bit; pruned: the bound, whose sum
    # runs in another order in each package
    np.testing.assert_array_equal(got_d.numpy()[want_f], want_d[want_f])
    np.testing.assert_allclose(got_d.numpy()[~want_f], want_d[~want_f],
                               **TOL)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("data", ["cbf", "warped"])
def test_filtered_topk_adaptive_matches_jax(data, k):
    Q, X = DATA[data](k, 6, 64)
    X = np.concatenate([X, Q[::-1] + 0.5, X[::-1] + 2.0])
    with jdispatch.use_backend("jax"):
        want_d, want_i, want_n = jfiltered_topk(Q, X, 6, k, band="adaptive")
    got_d, got_i, got_n = filtered_topk(_t(Q), _t(X), 6, k, band="adaptive")
    np.testing.assert_array_equal(got_i.numpy(), _np(want_i))
    np.testing.assert_allclose(got_d.numpy(), _np(want_d), **TOL)
    # the adaptive top-k distances are never below the static ones
    static_d, _, _ = filtered_topk(_t(Q), _t(X), 6, k)
    assert bool((got_d >= static_d).all())


def test_filtered_topk_rejects_unknown_band():
    Q, X = _walks(8, 2, 32)
    with pytest.raises(ValueError, match="band"):
        filtered_topk(_t(Q), _t(X), 4, 1, band="wavy")


def test_index_adaptive_search_matches_jax():
    """``IndexConfig(band="adaptive")`` searches (hot rows through the
    adaptive cascade) with the reference's top-k."""
    import jax
    X, _ = cbf(n_per_class=12, length=48, seed=0)
    Q, _ = cbf(n_per_class=2, length=48, seed=7)
    X = X.astype(np.float32)
    Q = np.concatenate([Q.astype(np.float32), X[[4, 30]]])
    kw = dict(n_sub=4, codebook_size=8, use_prealign=False, kmeans_iters=2,
              dba_iters=1)
    base = dict(n_lists=4, hot_capacity=12, coarse_iters=3, band="adaptive")
    jcfg = jindex.IndexConfig(pq=jpq.PQConfig(**kw), **base)
    tcfg = tindex.IndexConfig(pq=tpq.PQConfig(**kw), **base)
    with jdispatch.use_backend("jax"):
        boot = jindex.StreamingIndex.bootstrap(jax.random.PRNGKey(0), X,
                                               jcfg)
    j = jindex.StreamingIndex.from_parts(jcfg, boot.coarse, boot.cb,
                                         boot.dim)
    t = tindex.StreamingIndex.from_parts(tcfg, np.asarray(boot.coarse),
                                         boot.cb, boot.dim,
                                         two_level=j.two_level, device="cpu")
    for idx in (j, t):
        idx.insert(X[:30])
        idx.delete([3, 28])
    tdispatch.reset_stats()
    for n_probe, topk in ((1, 3), (4, 6)):
        with jdispatch.use_backend("jax"):
            want_d, want_i = j.search(Q, n_probe=n_probe, topk=topk)
        got_d, got_i = t.search(Q, n_probe=n_probe, topk=topk)
        np.testing.assert_array_equal(got_i.numpy(), _np(want_i))
        np.testing.assert_allclose(got_d.numpy(), _np(want_d), **TOL)
    assert tdispatch.stats[("lb_refine_adaptive", "torch")] > 0


# -- tuner ---------------------------------------------------------------------

@pytest.mark.parametrize("L", [8, 33, 64, 128, 512, 1000])
def test_adaptive_width_matches_jax(L):
    for window in (None, 0, 1, 5, L // 10, L // 2, L - 1, 2 * L):
        for factor, radius in ((8, 2), (4, 0), (16, 3)):
            assert ttune.adaptive_width(L, window, factor=factor,
                                        radius=radius) == \
                jtune.adaptive_width(L, window, factor=factor, radius=radius)
        for lane in (8, 128):
            assert band_width(L, window, lane) == jband_width(L, window, lane)


def test_table_key_matches_jax():
    for L, window, measure in ((512, 51, None), (64, None, "erp"),
                               (100, 7, "wdtw")):
        assert ttune.table_key("adaptive_width", length=L, window=window,
                               measure=measure, backend="cuda") == \
            jtune.table_key("adaptive_width", length=L, window=window,
                            measure=measure, backend="cuda")


def test_tune_off_and_pinned(tmp_path, monkeypatch):
    monkeypatch.setenv(ttune.ENV, "off")
    ttune.reset()
    assert ttune.tuned("adaptive_width", "width", length=512, window=51,
                       default=7) == 7
    key = ttune.table_key("adaptive_width", length=512, window=51,
                          measure="dtw", backend="cuda")
    path = tmp_path / "pinned.json"
    path.write_text(json.dumps({key: {"width": 16}}))
    monkeypatch.setenv(ttune.ENV, str(path))
    ttune.reset()
    for _ in range(2):
        assert ttune.adaptive_width(512, 51, measure="dtw",
                                    backend="cuda") == 16
    # another backend or geometry is not pinned: the default
    assert ttune.adaptive_width(512, 51, measure="dtw", backend="torch") == 32
    assert ttune.adaptive_width(4096, 400, measure="dtw",
                                backend="cuda") == 32
    # a pinned width reaches the adaptive sweep through the dispatch
    A, B = _walks(1, 4, 64)
    key = ttune.table_key("adaptive_width", length=64, window=6,
                          measure="dtw", backend="torch")
    path.write_text(json.dumps({key: {"width": 4}}))
    ttune.reset()
    got = tdispatch.elastic_pairwise(_t(A), _t(B), 6, band="adaptive")
    lo, hi = tcorr.clip_to_width(*tcorr.build_corridor(_t(A), _t(B), 6), 4)
    assert torch.equal(got, dtw_band_adaptive(_t(A), _t(B), (lo, hi), 4, 6))
    # auto mode measures launch geometries only: the width is part of the
    # result, has no runner, and stays the default
    monkeypatch.setenv(ttune.ENV, "auto")
    monkeypatch.setenv(ttune.OUT_ENV, str(tmp_path / "auto"))
    ttune.reset()
    assert ttune.adaptive_width(64, 6, measure="dtw", backend="torch") == 8
    assert not (tmp_path / "auto").exists()
