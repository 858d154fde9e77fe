"""The port's LB cascade (``lb_refine``), its exact pruned search
(``filtered_topk``) and ``nn_dtw_pruned`` (CPU route) held against the JAX
package on the same seeded numpy inputs.

Ids identical; distances within ``rtol=1e-5, atol=1e-4``.  Threshold
ties: the bound is a sum whose order differs between the two packages
(and between a kernel and its plain version), so a bound within an ulp of
its threshold may flip its flag.  The ``lb_refine`` cases use thresholds
that no bound comes near, and compare distances where the flags agree.
The pruning statistics (``n_refined``, ``n_waves``) may differ by such
flips; the top-k never does.
"""

import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import knn as jknn
from repro.core import lb as jlb
from repro.core import lb_search as jlb_search
from repro.kernels.lb_cascade.ops import lb_refine as jlb_refine_pallas
from repro.kernels.lb_cascade.ref import lb_refine_jax
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import knn as tknn
from repro_torch.core import lb as tlb
from repro_torch.core import lb_search as tlb_search

TOL = dict(rtol=1e-5, atol=1e-4)
INF = np.float32(np.inf)


def _walks(rng, n, L):
    return np.cumsum(rng.standard_normal((n, L)), 1).astype(np.float32)


def _pairs(seed, n, L, window):
    rng = np.random.default_rng(seed)
    A, B = _walks(rng, n, L), _walks(rng, n, L)
    w_env = L - 1 if window is None else min(window, L - 1)
    up, lo = (np.asarray(e) for e in jlb.keogh_envelope(A, w_env))
    return A, B, up, lo


def _thresholds(lb):
    """Refine (bound + 50% + 0.1), prune (half the bound - 0.1), -inf and
    +inf in turn: no threshold within reach of its bound."""
    th = np.where(np.arange(len(lb)) % 2 == 0, lb * 1.5 + 0.1,
                  lb * 0.5 - 0.1).astype(np.float32)
    th[3::7] = -INF
    th[5::7] = INF
    return th


def _t(x):
    return torch.from_numpy(np.array(x))


def test_envelope_and_bounds_match_jax():
    A, B, up, lo = _pairs(1, 9, 40, 4)
    tup, tlo = tlb.keogh_envelope(_t(A), 4)
    np.testing.assert_array_equal(tup.numpy(), up)
    np.testing.assert_array_equal(tlo.numpy(), lo)
    cents, q = B.reshape(9, 40), A[0]
    np.testing.assert_allclose(
        tlb.lb_cascade(_t(q), _t(cents), _t(up), _t(lo)).numpy(),
        np.asarray(jlb.lb_cascade(q, cents, up, lo)), **TOL)


@pytest.mark.parametrize("n,L,window", [(23, 16, 3), (40, 32, None),
                                        (17, 48, 6)])
def test_lb_refine_plain_matches_jax(n, L, window):
    A, B, up, lo = _pairs(n * L, n, L, window)
    lb = tlb.cascade_bound(*map(_t, (B, A, up, lo))).numpy()
    th = _thresholds(lb)
    want_d, want_f = (np.asarray(x) for x in
                      lb_refine_jax(A, B, up, lo, th, window))
    got_d, got_f = tdispatch.lb_refine(*map(_t, (A, B, up, lo, th)), window)
    assert got_f.dtype == torch.bool
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    assert 0 < want_f.sum() < n
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL)


def test_lb_refine_plain_matches_pallas_interpret():
    A, B, up, lo = _pairs(7, 12, 16, 3)
    lb = tlb.cascade_bound(*map(_t, (B, A, up, lo))).numpy()
    th = _thresholds(lb)
    want_d, want_f = (np.asarray(x) for x in jlb_refine_pallas(
        A, B, up, lo, th, 3, block=4, interpret=True))
    got_d, got_f = tdispatch.lb_refine(*map(_t, (A, B, up, lo, th)), 3)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL)


def test_lb_refine_counts_and_rejects():
    A, B, up, lo = _pairs(3, 4, 16, 2)
    th = np.full(4, INF)
    tdispatch.reset_stats()
    tdispatch.lb_refine(*map(_t, (A, B, up, lo, th)), 2)
    assert tdispatch.stats[("lb_refine", "torch")] == 1
    assert tdispatch.stats[("lb_refine[dtw]", "torch")] == 1
    with pytest.raises(ValueError, match="no sound Keogh"):
        tdispatch.lb_refine(*map(_t, (A, B, up, lo, th)), 2, measure="erp")
    tdispatch.lb_refine(*map(_t, (A, B, up, lo, th)), 2, band="adaptive")
    assert tdispatch.stats[("lb_refine_adaptive", "torch")] == 1
    assert tdispatch.stats[("lb_refine", "torch")] == 1
    with pytest.raises(ValueError, match="band"):
        tdispatch.lb_refine(*map(_t, (A, B, up, lo, th)), 2, band="wavy")


def _search_data(seed, N=64, Nq=7, L=32):
    rng = np.random.default_rng(seed)
    X = _walks(rng, N, L)
    X[10] = X[3]                       # duplicate rows: ties in distance
    X[40] = X[3]
    Q = _walks(rng, Nq, L)
    Q[0] = X[3]                        # a query that is a database row
    Q[1] = X[20]
    valid = rng.random(N) > 0.2
    valid[[3, 10, 20]] = True
    q_valid = np.ones(Nq, bool)
    q_valid[4] = False
    return X, Q, valid, q_valid


def _jax_topk(Q, X, window, k, measure, **kw):
    with jdispatch.use_backend("jax"):
        d, idx, third = jlb_search.filtered_topk(Q, X, window, k,
                                                 measure=measure, **kw)
    return np.asarray(d), np.asarray(idx), third


@pytest.mark.parametrize("measure", ["dtw", "wdtw:g=0.1", "erp:g=0.3",
                                     "msm:c=0.5"])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("masks", [False, True])
def test_filtered_topk_matches_jax(measure, k, masks):
    X, Q, valid, q_valid = _search_data(k + 11 * masks)
    window = 4
    kw = {}
    if masks:
        kw = dict(valid=valid, q_valid=q_valid)
    want_d, want_i, _ = _jax_topk(Q, X, window, k, measure, **kw)
    got_d, got_i, n_ref = tlb_search.filtered_topk(
        _t(Q), _t(X), window, k, measure=measure,
        **{name: _t(v) for name, v in kw.items()})
    assert got_i.dtype == torch.int32 and got_d.shape == (len(Q), k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL)
    assert got_i[0, 0] == 3                  # the query that is row 3
    if k > 1 and measure == "dtw" and not masks:
        assert got_i[0, :3].tolist() == [3, 10, 40]   # duplicates in order
    if masks:
        assert (got_i.numpy()[4] == -1).all()
        assert not np.isin(got_i.numpy(), np.flatnonzero(~valid)).any()
    assert int(n_ref) <= len(Q) * len(X)


@pytest.mark.parametrize("measure", ["dtw", "erp:g=0.3"])
def test_filtered_topk_stats_match_jax(measure):
    X, Q, valid, q_valid = _search_data(5)
    want_d, want_i, want_st = _jax_topk(Q, X, None, 3, measure,
                                        valid=valid, q_valid=q_valid,
                                        with_stats=True)
    got_d, got_i, st = tlb_search.filtered_topk(
        _t(Q), _t(X), None, 3, measure=measure, valid=_t(valid),
        q_valid=_t(q_valid), with_stats=True)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL)
    assert int(st["n_bounded"]) == int(want_st["n_bounded"]) \
        == int(q_valid.sum()) * int(valid.sum())
    assert 0 < int(st["n_refined"]) <= int(st["n_bounded"])
    assert int(st["refined_per_wave"].sum()) == int(st["n_refined"])
    assert int(st["n_waves"]) >= 1
    if measure == "dtw":
        # the cascade pruned something, as the reference's does
        assert int(st["n_refined"]) < int(st["n_bounded"])
        assert int(want_st["n_refined"]) < int(want_st["n_bounded"])


def test_filtered_topk_bounds_chunked(monkeypatch):
    """A tiny chunk cap splits the phase-1 bound into many query chunks
    and changes nothing."""
    X, Q, _, _ = _search_data(8)
    full = tlb_search.filtered_topk(_t(Q), _t(X), 4, 3)
    monkeypatch.setattr(tlb_search, "BOUND_CHUNK_BYTES", 1)
    chunked = tlb_search.filtered_topk(_t(Q), _t(X), 4, 3)
    for a, b in zip(full, chunked):
        assert torch.equal(a, b)


def test_filtered_topk_rejects_k():
    X, Q, _, _ = _search_data(2)
    with pytest.raises(ValueError, match="out of range"):
        tlb_search.filtered_topk(_t(Q), _t(X), 4, 0)


@pytest.mark.parametrize("window,budget", [(5, None), (None, 16)])
def test_nn_dtw_pruned_matches_jax_and_exact(window, budget):
    rng = np.random.default_rng(9)
    X, Q = _walks(rng, 80, 40), _walks(rng, 12, 40)
    y = rng.integers(0, 3, 80)
    with jdispatch.use_backend("jax"):
        want, want_pruned = jknn.nn_dtw_pruned(X, y, Q, window,
                                               budget=budget)
    got, pruned = tknn.nn_dtw_pruned(X, y, Q, window, budget=budget,
                                     device="cpu")
    exact = tknn.nn_dtw_exact(X, y, Q, window, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), exact.numpy())
    assert 0.0 < pruned < 1.0 and 0.0 < want_pruned < 1.0


@pytest.mark.parametrize("k,window", [(1, 13), (10, 13), (3, 5)])
def test_pruning_stats_equal_reference_on_cbf(k, window):
    """On CBF the two packages' bounds agree to the last bit, so the waves
    select the same pairs: the pruning telemetry is equal, not just the
    top-k (the tie hazard above does not arise on this data)."""
    from repro.data.timeseries import make_dataset
    X, _ = make_dataset("cbf", 40, 128, seed=0)
    Q, _ = make_dataset("cbf", 6, 128, seed=100)
    with jdispatch.use_backend("jax"):
        _, want_i, want = jlb_search.filtered_topk(Q, X, window, k,
                                                   with_stats=True)
    _, got_i, got = tlb_search.filtered_topk(_t(Q), _t(X), window, k,
                                             with_stats=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    for key in ("n_bounded", "n_refined", "n_waves"):
        assert int(got[key]) == int(want[key]), key
    np.testing.assert_array_equal(got["refined_per_wave"].numpy(),
                                  np.asarray(want["refined_per_wave"]))
