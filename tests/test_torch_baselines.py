"""The port's baseline distances (``repro_torch.core.baselines``) and the
§4.2 clustering distance ``pq.cdist_sym_refined`` on the CPU, held
against the JAX package within ``rtol=1e-5, atol=1e-4``; cDTW (the
same cell arithmetic, the root rounded once by ``measures.sqrt_rn``) and
SAX (numpy in both) bit for bit.

ED is held as squared distances against the norms' sum
(``table1_accuracy.ed_close``): ``|a|^2 + |b|^2 - 2 a.b`` rounds
relative to the norms, and the square root lifts a near pair's rounding
to about 1e-2.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import dispatch as jdispatch
from repro.core import pq as jpq
from repro.data.timeseries import make_dataset
from repro_torch.core import baselines as tbase
from repro_torch.core import pq as tpq
from repro_torch.bench.table1_accuracy import ed_close

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-4)


def _series(seed, n, L):
    return np.random.default_rng(seed).standard_normal((n, L)).astype(
        np.float32)


@pytest.mark.parametrize("n,m,L", [(5, 7, 16), (40, 33, 96)])
def test_ed_cdist_matches_reference(n, m, L):
    A, B = _series(n, n, L), _series(m + 1, m, L)
    for pair in ((A, B), (A, A)):
        got = tbase.ed_cdist(*pair, device=CPU)
        want = np.asarray(jbase.ed_cdist(*pair))
        assert ed_close(got.numpy(), want, *pair)


@pytest.mark.parametrize("frac", [0.05, 0.10, None])
@pytest.mark.parametrize("L", [40, 96])
def test_cdtw_cdist_matches_reference(frac, L):
    A, B = _series(L, 9, L), _series(L + 1, 11, L)
    w = None if frac is None else max(1, int(frac * L))
    with jdispatch.use_backend("jax"):
        want = np.asarray(jbase.cdtw_cdist(A, B, w))
    got = tbase.cdtw_cdist(A, B, w, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sqrt_rn_is_correctly_rounded():
    """``sqrt_rn`` equals numpy's float32 root (IEEE, as XLA's) on values
    across many binades, squares of floats and their neighbours."""
    from repro_torch.core.measures import sqrt_rn
    rng = np.random.default_rng(7)
    x = (rng.random(200_000) * 10.0 ** rng.integers(-8, 8, 200_000)).astype(
        np.float32)
    r = rng.random(1000).astype(np.float32)
    sq = (r * r).astype(np.float32)
    x = np.concatenate([x, sq, np.nextafter(sq, np.float32(2)), [0.0]]
                       ).astype(np.float32)
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def test_cdtw_cdist_counts_as_elastic_cdist():
    from repro_torch.core import dispatch
    dispatch.reset_stats()
    tbase.cdtw_cdist(_series(0, 3, 12), _series(1, 4, 12), None, device=CPU)
    assert dispatch.stats[("elastic_cdist", "torch")] == 1


@pytest.mark.parametrize("n,m,block", [(70, 13, 64), (70, 13, 16),
                                       (5, 9, 64), (64, 3, 64)])
def test_sbd_cdist_matches_reference(n, m, block):
    A, B = _series(n + 2, n, 48), _series(m + 3, m, 48)
    want = np.asarray(jbase.sbd_cdist(A, B, block=block))
    got = tbase.sbd_cdist(A, B, block, device=CPU)
    assert got.shape == (n, m)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sbd_cdist_self_distance_near_zero():
    A = _series(9, 6, 32)
    d = tbase.sbd_cdist(A, A, device=CPU).numpy()
    np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-5)
    assert (d >= -1e-5).all() and (d <= 2 + 1e-5).all()


@pytest.mark.parametrize("L,n_seg,alphabet", [(96, 19, 4), (100, 7, 3),
                                              (64, 8, 8), (17, 5, 2)])
def test_sax_equal_reference(L, n_seg, alphabet):
    A, B = _series(L, 8, L), _series(L + 7, 6, L)
    sa = tbase.sax_transform(torch.from_numpy(A), n_seg, alphabet)
    sb = tbase.sax_transform(B, n_seg, alphabet)
    np.testing.assert_array_equal(sa, jbase.sax_transform(A, n_seg, alphabet))
    np.testing.assert_array_equal(sb, jbase.sax_transform(B, n_seg, alphabet))
    np.testing.assert_array_equal(
        tbase.sax_mindist_cdist(sa, sb, L, alphabet),
        jbase.sax_mindist_cdist(sa, sb, L, alphabet))


def test_gauss_breakpoints_equal_reference():
    assert tbase.GAUSS_BREAKPOINTS == jbase.GAUSS_BREAKPOINTS


@pytest.fixture(scope="module")
def refined_case():
    """The reference's codebook, codes and segments on CBF at L = 64."""
    X, _ = make_dataset("cbf", 6, 64, seed=4)
    Q, _ = make_dataset("cbf", 3, 64, seed=104)
    cfg = jpq.PQConfig(n_sub=4, codebook_size=5, kmeans_iters=2,
                       dba_iters=1)
    with jdispatch.use_backend("jax"):
        cb = jpq.fit(jax.random.PRNGKey(3), X, cfg)
        ca, cq = jpq.encode(X, cb, cfg), jpq.encode(Q, cb, cfg)
    sa, sq = jpq.segment(X, cfg), jpq.segment(Q, cfg)
    return cb, [np.asarray(t) for t in (ca, sa, cq, sq)]


@pytest.mark.parametrize("pair", ["aa", "qa"])
def test_cdist_sym_refined_matches_reference(refined_case, pair):
    cb, (ca, sa, cq, sq) = refined_case
    left = (ca, sa) if pair == "aa" else (cq, sq)
    want = np.asarray(jpq.cdist_sym_refined(*left, ca, sa, cb))
    got = tpq.cdist_sym_refined(*left, ca, sa,
                                tpq.codebook_from_numpy(cb, device=CPU),
                                device=CPU).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not ((got == 0) & (want > 0)).any()
    # shared codes make the plain symmetric distance 0 where the refined
    # one is a positive bound
    same = (left[0][:, None, :] == ca[None, :, :]).all(-1)
    assert (want[~same] > 0).all()


def test_cdist_sym_refined_blocks_are_seamless(refined_case, monkeypatch):
    """Row blocks cut under a small byte cap give the same bits."""
    cb, (ca, sa, _, _) = refined_case
    book = tpq.codebook_from_numpy(cb, device=CPU)
    whole = tpq.cdist_sym_refined(ca, sa, ca, sa, book, device=CPU)
    S = sa.shape[-1]
    monkeypatch.setattr(tpq, "BOUND_CHUNK_BYTES", 16 * ca.shape[0] * S * 5)
    cut = tpq.cdist_sym_refined(ca, sa, ca, sa, book, device=CPU)
    assert torch.equal(whole, cut)


def test_entry_points_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = _series(0, 2, 8)
    for fn in (lambda: tbase.ed_cdist(A, A),
               lambda: tbase.cdtw_cdist(A, A, 2),
               lambda: tbase.sbd_cdist(A, A)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
