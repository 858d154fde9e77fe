"""The port's MODWT pre-alignment and fused prealign+encode (CPU route)
held against the JAX package: segments within 1e-6, the lerp grid bit for
bit, codes identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import modwt as jmodwt
from repro.data.timeseries import make_dataset, random_walks
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import lb as tlb
from repro_torch.core import modwt as tmodwt
from repro_torch.data import timeseries as tts


@pytest.mark.parametrize("S", [1, 2, 5, 9, 13, 26, 37, 74, 75, 138])
def test_linspace_grid_is_bit_equal(S):
    want = np.asarray(jnp.linspace(0.0, 1.0, S, dtype=jnp.float32))
    got = tmodwt.linspace01(S).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n_sub,level,tail,D", [(4, 3, 2, 64), (8, 3, 10, 512),
                                                (3, 2, 5, 50), (2, 1, 0, 16)])
def test_prealign_segments_match(n_sub, level, tail, D):
    X, _ = make_dataset("cbf", 4, D, seed=D)
    want = np.asarray(jmodwt.prealign(X, n_sub, level, tail))
    got = tmodwt.prealign(torch.from_numpy(X), n_sub, level, tail).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_segment_points_and_splits_match():
    X = random_walks(6, 96, seed=3)
    X[:, 40:48] = 0.0          # a plateau: zeros carry the previous sign
    pts_j = np.asarray(jmodwt.segment_points(X, 3))
    pts_t = tmodwt.segment_points(torch.from_numpy(X), 3).numpy()
    np.testing.assert_array_equal(pts_t, pts_j)
    b_j = np.asarray(jmodwt.snap_splits(pts_j, 6, 5))
    b_t = tmodwt.snap_splits(torch.from_numpy(pts_t), 6, 5).numpy()
    np.testing.assert_array_equal(b_t, b_j)


@pytest.mark.parametrize("measure", ["dtw", "erp:g=0.3", "msm:c=0.5"])
def test_fused_encode_codes_identical(measure):
    X, _ = make_dataset("cbf", 5, 64, seed=1)
    rng = np.random.default_rng(2)
    M, K, tail = 4, 6, 2
    S = 64 // M + tail
    cents = rng.standard_normal((M, K, S)).astype(np.float32)
    with jdispatch.use_backend("jax"):
        want = np.asarray(jdispatch.prealign_encode(
            X, cents, level=3, tail=tail, window=2, measure=measure))
    got = tdispatch.prealign_encode(torch.from_numpy(X),
                                    torch.from_numpy(cents), level=3,
                                    tail=tail, window=2, measure=measure)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_encode_rejects_bad_geometry():
    with pytest.raises(ValueError, match="geometry"):
        tdispatch.prealign_encode(torch.zeros((2, 64)),
                                  torch.zeros((4, 3, 10)), level=2, tail=1)


@pytest.mark.parametrize("window", [0, 3, 40])
def test_keogh_envelope_and_bounds_match(window):
    from repro.core import lb as jlb
    X = random_walks(5, 40, seed=window)
    up_j, lo_j = jlb.keogh_envelope(X, window)
    up_t, lo_t = tlb.keogh_envelope(torch.from_numpy(X), window)
    np.testing.assert_array_equal(up_t.numpy(), np.asarray(up_j))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    q = random_walks(1, 40, seed=9)
    np.testing.assert_allclose(
        tlb.lb_keogh(torch.from_numpy(q), up_t, lo_t).numpy(),
        np.asarray(jlb.lb_keogh(q, up_j, lo_j)), rtol=1e-6)
    np.testing.assert_allclose(
        tlb.lb_kim(torch.from_numpy(q), torch.from_numpy(X)).numpy(),
        np.asarray(jlb.lb_kim(q, X)), rtol=1e-6)


def test_dataset_copy_matches_reference():
    for name in ("cbf", "trace", "gunpoint"):
        Xj, yj = make_dataset(name, 3, 40, seed=5)
        Xt, yt = tts.make_dataset(name, 3, 40, seed=5)
        np.testing.assert_array_equal(Xt, Xj)
        np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(tts.random_walks(3, 20, 1),
                                  random_walks(3, 20, 1))
