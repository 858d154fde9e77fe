"""The plain reference against straightforward hand versions: banded DTW
against a float64 dynamic program, the pre-alignment's geometry, the
encode's tie rules, and the compared numbers on hand-made answers."""

import numpy as np
import pytest
import torch

from portbench.reference import checks, dtw, pq, prealign
from portbench.reference.geometry import pq_geometry


def _dp(a, b, w):
    L = len(a)
    T = np.full((L, L), np.inf)
    for i in range(L):
        for j in range(max(0, i - w), min(L, i + w + 1)):
            c = (float(a[i]) - float(b[j])) ** 2
            if i == 0 and j == 0:
                T[i, j] = c
                continue
            best = min(T[i - 1, j - 1] if i and j else np.inf,
                       T[i - 1, j] if i else np.inf,
                       T[i, j - 1] if j else np.inf)
            T[i, j] = c + best
    return T[L - 1, L - 1]


@pytest.mark.parametrize("L,w", [(1, 0), (2, 0), (7, 1), (9, 2), (12, 11),
                                 (16, 3), (15, 20)])
def test_band_dtw_is_the_dynamic_program(L, w):
    g = torch.Generator().manual_seed(L * 31 + w)
    A = torch.randn(6, L, generator=g).cumsum(1)
    B = torch.randn(6, L, generator=g).cumsum(1)
    got = dtw.band_dtw(A, B, w).double().numpy()
    want = [_dp(a, b, min(w, L - 1)) for a, b in zip(A.numpy(), B.numpy())]
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_cdist_is_the_zipped_sweep():
    g = torch.Generator().manual_seed(3)
    A, B = torch.randn(5, 20, generator=g), torch.randn(7, 20, generator=g)
    full = dtw.band_cdist(A, B, 3, rows=2)
    zipped = dtw.band_dtw(A.repeat_interleave(7, 0), B.repeat(5, 1), 3)
    assert torch.equal(full.flatten(), zipped)


def test_bfloat16_sweep_runs_in_bfloat16():
    g = torch.Generator().manual_seed(4)
    A, B = torch.randn(4, 30, generator=g), torch.randn(4, 30, generator=g)
    lo = dtw.band_dtw(A, B, 3, dtype=torch.bfloat16)
    assert lo.dtype == torch.bfloat16
    torch.testing.assert_close(lo.float(), dtw.band_dtw(A, B, 3),
                               rtol=5e-2, atol=5e-2)


def test_prealign_geometry():
    g = torch.Generator().manual_seed(5)
    X = torch.randn(6, 64, generator=g).cumsum(1)
    segs = prealign.prealign(X, 4, 3, 3)
    assert segs.shape == (6, 4, 16 + 3)
    # the first segment starts at point 0 and the last ends at point D-1
    assert torch.equal(segs[:, 0, 0], X[:, 0])
    assert torch.equal(segs[:, -1, -1], X[:, -1])


def test_geometry_of_the_configurations():
    geo = pq_geometry({"n_sub": 8, "codebook_size": 256, "window_frac": 0.1,
                       "tail_frac": 0.15, "refine_frac": 0.125,
                       "wavelet_level": 3}, 1024)
    assert (geo.tail, geo.S, geo.window, geo.refine_t) == (19, 147, 15, 32)
    geo = pq_geometry({"n_sub": 4, "codebook_size": 256, "window_frac": 0.1,
                       "tail_frac": 0.15, "refine_frac": 0.125,
                       "wavelet_level": 3}, 96)
    assert (geo.tail, geo.S, geo.window) == (4, 28, 3)


def test_encode_keeps_the_lowest_bound_first():
    # two identical centroids: equal bounds and costs, the lower index wins
    c = torch.tensor([[[0.0, 1.0, 0.0], [0.0, 1.0, 0.0], [5.0, 5.0, 5.0]]])
    cb = pq.make_codebook(c, 1)
    segs = torch.tensor([[[0.0, 1.0, 0.0]], [[5.0, 4.0, 5.0]]])
    assert pq.encode(segs, cb, 2).flatten().tolist() == [0, 2]


def test_envelope_is_the_window_extreme():
    x = torch.tensor([[3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0]])
    up, lo = pq.envelope(x, 1)
    assert up.tolist() == [[3, 4, 4, 5, 9, 9, 9]]
    assert lo.tolist() == [[1, 1, 1, 1, 1, 2, 2]]


def test_nn_gap():
    d = torch.tensor([[1.0, 2.0, 4.0], [3.0, 3.0, 0.5]])
    assert checks.nn_gap(d, torch.tensor([0, 2])) == 0.0
    # the second query's nearest is 0.5, and so is the median nearest
    # (torch's median: the lower of the two middle values)
    assert checks.nn_gap(d, torch.tensor([0, 0])) == pytest.approx(
        (3.0 - 0.5) / 0.5)
    assert checks.nn_gap(d, torch.tensor([0, 3])) == float("inf")
