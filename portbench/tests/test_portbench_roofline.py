"""Every roofline and mfu count against a hand count at a small shape."""

import pytest

from portbench import roofline as rl


@pytest.mark.parametrize("L,w", [(1, 0), (4, 0), (4, 1), (5, 2), (6, 9),
                                 (28, 3), (147, 15)])
def test_band_cells_by_brute_force(L, w):
    assert rl.band_cells(L, w) == sum(
        1 for i in range(L) for j in range(L) if abs(i - j) <= w)


def test_dtw_pairs_by_hand():
    # 2 series x 3 subspaces x 2 candidates = 12 pairs of length 4, band
    # 1: 10 cells a pair, 6 ops a cell; in: 2 x 3 segments of 4 floats,
    # 3 x 5 centroids of 4 floats, 12 int32 candidates; out: 12 costs
    w = rl.dtw_pairs(2, 3, 5, 2, 4, 1)
    assert w == rl.Work(12 * 10 * 6, (24 + 60 + 12 + 12) * 4)


def test_dtw_pairs_reads_each_input_once():
    # starlight's refine: 2,108,416 pairs; the bytes are the segments,
    # centroids, candidates and costs, not a row of each side a pair
    n, M, K, T, S, w = 8236, 8, 256, 32, 147, 15
    work = rl.dtw_pairs(n, M, K, T, S, w)
    assert work.nbytes == (n * M * S + M * K * S + 2 * n * M * T) * 4
    assert work.nbytes < 2 * n * M * T * S * 4 / 10


def test_adc_sym_by_hand():
    # 2 x 3 outputs over M = 2 subspaces of K = 4: two adds and a root an
    # output; codes (2 + 3) x 2 int32, the 2 x 4 x 4 table, 6 outputs
    w = rl.adc_sym(2, 3, 2, 4)
    assert w == rl.Work(2 * 3 * 3, (10 + 32 + 6) * 4)


def test_lb_filter_by_hand():
    w = rl.lb_filter(2, 1, 3, 5)
    assert w.ops == 2 * 1 * 3 * (5 * 5 + 6)
    assert w.nbytes == (2 * 5 + 3 * 3 * 5 + 2 * 3) * 4


def test_classify_step_by_hand():
    n, n_train, D, M, K, S, w, T, J = 2, 3, 8, 2, 4, 5, 1, 2, 3
    ops = (n * (2 * J * D + 2 * D + 4 * M * S)          # pre-alignment
           + n * M * K * (5 * S + 6)                     # LB bounds
           + n * M * T * rl.band_cells(S, w) * 6         # refine
           + n * n_train * (M + 2))                      # ADC, root, argmin
    nbytes = (n * D * 4 + n_train * M * 4 + n_train * 8 + M * K * K * 4
              + 3 * M * K * S * 4 + n * 8)
    assert rl.classify_step(n, n_train, D, M, K, S, w, T, J) == rl.Work(
        ops, nbytes)


def test_bound_is_the_larger_term():
    assert rl.Work(67e12, 0).bound_s() == pytest.approx(1.0)
    assert rl.Work(0, 3.35e12).bound_s() == pytest.approx(1.0)
    assert rl.Work(67e12, 6.7e12).bound_s() == pytest.approx(2.0)


def test_starlight_step_is_compute_bound():
    # the configuration's step: 8236 x 1024 against 1000 codes
    w = rl.classify_step(8236, 1000, 1024, 8, 256, 147, 15, 32, 3)
    assert w.ops / rl.FP32_FLOPS > w.nbytes / rl.HBM_BYTES_PER_S
    assert 0.9e-3 < w.bound_s() < 1.2e-3
