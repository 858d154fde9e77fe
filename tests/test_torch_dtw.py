"""The port's banded elastic costs (``repro_torch`` dispatch, CPU route)
held against the JAX package's dispatch and the numpy DP oracle.

Tolerance ``rtol=1e-5, atol=1e-4``, as the JAX kernel tests: the port
computes every cell with the same float32 operations, but WDTW's ``exp``
and ERP's prefix sums are evaluated by another library.
"""

import numpy as np
import pytest

from repro.core import dispatch as jdispatch
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import measures as tmeasures

import torch

MEASURES = ("dtw", "wdtw:g=0.1", "erp:g=0.3", "msm:c=0.5")
TOL = dict(rtol=1e-5, atol=1e-4)


def _pairs(seed, n, m, L):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, L)).astype(np.float32),
            rng.standard_normal((m, L)).astype(np.float32))


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("L", [16, 33])
def test_pairwise_matches_jax(measure, window, L):
    A, B = _pairs(L + len(measure), 6, 6, L)
    with jdispatch.use_backend("jax"):
        want = np.asarray(jdispatch.elastic_pairwise(A, B, window,
                                                     measure=measure))
    got = tdispatch.elastic_pairwise(torch.from_numpy(A), torch.from_numpy(B),
                                     window, measure=measure)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("L", [16, 33])
def test_cdist_matches_jax(measure, window, L):
    A, B = _pairs(3 * L, 5, 4, L)
    with jdispatch.use_backend("jax"):
        want = np.asarray(jdispatch.elastic_cdist(A, B, window,
                                                  measure=measure))
    got = tdispatch.elastic_cdist(torch.from_numpy(A), torch.from_numpy(B),
                                  window, measure=measure)
    assert got.shape == (5, 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("window", [None, 0, 2, 5])
def test_dtw_matches_numpy_oracle(dtw_ref, window):
    A, B = _pairs(window or 7, 4, 4, 16)
    got = tdispatch.elastic_pairwise(torch.from_numpy(A), torch.from_numpy(B),
                                     window).numpy()
    want = [dtw_ref(a, b, window) for a, b in zip(A, B)]
    np.testing.assert_allclose(got, want, **TOL)


def test_cdist_blocks_match_one_block():
    """Row blocks of the plain all-pairs sweep give the unblocked result."""
    from repro_torch.core.dtw import dtw_cdist
    A, B = _pairs(11, 9, 7, 12)
    A, B = torch.from_numpy(A), torch.from_numpy(B)
    np.testing.assert_array_equal(dtw_cdist(A, B, 2, block=7).numpy(),
                                  dtw_cdist(A, B, 2, block=1 << 18).numpy())


def test_pairwise_matches_pallas_interpret():
    """One tiny case against the TPU kernel body run in interpret mode."""
    A, B = _pairs(5, 3, 3, 12)
    with jdispatch.use_backend("pallas_interpret"):
        want = np.asarray(jdispatch.elastic_pairwise(A, B, 2))
    got = tdispatch.elastic_pairwise(torch.from_numpy(A), torch.from_numpy(B),
                                     2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("L,window", [(24, 3), (33, None), (17, 0)])
def test_full_width_sweep_matches_reference(L, window):
    """``dtw_band(mode="full")``, the reference's DTW-only full-width
    baseline, against its Pallas kernel in interpret mode: bit for bit
    (both contract the cell into an FMA), and equal to the compressed
    sweep.  Other measures raise, as in the reference."""
    from repro.kernels.dtw_band.ops import dtw_band as j_dtw_band
    from repro_torch.kernels.dtw_band.ops import dtw_band
    A, B = _pairs(L, 20, 20, L)
    want = np.asarray(j_dtw_band(A, B, window, mode="full", interpret=True))
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    got = dtw_band(At, Bt, window, mode="full")
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, dtw_band(At, Bt, window))
    with pytest.raises(ValueError, match="DTW-only"):
        dtw_band(At, Bt, window, measure="erp", mode="full")
    with pytest.raises(ValueError, match="mode"):
        dtw_band(At, Bt, window, mode="diagonal")


def test_ledger_counts_torch_route():
    tdispatch.reset_stats()
    A, B = _pairs(1, 2, 2, 8)
    tdispatch.elastic_pairwise(torch.from_numpy(A), torch.from_numpy(B), 2,
                               measure="erp")
    assert tdispatch.stats[("elastic_pairwise", "torch")] == 1
    assert tdispatch.stats[("elastic_pairwise[erp]", "torch")] == 1
    tdispatch.reset_stats()
    assert not tdispatch.stats
    assert tdispatch.totals[("elastic_pairwise", "torch")] >= 1


def test_unported_options_raise():
    """The opt-in options that once raised as not ported now run (the
    adaptive band, quantised tables); unknown values still raise."""
    A, B = (torch.from_numpy(x) for x in _pairs(2, 3, 3, 8))
    codes = torch.zeros((1, 2), dtype=torch.int32)
    lut = torch.ones((2, 4, 4))
    assert torch.equal(tdispatch.elastic_pairwise(A, B, 2, band="adaptive"),
                       tdispatch.elastic_pairwise(A, B, 2))   # Lc < 4
    d, refined = tdispatch.lb_refine(A, B, A, A, torch.full((3,), 1e9), 2,
                                     band="adaptive")
    assert bool(refined.all())
    assert torch.equal(d, tdispatch.elastic_pairwise(A, B, 2))
    assert torch.allclose(tdispatch.adc_cdist(codes, codes, lut,
                                              lut_dtype="int8"),
                          torch.full((1, 1), 2 ** 0.5))
    with pytest.raises(ValueError, match="band"):
        tdispatch.elastic_pairwise(A, B, 2, band="wavy")
    with pytest.raises(ValueError, match="band"):
        tdispatch.lb_refine(A, B, A, A, torch.zeros(3), band="wavy")
    with pytest.raises(ValueError, match="dtype"):
        tdispatch.adc_cdist(codes, codes, lut, lut_dtype="fp4")


def test_measure_registry_mirrors_reference():
    from repro.core import measures as jmeasures
    for name in ("dtw", "wdtw", "erp", "msm"):
        t, j = tmeasures.get_measure(name), jmeasures.get_measure(name)
        assert (t.params, t.has_keogh_lb, t.euclid_is_upper_bound,
                t.uses_gap_border, t.uses_neighbors, t.uses_position,
                t.can_prune, t.to_manifest()) == (
            j.params, j.has_keogh_lb, j.euclid_is_upper_bound,
            j.uses_gap_border, j.uses_neighbors, j.uses_position,
            j.can_prune, j.to_manifest())
    assert tmeasures.resolve("erp:g=1.5").param("g") == 1.5
    with pytest.raises(ValueError):
        tmeasures.resolve("nope")


@pytest.mark.parametrize("w", [0, 7, 51, 300])
def test_band_geometry_fits_every_window(w):
    """Band rows go to shared memory up to w=190 and to a bounded device
    scratch buffer beyond (allocated on the CPU here: only shapes count)."""
    from repro_torch.kernels.dtw_band.ops import band_geometry
    threads, blocks, scratch = band_geometry(10_000, w, torch.device("cpu"))
    assert 32 <= threads <= 128 and blocks >= 1
    if w <= 190:
        assert scratch is None
        assert threads * (2 * w + 2) * 4 <= 48 * 1024
        assert threads * blocks >= 10_000
    else:
        assert scratch.numel() == blocks * threads * (2 * w + 2)
        assert scratch.numel() * 4 <= 1 << 30
