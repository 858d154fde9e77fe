"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside the fixture, never at import)
where there is no CUDA device.  On a machine with an H100 and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Distances within ``rtol=1e-5, atol=1e-4`` (ERP's prefix sums are
sequential in the kernel and a parallel scan in ``torch.cumsum``); codes
identical.  ``lb_refine`` sums its bound sequentially where ``torch.sum``
makes a tree, so its cases use thresholds that no bound comes near; then
the refined flags are identical too.  The adaptive corridor kernels
(``dtw_band_adaptive``, ``lb_refine_adaptive``) are bit-identical to their
plain versions, and to ``dtw_band`` under the static-band corridor; the
quantised ADC kernels equal theirs (int8 and bfloat16).
"""

import pytest
import torch

from repro_torch.core import corridor as tcorr
from repro_torch.core import lb as tlb
from repro_torch.core import lb_search
from repro_torch.kernels import _build, tune
from repro_torch.kernels.dtw_band.ops import (band_width, dtw_band,
                                              dtw_band_adaptive,
                                              dtw_band_cdist)
from repro_torch.kernels.dtw_band.ref import (dtw_band_adaptive_ref,
                                              dtw_band_cdist_ref, dtw_band_ref)
from repro_torch.kernels.lb_cascade.ops import lb_refine
from repro_torch.kernels.lb_cascade.ref import lb_refine_ref
from repro_torch.kernels.pq_adc.ops import (adc_lookup, adc_lookup_quant,
                                           adc_sym_cdist,
                                           adc_sym_cdist_quant, quantize_lut)
from repro_torch.kernels.pq_adc.ref import (adc_lookup_quant_ref,
                                           adc_lookup_ref,
                                           adc_sym_cdist_quant_ref,
                                           adc_sym_cdist_ref)
from repro_torch.kernels.prealign_encode.ops import prealign_encode
from repro_torch.kernels.prealign_encode.ref import prealign_encode_ref

pytestmark = pytest.mark.cuda

MEASURES = ("dtw", "wdtw:g=0.1", "erp:g=0.3", "msm:c=0.5")
TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda")


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("L,window", [(33, 3), (74, 7), (40, None),
                                      (300, None)])
def test_dtw_band_matches_plain(gen, measure, L, window):
    A, B = _randn(gen, 37, L), _randn(gen, 37, L)
    before = _build.LAUNCHES["dtw_band"]
    got = dtw_band(A, B, window, measure)
    assert _build.LAUNCHES["dtw_band"] == before + 1
    torch.testing.assert_close(got, dtw_band_ref(A, B, window, measure),
                               **TOL)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("L,window", [(33, 3), (74, 7), (300, None)])
def test_dtw_band_cdist_matches_plain(gen, measure, L, window):
    A, B = _randn(gen, 19, L), _randn(gen, 7, L)
    got = dtw_band_cdist(A, B, window, measure)
    torch.testing.assert_close(
        got, dtw_band_cdist_ref(A, B, window, measure), **TOL)


def test_adc_matches_plain(gen):
    M, K = 8, 256
    lut = _randn(gen, M, K, K).abs()
    ca = torch.randint(0, K, (50, M), device="cuda", dtype=torch.int32)
    cb = torch.randint(0, K, (70, M), device="cuda", dtype=torch.int32)
    qlut = _randn(gen, 5, M, K).abs()
    torch.testing.assert_close(adc_sym_cdist(ca, cb, lut),
                               adc_sym_cdist_ref(ca, cb, lut), **TOL)
    torch.testing.assert_close(adc_lookup(cb, qlut),
                               adc_lookup_ref(cb, qlut), **TOL)
    torch.testing.assert_close(adc_lookup(cb, qlut[0]),
                               adc_lookup_ref(cb, qlut[0]), **TOL)


def test_adc_codes_out_of_range_raise(gen):
    M, K = 4, 16
    lut = _randn(gen, M, K, K).abs()
    good = torch.randint(0, K, (9, M), device="cuda", dtype=torch.int32)
    bad = good.clone()
    bad[3, 2] = K
    with pytest.raises(ValueError, match="codes_b holds codes outside"):
        adc_sym_cdist(good, bad, lut)
    with pytest.raises(ValueError, match="codes holds codes outside"):
        adc_lookup(-bad, lut[:, 0])


@pytest.mark.parametrize("measure", MEASURES)
def test_prealign_encode_matches_plain(gen, measure):
    X = torch.cumsum(_randn(gen, 24, 128), dim=1)
    cents = _randn(gen, 4, 16, 34)
    got = prealign_encode(X, cents, 3, 2, 3, measure)
    assert torch.equal(got, prealign_encode_ref(X, cents, 3, 2, 3, measure))


def test_mixed_devices_raise(gen):
    A = _randn(gen, 4, 16)
    with pytest.raises(ValueError):
        dtw_band(A, A.cpu(), 2)


@pytest.mark.parametrize("L,window", [(33, 3), (74, 7), (512, 51),
                                      (300, None)])
def test_lb_refine_matches_plain(gen, L, window):
    n = 301
    A = torch.cumsum(_randn(gen, n, L), 1)
    B = torch.cumsum(_randn(gen, n, L), 1)
    w = L - 1 if window is None else window
    up, lo = tlb.keogh_envelope(A, w)
    lb = tlb.cascade_bound(B, A, up, lo)
    th = torch.where(torch.arange(n, device="cuda") % 2 == 0, lb * 1.5 + 0.1,
                     lb * 0.5 - 0.1)
    th[3::7] = -float("inf")
    th[5::7] = float("inf")
    before = _build.LAUNCHES["lb_refine"]
    d, f = lb_refine(A, B, up, lo, th, window)
    assert _build.LAUNCHES["lb_refine"] == before + 1
    want_d, want_f = lb_refine_ref(A, B, up, lo, th, window)
    assert torch.equal(f, want_f)
    torch.testing.assert_close(d, want_d, **TOL)


def test_lb_refine_rejects_other_measures(gen):
    A = _randn(gen, 4, 16)
    with pytest.raises(ValueError, match="dtw only"):
        lb_refine(A, A, A, A, torch.zeros(4, device="cuda"), 2, "wdtw")


@pytest.mark.parametrize("k", [1, 7])
def test_filtered_topk_card_equals_cpu(gen, k):
    X = torch.cumsum(_randn(gen, 500, 128), 1)
    Q = torch.cumsum(_randn(gen, 37, 128), 1)
    Q[0] = X[11]
    X[300] = X[11]
    valid = torch.rand(500, generator=gen, device="cuda") > 0.1
    valid[[11, 300]] = True
    got_d, got_i, n_ref = lb_search.filtered_topk(Q, X, 13, k, valid=valid)
    want_d, want_i, _ = lb_search.filtered_topk(Q.cpu(), X.cpu(), 13, k,
                                                valid=valid.cpu())
    assert torch.equal(got_i.cpu(), want_i)
    torch.testing.assert_close(got_d.cpu(), want_d, **TOL)
    assert 0 < int(n_ref) < 37 * 500


def _corridor(gen, n, L, window, width=None):
    A = torch.cumsum(_randn(gen, n, L), 1)
    B = torch.cumsum(_randn(gen, n, L), 1)
    width = width or tune.adaptive_width(L, window)
    lo, hi = tcorr.clip_to_width(*tcorr.build_corridor(A, B, window), width)
    return A, B, lo, hi, width


@pytest.mark.parametrize("measure", ["dtw", "wdtw:g=0.1"])
@pytest.mark.parametrize("L,window", [(64, 6), (128, 12), (512, 51),
                                      (300, None)])
def test_dtw_band_adaptive_matches_plain(gen, measure, L, window):
    A, B, lo, hi, width = _corridor(gen, 203, L, window)
    before = _build.LAUNCHES["dtw_band_adaptive"]
    got = dtw_band_adaptive(A, B, (lo, hi), width, window, measure)
    assert _build.LAUNCHES["dtw_band_adaptive"] == before + 1
    assert torch.equal(got, dtw_band_adaptive_ref(A, B, lo, hi, window,
                                                  width, measure))
    # the dilated corridor at width + 2 (certify_adaptive's second sweep)
    lo_d, hi_d = tcorr.dilate(lo, hi, L, window)
    wide = dtw_band_adaptive_ref(A, B, lo_d, hi_d, window, width + 2,
                                 measure)
    assert torch.equal(
        dtw_band_adaptive(A, B, (lo_d, hi_d), width + 2, window, measure),
        wide)
    assert torch.equal(
        tcorr.certify_adaptive(A, B, lo, hi, window=window, width=width,
                               measure=measure), got == wide)


@pytest.mark.parametrize("measure", ["dtw", "wdtw:g=0.1"])
@pytest.mark.parametrize("L,window", [(74, 7), (512, 51), (200, None)])
def test_dtw_band_adaptive_static_corridor_equals_dtw_band(gen, measure, L,
                                                           window):
    n = 150
    A, B = _randn(gen, n, L), _randn(gen, n, L)
    lo, hi = tcorr.static_band(L, window, A.device)
    got = dtw_band_adaptive(A, B, (lo.expand(n, -1), hi.expand(n, -1)),
                            band_width(L, window), window, measure)
    assert torch.equal(got, dtw_band(A, B, window, measure))


def test_dtw_band_adaptive_rejects_other_measures(gen):
    A, B, lo, hi, width = _corridor(gen, 4, 64, 6)
    with pytest.raises(ValueError, match="dtw and wdtw only"):
        dtw_band_adaptive(A, B, (lo, hi), width, 6, "erp")


@pytest.mark.parametrize("L,window", [(64, 6), (512, 51)])
def test_lb_refine_adaptive_mixed_wave(gen, L, window):
    """A wave of refined, pruned and filler pairs: flags identical (no
    threshold near its bound), refined distances bit-identical."""
    n = 301
    A, B, clo, chi, width = _corridor(gen, n, L, window)
    up, lo = tlb.keogh_envelope(A, window)
    lb = tlb.cascade_bound(B, A, up, lo)
    th = torch.where(torch.arange(n, device="cuda") % 2 == 0, lb * 1.5 + 0.1,
                     lb * 0.5 - 0.1)
    th[3::7] = -float("inf")
    th[5::7] = float("inf")
    before = _build.LAUNCHES["lb_refine_adaptive"]
    d, f = lb_refine(A, B, up, lo, th, window, corridor=(clo, chi),
                     width=width)
    assert _build.LAUNCHES["lb_refine_adaptive"] == before + 1
    want_d, want_f = lb_refine_ref(A, B, up, lo, th, window,
                                   corridor=(clo, chi), width=width)
    assert torch.equal(f, want_f)
    assert 0 < int(f.sum()) < n
    assert torch.equal(d[f], want_d[f])
    torch.testing.assert_close(d[~f], want_d[~f], **TOL)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("M,K,na,nb", [(8, 256, 77, 301), (3, 16, 9, 5)])
def test_adc_quant_matches_plain(gen, dtype, M, K, na, nb):
    lut = _randn(gen, M, K, K).abs()
    q, scale, zero = quantize_lut(lut, dtype)
    ca = torch.randint(0, K, (na, M), device="cuda", dtype=torch.int32)
    cb = torch.randint(0, K, (nb, M), device="cuda", dtype=torch.int32)
    before = dict(_build.LAUNCHES)
    got = adc_sym_cdist_quant(ca, cb, q, scale, zero)
    assert torch.equal(got, adc_sym_cdist_quant_ref(ca, cb, q, scale, zero))
    qluts = _randn(gen, na, M, K).abs()
    qq, qs, qz = quantize_lut(qluts.reshape(na * M, K), dtype)
    qq, qs, qz = (x.reshape(na, M, -1) for x in (qq, qs, qz))
    got = adc_lookup_quant(cb, qq, qs, qz)
    assert got.shape == (na, nb)
    assert torch.equal(got, adc_lookup_quant_ref(cb, qq, qs, qz))
    single = adc_lookup_quant(cb, qq[0], qs[0], qz[0])
    assert torch.equal(single, got[0])
    for name, n in (("adc_sym_quant", 1), ("adc_lookup_quant", 2)):
        assert _build.LAUNCHES[name] == before[name] + n
