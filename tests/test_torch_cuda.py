"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside the fixture, never at import)
where there is no CUDA device.  On a machine with an H100 and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Distances within ``rtol=1e-5, atol=1e-4`` (ERP's prefix sums are
sequential in the kernel and a parallel scan in ``torch.cumsum``); codes
identical.  ``lb_refine`` sums its bound sequentially where ``torch.sum``
makes a tree, so its cases use thresholds that no bound comes near; then
the refined flags are identical too.  The adaptive corridor kernels
(``dtw_band_adaptive`` under every measure, ``lb_refine_adaptive``) are
bit-identical to their plain versions, and (dtw, wdtw) to ``dtw_band``
under the static-band corridor; the
ADC kernels equal theirs (float32, int8 and bfloat16).  The full-width
``dtw_band(mode="full")`` equals its plain version and ``dtw_band`` bit
for bit.  ``pq_attn`` is held against its plain version at ``rtol=atol=
2e-4`` (the reference's tolerance for its kernel; the online softmax
rescales in another order), and the PQ-KV decode attention's kernel route
against its plain route at the PQ-KV tolerance ``2e-2``.

The redesigned forms: ``lb_refine``'s warp-per-pair sweep (``w <= 255``)
and its thread-per-pair form beyond give refined distances equal to
``dtw_band``'s bit for bit, on waves that are all pruned, all refined,
mixed with filler pairs, and at bound ties (where a flag may flip only
within ``FLAG_TIE_REL`` of its threshold); ``pq_attn``'s split-K launch
gives the same bits on every launch, for one split and many, and leaves
its ticket counters at 0, also with launches in flight on two streams at
once; ``lb_refine_adaptive``'s warp form (width <= 256) equals its thread
form and ``dtw_band_adaptive`` bit for bit where they refine, and stays
finite on a corridor that breaks the invariants; ``dtw_band_cdist``'s
register form equals its shared-memory form bit for bit; the full-width
sweep's warp form (``L <= 1024``) equals its thread form, and
``prealign_encode``'s register form its shared-memory form, bit for bit,
the first index winning among duplicated centroids; ``dtw_band``'s
register form equals its shared-memory form bit for bit, on both sides of
every bucket's edge and when one grid walks the pairs several times; and
``dtw_band_adaptive``'s warp form (width <= 256) equals its thread form
and the plain version bit for bit under every measure, in built, dilated
and static corridors and in corridors along the table's edges (cells at
i = 0 and j = 0 deep into the sweep), and equals its thread form on
corridors that break the invariants; the symmetric ADC scan's
row-staged form equals its thread form and the plain version bit for bit
at every tile that fits, for float32, int8 and bfloat16 tables, and the
lookup's row-staged form its table form and the plain version likewise.
The earlier forms are reached through ``_build.lib()``.
"""

import pytest
import torch

from repro_torch.core import corridor as tcorr
from repro_torch.core import lb as tlb
from repro_torch.core import lb_search
from repro_torch.kernels import _build, tune
from repro_torch.kernels.dtw_band.ops import (adaptive_launch_name,
                                              band_width, dtw_band,
                                              dtw_band_adaptive,
                                              dtw_band_cdist)
from repro_torch.kernels.dtw_band.ref import (dtw_band_adaptive_ref,
                                              dtw_band_cdist_ref, dtw_band_ref)
from repro_torch.kernels.lb_cascade.ops import lb_refine, refine_variant
from repro_torch.kernels.lb_cascade.ref import lb_refine_ref
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_adc.ops import (adc_lookup, adc_lookup_quant,
                                           adc_sym_cdist,
                                           adc_sym_cdist_quant, quantize_lut)
from repro_torch.kernels.pq_adc.ref import (adc_lookup_quant_ref,
                                           adc_lookup_ref,
                                           adc_sym_cdist_quant_ref,
                                           adc_sym_cdist_ref)
from repro_torch.kernels.pq_attn import ops as pq_attn_ops
from repro_torch.kernels.pq_attn.ops import (pq_attn, pq_attn_decode,
                                             split_geometry)
from repro_torch.kernels.pq_attn.ref import (pq_attn_decode_ref,
                                             pq_attn_lut_ref)
from repro_torch.kernels.prealign_encode.ops import prealign_encode
from repro_torch.kernels.prealign_encode.ref import prealign_encode_ref

pytestmark = pytest.mark.cuda

MEASURES = ("dtw", "wdtw:g=0.1", "erp:g=0.3", "msm:c=0.5")
TOL = dict(rtol=1e-5, atol=1e-4)
FLAG_TIE_REL = 1e-5   # lb_refine: a flag may flip this near its threshold
PQ_ATTN_TOL = 2e-4


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
    assert torch.equal(adc_sym_cdist(ca, cb, lut),
                       adc_sym_cdist_ref(ca, cb, lut))
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
    name = adaptive_launch_name(0 if measure == "dtw" else 1)  # [wdtw]
    before = _build.LAUNCHES[name]
    got = dtw_band_adaptive(A, B, (lo, hi), width, window, measure)
    assert _build.LAUNCHES[name] == before + 1
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


@pytest.mark.parametrize("measure", ["erp:g=0.3", "msm:c=0.5"])
@pytest.mark.parametrize("cor", ["built", "static"])
@pytest.mark.parametrize("L,window,width", [(64, 6, None), (512, 51, 32)])
def test_dtw_band_adaptive_erp_msm_bit_equal(gen, measure, cor, L, window,
                                             width):
    """erp and msm on the card: the kernel equals dtw_band_adaptive_ref
    bit for bit, inside built corridors (width 32 at L=512, w=51) and
    inside the static band (its full width), counted under op[measure]."""
    n = 203
    if cor == "built":
        A, B, lo, hi, width = _corridor(gen, n, L, window, width)
    else:
        A = torch.cumsum(_randn(gen, n, L), 1)
        B = torch.cumsum(_randn(gen, n, L), 1)
        lo, hi = tcorr.static_band(L, window, A.device)
        lo, hi = lo.expand(n, -1), hi.expand(n, -1)
        width = band_width(L, window)
    name = "dtw_band_adaptive[" + measure[:3] + "]"
    before = dict(_build.LAUNCHES)
    got = dtw_band_adaptive(A, B, (lo, hi), width, window, measure)
    assert _build.LAUNCHES[name] == before[name] + 1
    assert _build.LAUNCHES["dtw_band_adaptive"] == before["dtw_band_adaptive"]
    want = dtw_band_adaptive_ref(A, B, lo, hi, window, width, measure)
    assert torch.equal(got, want)
    if cor == "static":   # the static band's sweep: within dtw_band's TOL
        torch.testing.assert_close(got, dtw_band(A, B, window, measure),
                                   **TOL)


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


def _sym_launch(ca, cb, table, scale, zero, out, ta=None):
    """The symmetric scan through the kernel library: the thread form
    (``ta=None``) or the row-staged form at ``ta`` queries a tile."""
    (Na, M), Nb, K = ca.shape, cb.shape[0], table.shape[1]
    lib, stream = _build.lib(), _build.stream(out.device)
    code = adc_ops.TABLE_TYPES[table.dtype]
    ptrs = (ca.data_ptr(), cb.data_ptr(), table.data_ptr())
    if ta is not None:
        geo = adc_ops.sym_geometry(Na, Nb, M, K, table.element_size(), ta=ta)
        status = lib.pq_adc_sym_rows(
            *ptrs, _build.ptr(scale), _build.ptr(zero), out.data_ptr(), Na,
            Nb, M, K, code, ta, geo.pitch, geo.chunk, geo.grid[1], stream)
    else:
        grid_y = adc_ops.sym_thread_geometry(Na, Nb, M,
                                             table.element_size()).grid[1]
        if scale is None:
            status = lib.pq_adc_sym(*ptrs, out.data_ptr(), Na, Nb, M, K,
                                    grid_y, stream)
        else:
            status = lib.pq_adc_sym_quant(
                *ptrs, scale.data_ptr(), zero.data_ptr(), out.data_ptr(), Na,
                Nb, M, K, code, grid_y, stream)
    _build.check(status, "adc_sym (a form)")
    return out


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("M,K,na,nb", [(8, 256, 77, 301), (3, 16, 9, 5),
                                       (16, 256, 33, 1000), (8, 256, 1, 6144),
                                       (8, 256, 768, 6144), (8, 0, 5, 70)])
def test_adc_sym_rows_form(gen, dtype, M, K, na, nb):
    """The symmetric scan's row-staged form (the wrapper's choice where a
    tile of rows fits) equals its thread form and the plain version bit
    for bit, at every tile that fits, for float32, int8 and bfloat16
    tables; K = 0 stands for rows of 4 KB (1024 f32 entries, 2048 bf16,
    4096 int8), which no tile holds, where the wrapper takes the thread
    form.  One launch counted a call."""
    itemsize = {"float32": 4, "int8": 1, "bfloat16": 2}[dtype]
    K = K or 4096 // itemsize
    lut = _randn(gen, M, K, K).abs()
    ca = torch.randint(0, K, (na, M), device="cuda", dtype=torch.int32)
    cb = torch.randint(0, K, (nb, M), device="cuda", dtype=torch.int32)
    name = "adc_sym" if dtype == "float32" else "adc_sym_quant"
    before = _build.LAUNCHES[name]
    if dtype == "float32":
        table, scale, zero = lut, None, None
        got = adc_sym_cdist(ca, cb, lut)
        want = adc_sym_cdist_ref(ca, cb, lut)
    else:
        table, scale, zero = quantize_lut(lut, dtype)
        got = adc_sym_cdist_quant(ca, cb, table, scale, zero)
        want = adc_sym_cdist_quant_ref(ca, cb, table, scale, zero)
        scale, zero = scale.reshape(M), zero.reshape(M)
    assert _build.LAUNCHES[name] == before + 1
    geo = adc_ops.sym_geometry(na, nb, M, K, itemsize)
    assert geo.form == ("thread" if K * itemsize == 4096 else "rows")
    assert torch.equal(got, want)
    out = torch.empty_like(got)
    assert torch.equal(_sym_launch(ca, cb, table, scale, zero, out), got)
    for ta in adc_ops.ROWS_TA:
        if adc_ops.rows_smem_bytes(ta, M, K, itemsize) > 227 * 1024:
            continue
        out.zero_()
        assert torch.equal(_sym_launch(ca, cb, table, scale, zero, out, ta),
                           got), f"{ta} queries a tile"
    assert _build.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("M,K", [(8, 256), (3, 16), (16, 256)])
def test_adc_sym_rows_smem_matches_the_selector(gen, M, K):
    """The kernel library's shared memory for the row-staged form is the
    selector's, for every table type and tile."""
    for dtype, code in adc_ops.TABLE_TYPES.items():
        size = torch.empty(0, dtype=dtype).element_size()
        for ta in adc_ops.ROWS_TA:
            pitch = adc_ops.row_pitch(K, size, ta)
            assert (_build.lib().pq_adc_sym_rows_smem_bytes(code, ta, M, pitch)
                    == adc_ops.rows_smem_bytes(ta, M, K, size))


@pytest.mark.parametrize("L,window", [(33, 3), (74, 7), (512, 51),
                                      (40, None)])
def test_dtw_band_full_matches_plain_and_compressed(gen, L, window):
    A, B = _randn(gen, 300, L), _randn(gen, 300, L)
    before = _build.LAUNCHES["dtw_band_full"]
    got = dtw_band(A, B, window, mode="full")
    assert _build.LAUNCHES["dtw_band_full"] == before + 1
    assert torch.equal(got, dtw_band_ref(A, B, window))
    assert torch.equal(got, dtw_band(A, B, window))
    from repro_torch.kernels.dtw_band.ref import dtw_band_full_ref
    assert torch.equal(got, dtw_band_full_ref(A, B, window))
    with pytest.raises(ValueError, match="DTW-only"):
        dtw_band(A, B, window, "wdtw", mode="full")


@pytest.mark.parametrize("table", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("codes_t", [torch.uint8, torch.int32])
@pytest.mark.parametrize("values", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,valid,G,R,M,K,Dv", [
    (2080, 1921, 8, 2, 8, 256, 128),      # the serving path's shape
    (300, 0, 2, 4, 4, 16, 32),            # empty prefix
    (300, 77, 2, 4, 4, 16, 32),           # a partial tile
    (256, 256, 1, 8, 8, 64, 64),          # full tiles, 8 heads per group
    (50, 50, 4, 1, 2, 32, 8),             # narrow values (32 lanes)
    (300, 77, 2, 4, 4, 16, 12)])          # Dv % 8 != 0: 4 values a load
def test_pq_attn_matches_plain(gen, table, codes_t, values, S, valid, G, R,
                               M, K, Dv):
    B = 3
    qlut = _randn(gen, B, G * R, M, K).to(table)
    codes = torch.randint(0, K, (B, S, G, M), generator=gen,
                          device="cuda").to(codes_t)
    v = _randn(gen, B, S, G, Dv).to(values)
    before = _build.LAUNCHES["pq_attn"]
    out, m, l = pq_attn(qlut, codes, v, valid, 0.125)
    assert _build.LAUNCHES["pq_attn"] == before + 1
    want = pq_attn_lut_ref(qlut, codes, v, valid, 0.125)
    for got, w in zip((out, m, l), want):
        torch.testing.assert_close(got, w, rtol=2e-4, atol=2e-4)


def test_pq_attn_decode_matches_reference_oracle(gen):
    """The reference signature (float32 table built from the query) against
    the dequantise-then-softmax oracle."""
    S, G, H, M, K, Ds = 1000, 4, 8, 8, 64, 16
    q = _randn(gen, H, M * Ds)
    books = _randn(gen, G, M, K, Ds)
    codes = torch.randint(0, K, (S, G, M), generator=gen, device="cuda",
                          dtype=torch.int32)
    v = _randn(gen, S, G, M * Ds)
    for valid in (None, 600):
        torch.testing.assert_close(
            pq_attn_decode(q, codes, books, v, valid_len=valid),
            pq_attn_decode_ref(q, codes, books, v, valid_len=valid),
            rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pos", [40, 127, 700])
def test_pq_attention_decode_kernel_route_matches_plain(gen, pos):
    from repro_torch.serve import pqkv
    B, S, G, R, hd, M, K, W = 4, 800, 4, 2, 64, 8, 32, 128
    k = _randn(gen, B, S, G, hd).to(torch.bfloat16)
    books = _randn(gen, G, M, K, hd // M)
    cache = pqkv.PQKVCache(
        k_codes=pqkv.encode_kv(k, books), k_books=books,
        v=_randn(gen, B, S, G, hd).to(torch.bfloat16),
        k_recent=_randn(gen, B, W, G, hd).to(torch.bfloat16),
        v_recent=_randn(gen, B, W, G, hd).to(torch.bfloat16))
    q = _randn(gen, B, G, R, hd).to(torch.bfloat16)
    pqc = pqkv.PQKVConfig(n_sub=M, codebook_size=K, recent_window=W)
    before = _build.LAUNCHES["pq_attn"]
    got = pqkv.pq_attention_decode(q, cache, pos, pqc=pqc)
    assert _build.LAUNCHES["pq_attn"] == before + 1
    want = pqkv.pq_attention_decode(q, cache, pos, pqc=pqc, route="plain")
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _wave_thresholds(lb, kind):
    """Thresholds for a wave of ``kind``: all pruned, all refined, mixed
    (with filler pairs at -inf and +inf), or exactly at the bound (ties)."""
    n = lb.shape[0]
    if kind == "pruned":
        return lb * 0.5 - 0.1
    if kind == "refined":
        return torch.full_like(lb, float("inf"))
    if kind == "ties":
        return lb.clone()
    th = torch.where(torch.arange(n, device=lb.device) % 2 == 0,
                     lb * 1.5 + 0.1, lb * 0.5 - 0.1)
    th[3::7] = -float("inf")
    th[5::7] = float("inf")
    return th


@pytest.mark.parametrize("w", [0, 7, 31, 32, 51, 63, 64, 255, 256])
@pytest.mark.parametrize("L", [300, "short"])
def test_lb_refine_refined_equal_dtw_band(gen, w, L):
    """Both forms of lb_refine: refined distances bit-identical to
    dtw_band's on the same pairs; flags equal the plain bound's (apart
    from ties within FLAG_TIE_REL); unrefined pairs return the bound."""
    L = max(2, w // 2 + 3) if L == "short" else L   # "short": L < w + 1
    eff = min(w, L - 1)
    n = 157
    A = torch.cumsum(_randn(gen, n, L), 1)
    B = torch.cumsum(_randn(gen, n, L), 1)
    up, lo = tlb.keogh_envelope(A, eff)
    lb = tlb.cascade_bound(B, A, up, lo)
    want_all = dtw_band(A, B, w)
    assert refine_variant(eff) == ("thread" if eff > 255 else "warp")
    for kind in ("pruned", "refined", "mixed", "ties"):
        th = _wave_thresholds(lb, kind)
        before = _build.LAUNCHES["lb_refine"]
        d, f = lb_refine(A, B, up, lo, th, w)
        assert _build.LAUNCHES["lb_refine"] == before + 1
        near = torch.isfinite(th) & (
            (lb - th).abs() <= FLAG_TIE_REL * th.abs())
        flips = f != (lb < th)
        assert not bool((flips & ~near).any()), kind
        if kind != "ties":
            assert not bool(flips.any()), kind
        assert not bool((f & (th == -float("inf"))).any())
        assert torch.equal(d[f], want_all[f]), kind
        keep = ~f & ~flips
        torch.testing.assert_close(d[keep], lb[keep], **TOL)
        if kind == "pruned":
            assert not bool(f.any())
        if kind == "refined":
            assert bool(f.all())
        if kind == "mixed":
            assert 0 < int(f.sum()) < n


def test_lb_refine_unstaged_long_series(gen):
    """Rows too long to stage in shared memory (warp_geometry gives 0
    bytes): the warp form reads them from device memory, clamping its
    indices, and still equals dtw_band bit for bit."""
    from repro_torch.kernels.lb_cascade.ops import warp_geometry
    n, L, w = 5, 30000, 7
    assert warp_geometry(n, L, w)[2] == 0
    A = torch.cumsum(_randn(gen, n, L), 1)
    B = torch.cumsum(_randn(gen, n, L), 1)
    up, lo = tlb.keogh_envelope(A, w)
    th = torch.full((n,), float("inf"), device="cuda")
    th[1] = -float("inf")
    d, f = lb_refine(A, B, up, lo, th, w)
    assert f.tolist() == [True, False, True, True, True]
    assert torch.equal(d[f], dtw_band(A, B, w)[f])


def _counter_key(device):
    return pq_attn_ops.counter_key(device,
                                   torch.cuda.current_stream(device).cuda_stream)


def _pq_inputs(gen, B, S, G=8, R=2, M=8, K=256, Dv=128):
    qlut = _randn(gen, B, G * R, M, K).to(torch.bfloat16)
    codes = torch.randint(0, K, (B, S, G, M), generator=gen,
                          device="cuda").to(torch.uint8)
    v = _randn(gen, B, S, G, Dv).to(torch.bfloat16)
    return qlut, codes, v


@pytest.mark.parametrize("which", ["0", "1", "chunk-1", "chunk", "chunk+1",
                                   "S"])
def test_pq_attn_split_valid_lengths(gen, which):
    """valid_len at and around one chunk, and the whole cache: one split
    and many, within PQ_ATTN_TOL of the plain version, the same bits on
    two launches, counters back at 0."""
    B, S, G = 3, 2080, 8
    chunk = split_geometry(S, B * G)[0]
    valid = {"0": 0, "1": 1, "chunk-1": chunk - 1, "chunk": chunk,
             "chunk+1": chunk + 1, "S": S}[which]
    qlut, codes, v = _pq_inputs(gen, B, S, G)
    first = pq_attn(qlut, codes, v, valid, 0.125)
    again = pq_attn(qlut, codes, v, valid, 0.125)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    want = pq_attn_lut_ref(qlut, codes, v, valid, 0.125)
    for got, w in zip(first, want):
        torch.testing.assert_close(got, w, rtol=PQ_ATTN_TOL,
                                   atol=PQ_ATTN_TOL)
    counters = pq_attn_ops._COUNTERS.get(_counter_key(qlut.device))
    if counters is not None:
        assert int(counters.abs().sum()) == 0


def test_pq_attn_split_counts_cover_one_and_many():
    B, S, G = 3, 2080, 8
    chunk = split_geometry(S, B * G)[0]
    n_splits = {split_geometry(n, B * G)[1]
                for n in (0, 1, chunk - 1, chunk, chunk + 1, S)}
    assert 1 in n_splits and max(n_splits) > 1


def test_pq_attn_counters_reset_and_grow(gen):
    """Two calls in a row with different B*G: the counters grow to the
    larger, every launch leaves them at 0, and a call repeated after the
    other gives its first bits again."""
    small = _pq_inputs(gen, 2, 1500)
    large = _pq_inputs(gen, 8, 1500)
    a = pq_attn(*small, 1400, 0.1)
    key = _counter_key(small[0].device)
    n_small = pq_attn_ops._COUNTERS[key].numel()
    b = pq_attn(*large, 1400, 0.1)
    counters = pq_attn_ops._COUNTERS[key]
    assert counters.numel() >= 8 * 8 and counters.numel() >= n_small
    assert int(counters.abs().sum()) == 0
    a2 = pq_attn(*small, 1400, 0.1)
    for x, y in zip(a, a2):
        assert torch.equal(x, y)
    for got, w in zip(b, pq_attn_lut_ref(*large, 1400, 0.1)):
        torch.testing.assert_close(got, w, rtol=PQ_ATTN_TOL,
                                   atol=PQ_ATTN_TOL)


def test_pq_attn_values_aligned_to_8_bytes(gen):
    """bf16 values whose storage is 8- but not 16-byte aligned take the
    4-values-a-load form and give what the 8-a-load form gives."""
    qlut, codes, v = _pq_inputs(gen, 2, 300)
    buf = torch.empty(v.numel() + 4, dtype=v.dtype, device="cuda")
    shifted = buf[4:].view(v.shape)
    shifted.copy_(v)
    assert pq_attn_ops.value_vector(shifted) == 4
    assert pq_attn_ops.value_vector(v) == 8
    got = pq_attn(qlut, codes, shifted, 250, 0.1)
    want = pq_attn_lut_ref(qlut, codes, v, 250, 0.1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=PQ_ATTN_TOL, atol=PQ_ATTN_TOL)


def _adaptive_thread_form(A, B, up, lo, th, clo, chi, width):
    """lb_refine_adaptive's thread-per-pair form (the wrapper's choice
    beyond width 256) launched directly, at any width."""
    from repro_torch.kernels.dtw_band.ops import row_geometry
    n, L = A.shape
    threads, blocks, scratch = row_geometry(n, 3 * width, A.device)
    d = torch.empty(n, dtype=torch.float32, device=A.device)
    f = torch.empty(n, dtype=torch.int32, device=A.device)
    args = [t.contiguous() for t in (A, B, up, lo, th)]
    args += [c.to(torch.int32).contiguous() for c in (clo, chi)]
    _build.check(_build.lib().pq_lb_refine_adaptive(
        *(t.data_ptr() for t in args), d.data_ptr(), f.data_ptr(),
        _build.ptr(scratch), n, L, width, threads, blocks,
        _build.stream(A.device)), "lb_refine_adaptive (thread form)")
    return d, f.bool()


@pytest.mark.parametrize("L,window,width", [
    (64, 6, 8), (512, 51, 32), (300, 80, 64), (300, 120, 100),
    (300, None, 257)])
def test_lb_refine_adaptive_forms_agree(gen, L, window, width):
    """Row 8's warp form (C = 1, 2, 4; width 257 takes the thread form)
    against its clamped sweep, the thread form and dtw_band_adaptive on
    all-pruned, all-refined and mixed waves with filler pairs: flags equal
    the plain bound's (no threshold near it), refined distances bit for
    bit."""
    from repro_torch.kernels.lb_cascade.ops import adaptive_variant
    n = 157
    A, B, clo, chi, width = _corridor(gen, n, L, window, width)
    eff = L - 1 if window is None else window
    up, lo = tlb.keogh_envelope(A, eff)
    lb = tlb.cascade_bound(B, A, up, lo)
    sweep = dtw_band_adaptive(A, B, (clo, chi), width, window)
    assert adaptive_variant(width) == ("warp" if width <= 256 else "thread")
    for kind in ("pruned", "refined", "mixed"):
        th = _wave_thresholds(lb, kind)
        before = _build.LAUNCHES["lb_refine_adaptive"]
        d, f = lb_refine(A, B, up, lo, th, window, corridor=(clo, chi),
                         width=width)
        assert _build.LAUNCHES["lb_refine_adaptive"] == before + 1
        assert torch.equal(f, lb < th), kind
        assert torch.equal(d[f], sweep[f]), kind
        torch.testing.assert_close(d[~f], lb[~f], **TOL)
        td, tf = _adaptive_thread_form(A, B, up, lo, th, clo, chi, width)
        assert torch.equal(tf, f) and torch.equal(td[f], d[f]), kind
        if width <= 256:
            cd, cf = _adaptive_warp_form(A, B, up, lo, th, clo, chi, width,
                                         0)
            assert torch.equal(cf, f) and torch.equal(cd, d), kind
        if kind == "pruned":
            assert not bool(f.any())
        if kind == "refined":
            assert bool(f.all())
        if kind == "mixed":
            assert 0 < int(f.sum()) < n
            assert not bool((f & (th == -float("inf"))).any())


@pytest.mark.parametrize("width", [32, 100])
def test_lb_refine_adaptive_broken_corridor(gen, width):
    """A corridor that breaks the invariants (random lo, hi): a wrong cost
    but a finite one, and no fault, in the warp form and row 7."""
    n, L = 64, 128
    A = torch.cumsum(_randn(gen, n, L), 1)
    B = torch.cumsum(_randn(gen, n, L), 1)
    clo = torch.randint(-40, L + 40, (n, 2 * L - 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    chi = clo + torch.randint(-5, 60, (n, 2 * L - 1), generator=gen,
                              device="cuda", dtype=torch.int32)
    up, lo = tlb.keogh_envelope(A, 12)
    th = torch.full((n,), float("inf"), device="cuda")
    d, f = lb_refine(A, B, up, lo, th, 12, corridor=(clo, chi), width=width)
    sweep = dtw_band_adaptive(A, B, (clo, chi), width, 12)
    torch.cuda.synchronize()
    assert bool(f.all())
    assert bool(torch.isfinite(d).all()) and bool(torch.isfinite(sweep).all())
    assert torch.equal(d, sweep)


def _adaptive_warp_form(A, B, up, lo, th, clo, chi, width, padded):
    """lb_refine_adaptive's warp form launched directly: padded = 1 is the
    wrapper's (padded rows, clamped sweep for broken corridors), 0 the
    clamped sweep for every pair."""
    from repro_torch.kernels.lb_cascade.ops import corridor_warp_geometry
    n, L = A.shape
    d = torch.empty(n, dtype=torch.float32, device=A.device)
    f = torch.empty(n, dtype=torch.int32, device=A.device)
    args = [t.contiguous() for t in (A, B, up, lo, th)]
    args += [c.to(torch.int32).contiguous() for c in (clo, chi)]
    _build.check(_build.lib().pq_lb_refine_adaptive_warp(
        *(t.data_ptr() for t in args), d.data_ptr(), f.data_ptr(), n, L,
        width, *corridor_warp_geometry(n, L, width), padded,
        _build.stream(A.device)), "lb_refine_adaptive (warp form)")
    return d, f.bool()


@pytest.mark.parametrize("L,window,width", [(64, 6, 8), (512, 51, 32),
                                            (300, 80, 64), (300, 120, 100)])
def test_lb_refine_adaptive_padded_fallback(gen, L, window, width):
    """Row 8's padded sweep and its per-pair fallback: every other pair's
    corridor broken at one diagonal (in the first, second or a late block
    of 32, by a live cell off the table, a drift of 2 or a negative base),
    the rest as built.  The wrapper's output equals the clamped warp
    sweep's and the thread form's bit for bit on every pair, and
    dtw_band_adaptive's."""
    n = 96
    A, B, clo, chi, width = _corridor(gen, n, L, window, width)
    clo, chi = clo.clone(), chi.clone()
    D = 2 * L - 1
    for q in range(1, n, 2):
        d = (0, 5, 31, 32, 40, D - 2)[q // 2 % 6]
        how, cap = q // 2 % 3, min(d, L - 1)
        if how == 0:  # a live cell off the table
            chi[q, d] = cap + 1
            clo[q, d] = max(cap + 2 - width, 0)
        elif how == 1:
            clo[q, d:] += 2  # a drift of 2, then off the table
        else:
            clo[q, d] = -1
    up, lo = tlb.keogh_envelope(A, window)
    th = torch.full((n,), float("inf"), device="cuda")
    d, f = lb_refine(A, B, up, lo, th, window, corridor=(clo, chi),
                     width=width)
    cd, cf = _adaptive_warp_form(A, B, up, lo, th, clo, chi, width, 0)
    td, tf = _adaptive_thread_form(A, B, up, lo, th, clo, chi, width)
    sweep = dtw_band_adaptive(A, B, (clo, chi), width, window)
    assert bool(f.all()) and torch.equal(cf, f) and torch.equal(tf, f)
    assert torch.equal(d, cd) and torch.equal(d, td) and torch.equal(d, sweep)
    assert bool(torch.isfinite(d[0::2]).all())


def _cdist_shared_form(A, B, w, kid, param, wt):
    """dtw_band_cdist's shared-memory form (the wrapper's choice where no
    register bucket holds the band) launched directly, at any band."""
    from repro_torch.kernels.dtw_band.ops import band_geometry
    (N, L), M = A.shape, B.shape[0]
    out = torch.empty((N, M), dtype=torch.float32, device=A.device)
    threads, blocks, scratch = band_geometry(N * M, w, A.device)
    _build.check(_build.lib().pq_dtw_band_cdist(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), _build.ptr(wt),
        _build.ptr(scratch), N, M, L, w, kid, param, threads, blocks,
        _build.stream(A.device)), "dtw_band_cdist (shared-memory form)")
    return out


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("L,window", [(74, 0), (74, 7), (74, "largest"),
                                      (74, "past"), (200, 3)])
def test_dtw_band_cdist_register_form(gen, measure, L, window):
    """Row 2's register form against the shared-memory form (bit for bit)
    and the plain version (TOL), at w = 0, at the largest bucket's band
    (128 slots for dtw, 32 for the others), and one past it (where the
    wrapper takes the shared-memory form)."""
    from repro_torch.core import measures as tmeas
    from repro_torch.kernels.dtw_band.ops import (DTW_REG_BUCKETS,
                                                  REG_BUCKETS, cdist_bucket)
    kid = tmeas.kernel_measure_id(tmeas.resolve(measure))
    top = (max(DTW_REG_BUCKETS if kid == 0 else REG_BUCKETS) - 2) // 2
    w = {"largest": top, "past": top + 1}.get(window, window)
    bucket = cdist_bucket(w, kid, L)
    assert (bucket is None) == (window == "past")
    spec = tmeas.resolve(measure)
    wt = tmeas.wdtw_weights(spec, L, "cuda") if spec.uses_position else None
    # threads over A's rows, and (swapped) over B's: the same bits
    for na, nb in ((300, 70), (20, 300)):
        A, B = _randn(gen, na, L), _randn(gen, nb, L)
        before = _build.LAUNCHES["dtw_band_cdist"]
        got = dtw_band_cdist(A, B, w, measure)
        assert _build.LAUNCHES["dtw_band_cdist"] == before + 1
        old = _cdist_shared_form(A, B, w, kid, tmeas.kernel_param(spec), wt)
        assert torch.equal(got, old)
        torch.testing.assert_close(got, dtw_band_cdist_ref(A, B, w, measure),
                                   **TOL)


def test_pq_attn_two_streams(gen):
    """Two launches with different inputs in flight on two streams: each
    equals its single-stream result bit for bit, and every counter ends at
    0 (each stream draws its own tickets)."""
    one = _pq_inputs(gen, 8, 2080)
    two = _pq_inputs(gen, 8, 2080)
    want = [pq_attn(*x, 1921, 0.1) for x in (one, two)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = []
    for _ in range(10):
        outs = []
        for x, st in zip((one, two), streams):
            with torch.cuda.stream(st):
                outs.append(pq_attn(*x, 1921, 0.1))
        got.append(outs)
    torch.cuda.synchronize()
    for outs in got:
        for out, w in zip(outs, want):
            for a, b in zip(out, w):
                assert torch.equal(a, b)
    keys = [_counter_key(one[0].device)] + [
        pq_attn_ops.counter_key(one[0].device, st.cuda_stream)
        for st in streams]
    assert len(set(keys)) == 3
    for key in keys:
        assert int(pq_attn_ops._COUNTERS[key].abs().sum()) == 0


class _Spy:
    """Stands in for the kernel library: records each entry's arguments
    and runs it."""

    def __init__(self, lib):
        self.lib = lib
        self.called = []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def entry(*args):
            self.called.append((name, args))
            return fn(*args)
        return entry


def _full_thread_form(A, B, w):
    """Row 12's thread form (the wrapper's choice beyond L = 1024)
    launched directly, at any length."""
    from repro_torch.kernels.dtw_band.ops import row_geometry
    n, L = A.shape
    out = torch.empty(n, dtype=torch.float32, device=A.device)
    threads, blocks, scratch = row_geometry(n, 2 * L, A.device)
    _build.check(_build.lib().pq_dtw_band_full(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), _build.ptr(scratch), n,
        L, w, 0, threads, blocks, _build.stream(A.device)),
        "dtw_band_full (thread form)")
    return out


@pytest.mark.parametrize("L", [1, 7, 31, 32, 33, 74, 512, 1024, 1025])
@pytest.mark.parametrize("window", [0, 1, 51, "L-1", None])
def test_dtw_band_full_warp_form(gen, monkeypatch, L, window):
    """Row 12's warp form (one warp a pair, C = ceil(L / 32) rows a lane
    in a bucket up to 32) equals the thread form, the plain version and
    dtw_band bit for bit; beyond L = 1024 the wrapper takes the thread
    form.  37 pairs: the last block of 4 warps is ragged."""
    from repro_torch.core.dispatch import effective_window
    from repro_torch.kernels.dtw_band.ops import full_warp_geometry
    from repro_torch.kernels.dtw_band.ref import dtw_band_full_ref
    w = L - 1 if window == "L-1" else window
    A, B = _randn(gen, 37, L), _randn(gen, 37, L)
    spy = _Spy(_build.lib())
    monkeypatch.setattr(_build, "lib", lambda: spy)
    before = _build.LAUNCHES["dtw_band_full"]
    got = dtw_band(A, B, w, mode="full")
    assert _build.LAUNCHES["dtw_band_full"] == before + 1
    (name, args), = spy.called
    geo = full_warp_geometry(37, L)
    assert name == "pq_dtw_band_full"
    assert args[7] == (0 if geo is None else geo[0])
    assert (geo is None) == (L > 1024)
    thread = _full_thread_form(A, B, effective_window(L, w))
    assert torch.equal(got, thread)
    assert torch.equal(got, dtw_band_full_ref(A, B, w))
    assert torch.equal(got, dtw_band(A, B, w))


def _prealign_shared_form(X, cents, level, tail, w, measure):
    """Row 5's shared-memory form (the wrapper's choice where no register
    bucket holds the band) launched directly, at any band."""
    from repro_torch.core import measures as tmeas
    from repro_torch.core.modwt import linspace01
    from repro_torch.kernels.prealign_encode.ops import block_geometry
    spec = tmeas.resolve(measure)
    X, cents = X.contiguous(), cents.contiguous()
    (N, D), (M, K, S) = X.shape, cents.shape
    wt = tmeas.wdtw_weights(spec, S, "cuda") if spec.uses_position else None
    lin = linspace01(S, X.device)
    codes = torch.empty((N, M), dtype=torch.int32, device="cuda")
    _build.check(_build.lib().pq_prealign_encode(
        X.data_ptr(), cents.data_ptr(), lin.data_ptr(), _build.ptr(wt),
        codes.data_ptr(), N, D, M, K, S, level, tail, w,
        tmeas.kernel_measure_id(spec), float(tmeas.kernel_param(spec)), 0,
        block_geometry(D, M, S, w), _build.stream(X.device)),
        "prealign_encode (shared-memory form)")
    return codes


@pytest.mark.parametrize("K", [48, 300])
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("w", [0, 3, 4, 7, 8, 15, 16, 31, 32, 63, 64])
def test_prealign_encode_register_form(gen, monkeypatch, measure, w, K):
    """Row 5's register form against the shared-memory form and the plain
    version, bit for bit, on both sides of every bucket boundary (8, 16,
    32; 64 and 128 for dtw), where the wrapper takes the register form
    exactly where cdist_bucket gives a bucket.  K = 48 centroids (two
    warps, the second half idle) or K = 300 (a block of 256 threads, the
    first 44 sweeping a second centroid k + 256), with duplicates across
    the warps and across the stride: the nearest centroid of series 0 in
    every subspace is its own segment, planted at k = 5 and k = 37 (and
    k = 261, thread 5's second centroid), so its code must be 5; that of
    series 1 is planted at k = 270 and k = 299 only (two warps' second
    sweeps), so its code must be 270; k = 2 equals k = 33 everywhere."""
    from repro_torch.core import measures as tmeas
    from repro_torch.core.modwt import prealign
    from repro_torch.kernels.dtw_band.ops import cdist_bucket
    from repro_torch.kernels.prealign_encode.ops import encode_geometry
    D, M, level, tail = 512, 4, 3, 2
    S = D // M + tail
    X = torch.cumsum(_randn(gen, 40, D), dim=1)
    cents = _randn(gen, M, K, S) * 4
    segs = prealign(X[:2], M, level, tail)               # (2, M, S)
    cents[:, 5] = cents[:, 37] = segs[0]
    if K == 300:
        cents[:, 261] = segs[0]
        cents[:, 270] = cents[:, 299] = segs[1]
    cents[:, 33] = cents[:, 2]
    kid = tmeas.kernel_measure_id(tmeas.resolve(measure))
    bucket = cdist_bucket(w, kid, S)
    spy = _Spy(_build.lib())
    monkeypatch.setattr(_build, "lib", lambda: spy)
    before = _build.LAUNCHES["prealign_encode"]
    got = prealign_encode(X, cents, level, tail, w, measure)
    assert _build.LAUNCHES["prealign_encode"] == before + 1
    (name, args), = spy.called
    assert args[15:17] == encode_geometry(D, M, K, S, w, kid)
    assert args[15] == (bucket or 0)
    assert bool((got[0] == 5).all())
    if K == 300:
        assert bool((got[1] == 270).all())
    old = _prealign_shared_form(X, cents, level, tail, w, measure)
    assert torch.equal(got, old)
    assert torch.equal(got, prealign_encode_ref(X, cents, level, tail, w,
                                                measure))


def _adaptive_thread_sweep(A, B, lo, hi, width, measure):
    """Row 7's thread form (the wrapper's choice beyond width 256, and its
    design before the warp form) launched directly, at any width; erp's
    border sums in a scratch buffer."""
    from repro_torch.core import measures as tmeas
    from repro_torch.kernels.dtw_band.ops import row_geometry
    spec = tmeas.resolve(measure)
    n, L = A.shape
    kid = tmeas.kernel_measure_id(spec)
    wt = tmeas.wdtw_weights(spec, L, "cuda") if spec.uses_position else None
    threads, blocks, scratch = row_geometry(n, 3 * width, A.device)
    gaps = (torch.empty(2 * L * threads * blocks, device=A.device)
            if kid == 2 else None)
    out = torch.empty(n, dtype=torch.float32, device=A.device)
    _build.check(_build.lib().pq_dtw_band_adaptive(
        A.data_ptr(), B.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        out.data_ptr(), _build.ptr(wt), _build.ptr(scratch),
        _build.ptr(gaps), n, L, width, kid,
        float(tmeas.kernel_param(spec)), threads, blocks, 0,
        _build.stream(A.device)), "dtw_band_adaptive (thread form)")
    return out


def _edge_corridor(kind, n, L, width):
    """A valid corridor along the table's edges: ``j0`` down column 0 to
    row L-1, then along it (live cells at j = 0 on diagonals with lo > 0);
    ``i0`` along row 0, then down column L-1."""
    d = torch.arange(2 * L - 1, device="cuda")
    if kind == "edge_j0":
        lo = torch.clamp(d - width + 1, 0, L - 1)
        hi = torch.clamp(d, max=L - 1)
    else:
        lo = torch.clamp(d - L + 1, min=0)
        hi = torch.minimum(lo + width - 1, torch.clamp(d, max=L - 1))
    return (lo.to(torch.int32).expand(n, -1).contiguous(),
            hi.to(torch.int32).expand(n, -1).contiguous())


def _break_corridors(clo, chi, width):
    """Every other pair's corridor broken at one diagonal, in the first,
    second or last block of 32 diagonals: a live cell off the table, a
    drift of 2, or a negative base."""
    clo, chi = clo.clone(), chi.clone()
    n, D = clo.shape
    L = (D + 1) // 2
    for q in range(1, n, 2):
        d = (0, 5, 31, 32, 40, D - 2)[q // 2 % 6]
        how, cap = q // 2 % 3, min(d, L - 1)
        if how == 0:
            chi[q, d] = cap + 1
            clo[q, d] = max(cap + 2 - width, 0)
        elif how == 1:
            clo[q, d:] += 2
        else:
            clo[q, d] = -1
    return clo, chi


@pytest.mark.parametrize("kind", ["built", "dilated", "static", "edge_j0",
                                  "edge_i0", "broken"])
@pytest.mark.parametrize("L,window,width", [
    (64, 6, 8), (65, 12, 32), (96, 20, 34), (129, 40, 64),
    (300, 140, 256)])
@pytest.mark.parametrize("measure", MEASURES)
def test_dtw_band_adaptive_warp_form(gen, monkeypatch, measure, L, window,
                                     width, kind):
    """Row 7's warp form (one warp a pair, C = 1, 2, 4 or 8 slots a lane)
    against its thread form and the plain version, bit for bit, for every
    measure: widths 8, 32, 34 (certify's W + 2), 64 and 256, L odd and
    even, 37 pairs (the last block of 4 warps ragged).  Built corridors,
    dilated ones (width + 2), the static band, corridors along the edges
    (erp's and msm's border cells at i = 0 and j = 0), and corridors broken
    in the first, a middle and the last block of diagonals (the padded
    sweep falls back to the clamped one: equal to the thread form, and
    finite where unbroken)."""
    from repro_torch.core import measures as tmeas
    from repro_torch.kernels.dtw_band.ops import adaptive_warp_geometry
    n = 37
    A, B, lo, hi, width = _corridor(gen, n, L, window, width)
    if kind == "dilated":
        lo, hi = tcorr.dilate(lo, hi, L, window)
        width += 2
    elif kind == "static":
        lo, hi = tcorr.static_band(L, window, A.device)
        lo, hi = lo.expand(n, -1), hi.expand(n, -1)
        width = band_width(L, window)
    elif kind in ("edge_j0", "edge_i0"):
        lo, hi = _edge_corridor(kind, n, L, width)
        window = None
    elif kind == "broken":
        lo, hi = _break_corridors(lo, hi, width)
    lo, hi = lo.to(torch.int32).contiguous(), hi.to(torch.int32).contiguous()
    kid = tmeas.kernel_measure_id(tmeas.resolve(measure))
    spy = _Spy(_build.lib())
    monkeypatch.setattr(_build, "lib", lambda: spy)
    name = adaptive_launch_name(kid)
    before = _build.LAUNCHES[name]
    got = dtw_band_adaptive(A, B, (lo, hi), width, window, measure)
    assert _build.LAUNCHES[name] == before + 1
    (entry, args), = spy.called
    assert entry == "pq_dtw_band_adaptive"
    geo = adaptive_warp_geometry(n, L, width, kid)
    assert (geo is None) == (width > 256)   # dilated 256: the thread form
    if geo is not None:   # (warps, blocks); no threads, scratch or gaps
        assert (args[15], args[14]) == geo and args[13] == 0
        assert args[6] is None and args[7] is None
    thread = _adaptive_thread_sweep(A, B, lo, hi, width, measure)
    assert torch.equal(got, thread)
    if kind == "broken":
        assert bool(torch.isfinite(got[0::2]).all())
    else:
        assert torch.equal(got, dtw_band_adaptive_ref(A, B, lo, hi, window,
                                                      width, measure))


def _pairs_shared_form(A, B, w, measure):
    """Row 1's shared-memory form (the wrapper's choice where no register
    bucket holds the band) launched directly, at any band."""
    from repro_torch.core import measures as tmeas
    from repro_torch.kernels.dtw_band.ops import band_geometry
    spec = tmeas.resolve(measure)
    n, L = A.shape
    wt = tmeas.wdtw_weights(spec, L, "cuda") if spec.uses_position else None
    threads, blocks, scratch = band_geometry(n, w, A.device)
    out = torch.empty(n, dtype=torch.float32, device=A.device)
    _build.check(_build.lib().pq_dtw_band(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), _build.ptr(wt),
        _build.ptr(scratch), n, L, w, tmeas.kernel_measure_id(spec),
        float(tmeas.kernel_param(spec)), 0, threads, blocks,
        _build.stream(A.device)), "dtw_band (shared-memory form)")
    return out


@pytest.mark.parametrize("L", [74, 75])
@pytest.mark.parametrize("w", [0, 7, 8, 15, 16, 31, 32, 63, 64])
@pytest.mark.parametrize("measure", MEASURES)
def test_dtw_band_register_form(gen, monkeypatch, measure, w, L):
    """Row 1's register form against the shared-memory form (bit for bit)
    and the plain version (TOL), on both sides of each bucket's edge (w =
    7/8 and 15/16 for every measure, 31/32 and 63/64 for dtw), where the
    wrapper takes the register form exactly where cdist_bucket gives a
    bucket; 300 pairs, so the last warp's group of 32 is ragged."""
    from repro_torch.core import measures as tmeas
    from repro_torch.kernels.dtw_band.ops import (cdist_bucket,
                                                  pairs_reg_geometry)
    n = 300
    A, B = _randn(gen, n, L), _randn(gen, n, L)
    kid = tmeas.kernel_measure_id(tmeas.resolve(measure))
    spy = _Spy(_build.lib())
    monkeypatch.setattr(_build, "lib", lambda: spy)
    before = _build.LAUNCHES["dtw_band"]
    got = dtw_band(A, B, w, measure)
    assert _build.LAUNCHES["dtw_band"] == before + 1
    (entry, args), = spy.called
    geo = pairs_reg_geometry(n, L, w, kid)
    assert (geo is None) == (cdist_bucket(w, kid, L) is None)
    if geo is not None:
        assert args[10:13] == (geo[0], 32 * geo[1], geo[2])
    else:
        assert args[10] == 0
    assert torch.equal(got, _pairs_shared_form(A, B, w, measure))
    torch.testing.assert_close(got, dtw_band_ref(A, B, w, measure), **TOL)


@pytest.mark.parametrize("measure", MEASURES)
def test_dtw_band_register_form_grid_stride(gen, measure):
    """Row 1's register form with a grid of one and of three blocks: each
    warp walks several groups of 32 pairs (n above one grid's reach), and
    the last group is ragged; the same bits as the shared-memory form."""
    from repro_torch.core import measures as tmeas
    from repro_torch.kernels.dtw_band.ops import pairs_reg_geometry
    n, L, w = 1000, 74, 7
    A, B = _randn(gen, n, L), _randn(gen, n, L)
    spec = tmeas.resolve(measure)
    kid = tmeas.kernel_measure_id(spec)
    wt = tmeas.wdtw_weights(spec, L, "cuda") if spec.uses_position else None
    bucket, warps, blocks = pairs_reg_geometry(n, L, w, kid)
    assert blocks > 3
    old = _pairs_shared_form(A, B, w, measure)
    for grid in (1, 3):
        out = torch.full((n,), float("nan"), device="cuda")
        _build.check(_build.lib().pq_dtw_band(
            A.data_ptr(), B.data_ptr(), out.data_ptr(), _build.ptr(wt), None,
            n, L, w, kid, float(tmeas.kernel_param(spec)), bucket,
            32 * warps, grid, _build.stream(A.device)), "dtw_band")
        assert torch.equal(out, old), grid


def _lookup_launch(codes, table, scale, zero, out, ta=None):
    """The lookup through the kernel library: the table form (``ta=None``)
    or the row-staged form at ``ta`` queries a tile."""
    (Nq, M, K), N = table.shape, codes.shape[0]
    lib, stream = _build.lib(), _build.stream(out.device)
    size, code = table.element_size(), adc_ops.TABLE_TYPES[table.dtype]
    if ta is not None:
        geo = adc_ops.lookup_geometry(Nq, N, M, K, size, ta=ta)
        status = lib.pq_adc_lookup_rows(
            table.data_ptr(), _build.ptr(scale), _build.ptr(zero),
            codes.data_ptr(), out.data_ptr(), Nq, N, M, K, code, ta,
            geo.pitch, geo.chunk, geo.grid[1], stream)
    else:
        geo = adc_ops.lookup_table_geometry(Nq, N, M, K, size)
        if scale is None:
            status = lib.pq_adc_lookup(table.data_ptr(), codes.data_ptr(),
                                       out.data_ptr(), Nq, N, M, K,
                                       geo.chunk, *geo.grid, stream)
        else:
            status = lib.pq_adc_lookup_quant(
                table.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                codes.data_ptr(), out.data_ptr(), Nq, N, M, K, code,
                geo.chunk, *geo.grid, stream)
    _build.check(status, "adc_lookup (a form)")
    return out


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("M,K,nq,n", [(8, 256, 77, 301), (8, 256, 301, 77),
                                      (3, 16, 259, 5), (16, 256, 263, 1000),
                                      (8, 256, 1, 6144), (8, 256, 768, 6144),
                                      (8, 6, 300, 70), (8, 0, 260, 70)])
def test_adc_lookup_rows_form(gen, dtype, M, K, nq, n):
    """The lookup's row-staged form (the wrapper's choice from
    LOOKUP_ROWS_MIN_NQ queries on where a tile of rows fits) equals its
    table form and the plain version bit for bit, at every tile that fits,
    for float32, int8 and bfloat16 tables; K = 6 gives int8 rows that are
    not whole 4-byte words and K = 0 stands for rows of 4 KB, which no
    tile holds: the table form.  One launch counted a call."""
    itemsize = {"float32": 4, "int8": 1, "bfloat16": 2}[dtype]
    K = K or 4096 // itemsize
    qlut = _randn(gen, nq, M, K).abs()
    codes = torch.randint(0, K, (n, M), device="cuda", dtype=torch.int32)
    name = "adc_lookup" if dtype == "float32" else "adc_lookup_quant"
    before = _build.LAUNCHES[name]
    if dtype == "float32":
        table, scale, zero = qlut, None, None
        got = adc_lookup(codes, qlut)
        want = adc_lookup_ref(codes, qlut)
    else:
        table, scale, zero = quantize_lut(qlut.reshape(nq * M, K), dtype)
        table = table.reshape(nq, M, K)
        scale, zero = scale.reshape(nq, M, 1), zero.reshape(nq, M, 1)
        got = adc_lookup_quant(codes, table, scale, zero)
        want = adc_lookup_quant_ref(codes, table, scale, zero)
        scale, zero = scale.reshape(-1), zero.reshape(-1)
    assert _build.LAUNCHES[name] == before + 1
    fits = [ta for ta in adc_ops.ROWS_TA
            if (K * itemsize) % 4 == 0
            and adc_ops.rows_smem_bytes(ta, M, K, itemsize, True)
            <= 227 * 1024]
    geo = adc_ops.lookup_geometry(nq, n, M, K, itemsize)
    assert geo.form == ("rows" if fits
                        and nq >= adc_ops.LOOKUP_ROWS_MIN_NQ[itemsize]
                        else "table")
    assert torch.equal(got, want)
    out = torch.empty_like(got)
    assert torch.equal(_lookup_launch(codes, table, scale, zero, out), got)
    for ta in fits:
        out.zero_()
        assert torch.equal(_lookup_launch(codes, table, scale, zero, out, ta),
                           got), f"{ta} queries a tile"
    assert _build.LAUNCHES[name] == before + 1


@pytest.mark.parametrize("M,K", [(8, 256), (3, 16), (16, 256)])
def test_adc_lookup_rows_smem_matches_the_selector(gen, M, K):
    """The kernel library's shared memory for the row-staged lookup is the
    selector's, for every table type and tile (a quantised table's affine
    a query and subspace)."""
    for dtype, code in adc_ops.TABLE_TYPES.items():
        size = torch.empty(0, dtype=dtype).element_size()
        for ta in adc_ops.ROWS_TA:
            pitch = adc_ops.row_pitch(K, size, ta)
            assert (_build.lib().pq_adc_lookup_rows_smem_bytes(
                code, ta, M, pitch)
                == adc_ops.rows_smem_bytes(ta, M, K, size, lookup=True))


# ---------------------------------------------------------------------------
# The Table 1 leg's paths on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,w,form", [(192, 191, "shared"),
                                      (193, 192, "scratch"),
                                      (96, 95, "shared"),
                                      (192, 19, "registers")])
def test_cdtw_cdist_forms_bit_equal_plain(gen, L, w, form):
    """``baselines.cdtw_cdist`` at Table 1's shapes in each of row 2's
    three forms equals the CPU route bit for bit, and row 2 its plain
    version: full DTW at L = 192 (w = 191: 2w+2 floats a thread fill a
    32-thread block's 48 KB exactly, so the band row stays in shared
    memory), one past it (the scratch form), L = 96 and cDTW10 at L = 192
    (registers)."""
    from repro_torch.core.baselines import cdtw_cdist
    from repro_torch.kernels.dtw_band.ops import cdist_form
    assert cdist_form(w, 0, L) == form
    A, B = _randn(gen, 120, L), _randn(gen, 80, L)
    before = _build.LAUNCHES["dtw_band_cdist"]
    got = cdtw_cdist(A, B, None if w == L - 1 else w)
    assert _build.LAUNCHES["dtw_band_cdist"] == before + 1
    want = cdtw_cdist(A.cpu(), B.cpu(), w, device="cpu")
    assert torch.equal(got.cpu(), want)
    assert torch.equal(dtw_band_cdist(A, B, w).cpu(),
                       dtw_band_cdist_ref(A.cpu(), B.cpu(), w))


def test_sbd_and_cdist_sym_refined_card_equals_cpu(gen):
    from repro_torch.core import pq
    from repro_torch.core.baselines import sbd_cdist
    from repro_torch.data.timeseries import make_dataset
    A, B = _randn(gen, 70, 192), _randn(gen, 130, 192)
    torch.testing.assert_close(sbd_cdist(A, B).cpu(),
                               sbd_cdist(A.cpu(), B.cpu(), device="cpu"),
                               **TOL)
    X, _ = make_dataset("cbf", 10, 96, seed=2)
    cfg = pq.PQConfig(n_sub=5, codebook_size=12, kmeans_iters=2,
                      dba_iters=1)
    cb = pq.fit(X, cfg, torch.Generator().manual_seed(0), device="cpu")
    codes = pq.encode(X, cb, cfg, device="cpu")
    segs = pq.segment(torch.from_numpy(X), cfg)
    want = pq.cdist_sym_refined(codes, segs, codes, segs, cb, device="cpu")
    got = pq.cdist_sym_refined(codes, segs, codes, segs, cb)
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), want, **TOL)


def test_table1_leg_runs_the_kernels(gen):
    """One quick (dataset, seed) of the Table 1 leg on the card: its
    elastic matrices and symmetric scans take the kernel route."""
    from repro_torch.bench import table1_accuracy as leg
    from repro_torch.core import dispatch
    dispatch.reset_stats()
    g = leg.grid(True)
    r = leg.one_run("gunpoint", 1, g["n_per_class"], g["length"])
    routes = {route for _, route in dispatch.stats}
    assert routes == {"cuda"}, dispatch.stats
    assert dispatch.stats[("elastic_cdist", "cuda")] > 0
    assert dispatch.stats[("adc_cdist", "cuda")] > 0
    assert all(0.0 <= r["err"][m] <= 1.0 for m in leg.MEASURES)
