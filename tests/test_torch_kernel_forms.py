"""How the port's kernel wrappers pick a kernel form, checked on the CPU.

The forms themselves run only on the card (``tests/test_torch_cuda.py``);
here the pure-Python selectors are held to the rules their kernels need,
and the wrappers are driven up to the launch with the device test and the
launch replaced, so that what each wrapper hands its kernel (the form,
the measure and its parameter, the codebook's layout) is seen without a
card.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import corridor as tcorr
from repro_torch.core import measures
from repro_torch.kernels import _build
from repro_torch.kernels.dtw_band import ops as dtw_ops
from repro_torch.kernels.lb_cascade import ops as lb_ops
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_attn import ops as attn_ops
from repro_torch.kernels.prealign_encode import ops as pe_ops

ERP, MSM = 2, 3


@pytest.mark.parametrize("kid", [0, 1, ERP, MSM])
@pytest.mark.parametrize("w", [0, 1, 3, 6, 7, 14, 15, 16, 31, 51, 63, 64])
def test_cdist_bucket_holds_the_row(kid, w):
    """The register form is picked exactly when the row's 2w + 2 slots fit
    the largest bucket (128 for dtw, 32 for the others), in the least
    bucket that holds them."""
    slots = 2 * w + 2
    buckets = dtw_ops.REG_BUCKETS + (dtw_ops.DTW_REG_BUCKETS if kid == 0
                                     else ())
    bucket = dtw_ops.cdist_bucket(w, kid, 74)
    if slots > max(buckets):
        assert bucket is None
    else:
        assert bucket == min(b for b in buckets if b >= slots)


def test_cdist_bucket_needs_the_staged_row_to_fit():
    # (L + 2 * bucket) floats of shared memory under 48 KB, wdtw's L
    # weights beside them
    assert dtw_ops.cdist_bucket(7, 0, 12256) == 16
    assert dtw_ops.cdist_bucket(7, 0, 12257) is None
    assert dtw_ops.cdist_bucket(7, 1, 6128) == 16
    assert dtw_ops.cdist_bucket(7, 1, 6129) is None


@pytest.mark.parametrize("N,M", [(6144, 256), (128, 6144), (1, 1), (5, 5),
                                 (200000, 3), (3, 200000), (70000, 70001)])
def test_reg_grid_threads_take_the_longer_operand(N, M):
    swap, bx, by = dtw_ops.reg_grid(N, M)
    rows, other = (M, N) if swap else (N, M)
    assert rows >= other and swap == (M > N)
    assert bx * 128 >= rows > (bx - 1) * 128
    assert by == min(other, 65535)


@pytest.mark.parametrize("width,form", [
    (1, "warp"), (32, "warp"), (33, "warp"), (64, "warp"), (65, "warp"),
    (128, "warp"), (129, "warp"), (256, "warp"), (257, "thread"),
    (512, "thread")])
def test_adaptive_variant_from_width(width, form):
    # the warp form keeps at most 8 slots a lane (32 * 8 = 256)
    assert lb_ops.adaptive_variant(width) == form


@pytest.mark.parametrize("n,L", [(1, 2), (7680, 512), (3, 29000), (9, 30000)])
@pytest.mark.parametrize("width", [1, 32, 33, 256])
def test_corridor_warp_geometry_covers_every_pair(n, L, width):
    # each warp stages [a | 32 C floats | b], C = ceil(width / 32)
    per_warp = (2 * L + 32 * lb_ops.warp_cells(width - 1)) * 4
    warps, blocks, smem = lb_ops.corridor_warp_geometry(n, L, width)
    assert 1 <= warps <= 4 and warps * blocks >= n
    assert smem == 0 or smem == warps * per_warp
    assert smem <= 227 * 1024
    if per_warp <= 227 * 1024:
        assert smem > 0


def _padded_sweep_holds(lo, hi, L, width):
    """Per pair, whether a corridor keeps what lb_refine_adaptive's padded
    warp sweep needs (wavefront.cuh::corridor_cost_warp_padded's test,
    diagonal by diagonal): lo[0] = 0, drift 0 or 1, the base cell and the
    live cells in the table."""
    lo, hi = lo.long(), hi.long()
    d = torch.arange(2 * L - 1)
    cap = torch.clamp(d, max=L - 1)
    live = torch.clamp(torch.clamp(hi - lo, max=width - 1), min=-1)
    drift = lo - torch.cat([lo[:, :1], lo[:, :-1]], 1)
    ok = (lo >= 0) & (lo <= cap) & (d - lo <= L - 1) & (lo + live <= cap)
    ok &= torch.where(d == 0, lo == 0, (drift == 0) | (drift == 1))
    return ok.all(1)


@pytest.mark.parametrize("L,window,width", [
    (64, 6, 8), (128, 12, 16), (512, 51, 32), (300, None, 32),
    (300, 80, 100)])
def test_built_corridors_take_the_padded_sweep(L, window, width):
    """Corridors as core/corridor.py builds them (clipped to the width,
    dilated for certify_adaptive's second sweep) and the static band keep
    the invariants, so no pair of the adaptive search falls back to the
    clamped sweep; a broken one is seen as broken."""
    rng = np.random.default_rng(L)
    A, B = (torch.from_numpy(np.cumsum(rng.normal(size=(24, L)), 1)
                             .astype(np.float32)) for _ in range(2))
    lo, hi = tcorr.clip_to_width(*tcorr.build_corridor(A, B, window), width)
    lo_d, hi_d = tcorr.dilate(lo, hi, L, window)
    s_lo, s_hi = tcorr.static_band(L, window, A.device)
    assert bool(_padded_sweep_holds(lo, hi, L, width).all())
    assert bool(_padded_sweep_holds(lo_d, hi_d, L, width + 2).all())
    assert bool(_padded_sweep_holds(s_lo[None], s_hi[None], L, width).all())
    lo[3, L] += 2
    hi[5, 0] = 1
    held = _padded_sweep_holds(lo, hi, L, width)
    assert not bool(held[3]) and not bool(held[5]) and int(held.sum()) == 22


def test_counter_key_separates_streams_and_devices():
    keys = {attn_ops.counter_key(torch.device("cuda", d), s)
            for d in (0, 1) for s in (0, 5, 6)}
    assert len(keys) == 6
    assert (attn_ops.counter_key("cuda:0", 5)
            == attn_ops.counter_key(torch.device("cuda", 0), 5))


def test_adaptive_launch_names_are_ledger_keys():
    for kid in range(4):
        assert dtw_ops.adaptive_launch_name(kid) in _build.LAUNCHES


class _Launch:
    """Stands in for a launcher: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))


def _on_fake_card(monkeypatch, module):
    monkeypatch.setattr(module._build, "kernel_device",
                        lambda *t: torch.device("cpu"))


@pytest.mark.parametrize("measure,kid,param", [
    ("dtw", 0, 0.0), ("wdtw:g=0.1", 1, 0.1), ("erp:g=0.3", ERP, 0.3),
    ("msm:c=0.5", MSM, 0.5)])
def test_dtw_band_adaptive_routes_every_measure(monkeypatch, measure, kid,
                                                param):
    """Every measure reaches the adaptive launch (none raises before it),
    with its kernel id and its parameter."""
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    lo, hi = tcorr.static_band(16, 3, A.device)
    launch = _Launch()
    _on_fake_card(monkeypatch, dtw_ops)
    monkeypatch.setattr(dtw_ops, "launch_dtw_band_adaptive", launch)
    dtw_ops.dtw_band_adaptive(A, B, (lo.expand(3, -1), hi.expand(3, -1)), 8,
                              3, measure)
    (args, kw), = launch.calls
    assert args[5] == kid
    assert args[8] == pytest.approx(param)
    assert (args[6] is not None) == (kid == 1)   # wdtw's weights


@pytest.mark.parametrize("measure", ["dtw", "wdtw:g=0.1", "erp:g=0.3",
                                     "msm:c=0.5"])
@pytest.mark.parametrize("L,window", [(74, 7), (74, 15), (74, 16),
                                      (512, 51)])
def test_dtw_band_cdist_picks_the_register_form(monkeypatch, measure, L,
                                                window):
    A, B = torch.zeros(5, L), torch.zeros(3, L)
    lib = _Lib()
    _on_fake_card(monkeypatch, dtw_ops)
    monkeypatch.setattr(dtw_ops._build, "lib", lambda: lib)
    monkeypatch.setattr(dtw_ops._build, "stream", lambda dev: 0)
    monkeypatch.setitem(_build.LAUNCHES, "dtw_band_cdist", 0)
    out = dtw_ops.dtw_band_cdist(A, B, window, measure)
    assert out.shape == (5, 3)
    assert _build.LAUNCHES["dtw_band_cdist"] == 1
    (name, args), = lib.called
    kid = measures.kernel_measure_id(measures.resolve(measure))
    bucket = dtw_ops.cdist_bucket(window, kid, L)
    assert (bucket is not None) == (2 * window + 2 <= (128 if kid == 0
                                                        else 32))
    if bucket is None:
        assert name == "pq_dtw_band_cdist" and args[9] == kid
    else:
        assert name == "pq_dtw_band_cdist_reg"
        assert args[8] == kid and args[10] == bucket


@pytest.mark.parametrize("L,window,form", [
    (192, 19, "registers"), (96, 95, "shared"), (192, 191, "shared"),
    (193, 192, "scratch"), (74, 64, "shared")])
def test_cdist_form_is_the_form_the_wrapper_takes(monkeypatch, L, window,
                                                  form):
    """``cdist_form`` names the form ``dtw_band_cdist`` launches: the
    register entry, or the shared-memory one with or without scratch."""
    A, B = torch.zeros(5, L), torch.zeros(3, L)
    lib = _Lib()
    _on_fake_card(monkeypatch, dtw_ops)
    monkeypatch.setattr(dtw_ops._build, "lib", lambda: lib)
    monkeypatch.setattr(dtw_ops._build, "stream", lambda dev: 0)
    monkeypatch.setitem(_build.LAUNCHES, "dtw_band_cdist", 0)
    dtw_ops.dtw_band_cdist(A, B, window)
    (name, args), = lib.called
    launched = ("registers" if name == "pq_dtw_band_cdist_reg"
                else "shared" if args[4] is None else "scratch")
    assert dtw_ops.cdist_form(window, 0, L) == form == launched


class _Lib:
    """Stands in for the kernel library: records which entry ran."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("width,entry", [
    (8, "pq_lb_refine_adaptive_warp"), (32, "pq_lb_refine_adaptive_warp"),
    (256, "pq_lb_refine_adaptive_warp"), (257, "pq_lb_refine_adaptive")])
def test_lb_refine_adaptive_form_from_width(monkeypatch, width, entry):
    n, L = 4, 300
    A = torch.zeros(n, L)
    lo, hi = tcorr.static_band(L, None, A.device)
    lib = _Lib()
    _on_fake_card(monkeypatch, lb_ops)
    monkeypatch.setattr(lb_ops._build, "lib", lambda: lib)
    monkeypatch.setattr(lb_ops._build, "stream", lambda dev: 0)
    monkeypatch.setitem(_build.LAUNCHES, "lb_refine_adaptive", 0)
    lb_ops.lb_refine(A, A, A, A, torch.zeros(n), None,
                     corridor=(lo.expand(n, -1), hi.expand(n, -1)),
                     width=width)
    assert _build.LAUNCHES["lb_refine_adaptive"] == 1
    (name, args), = lib.called
    assert name == entry
    if entry.endswith("_warp"):
        # the padded sweep (1), with its fallback for broken corridors
        assert args[9:16] == (n, L, width,
                              *lb_ops.corridor_warp_geometry(n, L, width), 1)


@pytest.mark.parametrize("n", [1, 5, 7680])
@pytest.mark.parametrize("L", [1, 7, 31, 32, 33, 74, 512, 513, 1024, 1025,
                               4000])
def test_full_warp_geometry(n, L):
    """Row 12's warp form: the least bucket of rows a lane that holds L,
    a warp for every pair; the thread form (None) beyond L = 1024."""
    geo = dtw_ops.full_warp_geometry(n, L)
    if L > 1024:
        assert geo is None
        return
    cells, warps, blocks = geo
    assert cells == min(c for c in dtw_ops.FULL_WARP_CELLS if 32 * c >= L)
    assert warps * blocks >= n > warps * (blocks - 1)


@pytest.mark.parametrize("L,cells", [(33, 2), (512, 16), (1024, 32),
                                     (1025, 0), (3000, 0)])
def test_dtw_band_full_form_from_length(monkeypatch, L, cells):
    """The full-width wrapper hands its kernel the warp form's rows a lane
    and geometry up to L = 1024, the thread form (cells 0) beyond."""
    n = 6
    A = torch.zeros(n, L)
    lib = _Lib()
    _on_fake_card(monkeypatch, dtw_ops)
    monkeypatch.setattr(dtw_ops._build, "lib", lambda: lib)
    monkeypatch.setattr(dtw_ops._build, "stream", lambda dev: 0)
    monkeypatch.setitem(_build.LAUNCHES, "dtw_band_full", 0)
    out = dtw_ops.dtw_band(A, A, 51, mode="full")
    assert out.shape == (n,)
    assert _build.LAUNCHES["dtw_band_full"] == 1
    (name, args), = lib.called
    assert name == "pq_dtw_band_full"
    assert args[4:8] == (n, L, min(51, L - 1), cells)
    if cells:
        assert args[8:10] == (128, 2) and args[3] is None
    else:
        assert args[8:10] == dtw_ops.row_geometry(n, 2 * L, A.device)[:2]


@pytest.mark.parametrize("kid", [0, 1, ERP, MSM])
@pytest.mark.parametrize("w", [0, 3, 4, 7, 8, 15, 16, 31, 32, 63, 64])
def test_encode_geometry_follows_cdist_bucket(kid, w):
    """Row 5 takes the register form exactly where cdist_bucket gives a
    bucket, in the same bucket, one thread a centroid in whole warps."""
    S, K = 138, 40
    bucket, threads = pe_ops.encode_geometry(512, 4, K, S, w, kid)
    want = dtw_ops.cdist_bucket(w, kid, S)
    assert bucket == (want or 0)
    if want is None:
        assert threads == pe_ops.block_geometry(512, 4, S, w)
    else:
        assert threads == 64


@pytest.mark.parametrize("K,threads", [(1, 32), (32, 32), (33, 64),
                                       (256, 256), (1000, 256)])
def test_encode_geometry_threads(K, threads):
    assert pe_ops.encode_geometry(512, 8, K, 74, 7, 0) == (16, threads)


def test_encode_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        pe_ops.encode_geometry(60000, 8, 256, 7500, 7, 0)
    with pytest.raises(ValueError, match="shared memory"):
        pe_ops.encode_geometry(60000, 8, 256, 7500, 200, 0)


@pytest.mark.parametrize("measure,kid,param", [
    ("dtw", 0, 0.0), ("wdtw:g=0.1", 1, 0.1), ("erp:g=0.3", ERP, 0.3),
    ("msm:c=0.5", MSM, 0.5)])
@pytest.mark.parametrize("window", [3, 7, 15, 16, 40])
def test_prealign_encode_hands_its_form(monkeypatch, measure, kid, param,
                                        window):
    """The encode wrapper hands its launch the form (bucket, threads), the
    measure id and its parameter, and the codebook as (M, S, K) for the
    register form, as (M, K, S) for the shared-memory form."""
    rng = np.random.default_rng(1)
    D, M, K, tail = 128, 4, 20, 2
    S = D // M + tail
    X = torch.from_numpy(rng.normal(size=(3, D)).astype(np.float32))
    cents = torch.from_numpy(rng.normal(size=(M, K, S)).astype(np.float32))
    launch = _Launch()
    _on_fake_card(monkeypatch, pe_ops)
    monkeypatch.setattr(pe_ops, "_launch", launch)
    codes = pe_ops.prealign_encode(X, cents, 3, tail, window, measure)
    assert codes.shape == (3, M) and codes.dtype == torch.int32
    (args, kw), = launch.calls
    w = min(window, S - 1)
    bucket, threads = pe_ops.encode_geometry(D, M, K, S, w, kid)
    assert args[7:12] == (w, kid, pytest.approx(param), bucket, threads)
    assert (bucket > 0) == (dtw_ops.cdist_bucket(w, kid, S) is not None)
    sent = args[1]
    assert sent.is_contiguous()
    assert torch.equal(sent, cents.transpose(1, 2) if bucket else cents)
    assert (args[3] is not None) == (kid == 1)   # wdtw's weights


@pytest.mark.parametrize("measure", ["dtw", "wdtw:g=0.1", "erp:g=0.3",
                                     "msm:c=0.5"])
@pytest.mark.parametrize("L,window", [(74, 7), (74, 8), (74, 15), (74, 16),
                                      (75, 31), (75, 32), (512, 51),
                                      (512, 63), (512, 64), (12257, 7)])
def test_dtw_band_picks_the_register_form(monkeypatch, measure, L, window):
    """Row 1 takes the register form exactly where cdist_bucket gives a
    bucket (from w, the measure and L alone), in that bucket, with
    pairs_reg_geometry's warps and grid and no scratch; else the
    shared-memory form (bucket 0) with band_geometry's."""
    n = 5
    A = torch.zeros(n, L)
    lib = _Lib()
    _on_fake_card(monkeypatch, dtw_ops)
    monkeypatch.setattr(dtw_ops._build, "lib", lambda: lib)
    monkeypatch.setattr(dtw_ops._build, "stream", lambda dev: 0)
    monkeypatch.setitem(_build.LAUNCHES, "dtw_band", 0)
    out = dtw_ops.dtw_band(A, A, window, measure)
    assert out.shape == (n,)
    assert _build.LAUNCHES["dtw_band"] == 1
    (name, args), = lib.called
    assert name == "pq_dtw_band"
    kid = measures.kernel_measure_id(measures.resolve(measure))
    assert args[5:9] == (n, L, window, kid)
    bucket = dtw_ops.cdist_bucket(window, kid, L)
    if bucket is None:
        threads, blocks, scratch = dtw_ops.band_geometry(n, window, A.device)
        assert args[10:13] == (0, threads, blocks)
        assert (args[4] is None) == (scratch is None)
    else:
        _, warps, blocks = dtw_ops.pairs_reg_geometry(n, L, window, kid)
        assert args[10:13] == (bucket, 32 * warps, blocks)
        assert args[4] is None
    assert (args[3] is not None) == (kid == 1)   # wdtw's weights


@pytest.mark.parametrize("kid", [0, 1, ERP, MSM])
@pytest.mark.parametrize("n,L,w", [(1, 74, 7), (1572864, 74, 7),
                                   (300, 75, 15), (7680, 512, 51),
                                   (33, 512, 31), (5, 6000, 7)])
def test_pairs_reg_geometry_fits_and_covers(kid, n, L, w):
    """Row 1's register form: a warp's slice (32 pairs x (32 + bucket - 1)
    columns, an odd pitch) and wdtw's weights within 48 KB, up to 4 warps,
    and a warp for every 32 pairs."""
    geo = dtw_ops.pairs_reg_geometry(n, L, w, kid)
    bucket = dtw_ops.cdist_bucket(w, kid, L)
    if bucket is None:
        assert geo is None
        return
    got_bucket, warps, blocks = geo
    pitch = dtw_ops.PAIR_ROWS + bucket - 1
    assert got_bucket == bucket and pitch % 2 == 1
    assert 1 <= warps <= 4
    smem = (L * 4 if kid == 1 else 0) + warps * 32 * pitch * 4
    assert smem <= 48 * 1024
    assert blocks * warps * 32 >= n > (blocks - 1) * warps * 32


@pytest.mark.parametrize("kid", [0, 1, ERP, MSM])
@pytest.mark.parametrize("n,L,width", [(1, 2, 1), (37, 65, 34),
                                       (7680, 512, 32), (9, 300, 256),
                                       (9, 300, 257), (3, 13000, 32),
                                       (3, 15000, 32), (3, 20000, 8)])
def test_adaptive_warp_geometry_fits_and_covers(kid, n, L, width):
    """Row 7's warp form up to width 256 where one warp's staged rows
    ([a | 32 C | b], erp's border sums, wdtw's weights) fit in 227 KB, up
    to 4 warps a block, a warp for every pair; None (the thread form)
    elsewhere."""
    geo = dtw_ops.adaptive_warp_geometry(n, L, width, kid)
    if width > 256:
        assert geo is None
        return
    per_warp = (2 * L + 32 * dtw_ops.warp_cells(width - 1)
                + (2 * L if kid == ERP else 0)) * 4
    fixed = L * 4 if kid == 1 else 0
    if fixed + per_warp > 227 * 1024:
        assert geo is None
        return
    warps, blocks = geo
    assert 1 <= warps <= 4 and fixed + warps * per_warp <= 227 * 1024
    assert warps * blocks >= n > warps * (blocks - 1)


@pytest.mark.parametrize("measure", ["dtw", "wdtw:g=0.1", "erp:g=0.3",
                                     "msm:c=0.5"])
@pytest.mark.parametrize("width", [8, 32, 34, 64, 256, 257])
def test_dtw_band_adaptive_picks_the_warp_form(monkeypatch, measure, width):
    """Row 7 takes the warp form (warps > 0, threads 0) from the width
    for every measure, up to 256; the thread form (warps 0) beyond, with
    row_geometry's threads and grid; counted under the measure's name."""
    n, L = 6, 300
    A = torch.zeros(n, L)
    lo, hi = tcorr.static_band(L, None, A.device)
    lib = _Lib()
    _on_fake_card(monkeypatch, dtw_ops)
    monkeypatch.setattr(dtw_ops._build, "lib", lambda: lib)
    monkeypatch.setattr(dtw_ops._build, "stream", lambda dev: 0)
    kid = measures.kernel_measure_id(measures.resolve(measure))
    name = dtw_ops.adaptive_launch_name(kid)
    monkeypatch.setitem(_build.LAUNCHES, name, 0)
    dtw_ops.dtw_band_adaptive(A, A, (lo.expand(n, -1), hi.expand(n, -1)),
                              width, None, measure)
    assert _build.LAUNCHES[name] == 1
    (entry, args), = lib.called
    assert entry == "pq_dtw_band_adaptive"
    assert args[8:12] == (n, L, width, kid)
    if width <= 256:
        warps, blocks = dtw_ops.adaptive_warp_geometry(n, L, width, kid)
        assert args[13:16] == (0, blocks, warps)
        assert args[6] is None
    else:
        threads, blocks, _ = dtw_ops.row_geometry(n, 3 * width, A.device)
        assert args[13:16][0] == threads and args[15] == 0
    assert (args[5] is not None) == (kid == 1)   # wdtw's weights


@pytest.mark.parametrize("width", [32, 256, 257])
def test_erp_warp_form_needs_no_gaps(monkeypatch, width):
    """erp's warp form forms its border sums in shared memory: no gaps
    buffer is allocated or passed; the thread form (beyond width 256)
    still takes one of 2L floats a thread."""
    n, L = 6, 300
    A = torch.zeros(n, L)
    lo, hi = tcorr.static_band(L, None, A.device)
    lib = _Lib()
    _on_fake_card(monkeypatch, dtw_ops)
    monkeypatch.setattr(dtw_ops._build, "lib", lambda: lib)
    monkeypatch.setattr(dtw_ops._build, "stream", lambda dev: 0)
    monkeypatch.setitem(_build.LAUNCHES, "dtw_band_adaptive[erp]", 0)
    made = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        made.append(out.numel())
        return out

    monkeypatch.setattr(dtw_ops.torch, "empty", empty)
    dtw_ops.dtw_band_adaptive(A, A, (lo.expand(n, -1), hi.expand(n, -1)),
                              width, None, "erp:g=0.3")
    (_, args), = lib.called
    if width <= 256:
        assert args[7] is None and made == [n]   # the output alone
    else:
        threads, blocks = args[13], args[14]
        assert args[7] is not None
        assert made[-1] == 2 * L * threads * blocks


# -- the symmetric ADC scan (rows 3 and 9): row-staged form or thread form --

SMEM_MAX = 227 * 1024
SIZES = (4, 1, 2)   # float32, int8, bfloat16 entries


@pytest.mark.parametrize("itemsize", SIZES)
@pytest.mark.parametrize("M,K", [(3, 16), (8, 256), (16, 256), (8, 512),
                                 (8, 1024), (4, 2048), (8, 4096), (8, 6)])
def test_sym_geometry_fits_shared_memory(itemsize, M, K):
    """The row-staged form takes the largest tile of ROWS_TA whose rows fit
    the card's 227 KB a block (rows a whole number of 4-byte words), and
    its smem is the layout's; where none fits, the thread form."""
    geo = adc_ops.sym_geometry(768, 6144, M, K, itemsize)
    fitting = [ta for ta in adc_ops.ROWS_TA
               if (K * itemsize) % 4 == 0
               and adc_ops.rows_smem_bytes(ta, M, K, itemsize) <= SMEM_MAX]
    if not fitting:
        assert geo.form == "thread" and geo.ta == 0
        return
    assert geo.form == "rows" and geo.ta == fitting[0] == max(fitting)
    assert geo.smem == adc_ops.rows_smem_bytes(geo.ta, M, K, itemsize)
    assert geo.smem <= SMEM_MAX
    pitch = adc_ops.row_pitch(K, itemsize, geo.ta)
    rows, warps = adc_ops.GROUP_ROWS, adc_ops.ROWS_WARPS
    warp_words = rows * M + geo.ta * (rows + 32 // geo.ta)
    assert geo.smem == 4 * (M * geo.ta * pitch + warps * warp_words
                            + (2 * M if itemsize != 4 else 0))


@pytest.mark.parametrize("itemsize", SIZES)
@pytest.mark.parametrize("ta", adc_ops.ROWS_TA)
@pytest.mark.parametrize("K", [16, 100, 256, 1024])
def test_row_pitch_spreads_a_rows_lanes_over_banks(itemsize, ta, K):
    """The staged row pitch holds a row's K entries and is 32/ta (mod 32)
    words: 1 at a warp of 32 queries, so that the ta lanes reading one
    codes_b row's column in ta different queries' rows hit ta different
    banks, whatever the column and the subspace."""
    pitch = adc_ops.row_pitch(K, itemsize, ta)
    assert 4 * pitch >= K * itemsize
    assert pitch % 32 == 32 // ta
    if ta == 32:
        assert pitch % 32 == 1
    for m in (0, 1, 7):
        for c in (0, 1, 5, 31, K * itemsize // 4 - 1):
            banks = {((m * ta + i) * pitch + c) % 32 for i in range(ta)}
            assert len(banks) == ta


def _covered_once(n, starts_ends):
    hits = np.zeros(n, dtype=np.int64)
    for a, b in starts_ends:
        hits[a:b] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("itemsize", SIZES)
@pytest.mark.parametrize("Na", [1, 5, 768, 6144, 70000])
@pytest.mark.parametrize("Nb", [1, 5, 768, 6144, 70000])
def test_sym_grid_covers_every_output_once(itemsize, Na, Nb):
    """Blocks (chunk, tile) and, in a chunk, each warp's groups of
    GROUP_ROWS codes_b rows, cover every (i, j) exactly once; the grid's y
    walks the tiles grid-stride; the chunks restage the rows within three
    quarters of the output's bytes (or there is one chunk)."""
    M, K = 8, 256
    geo = adc_ops.sym_geometry(Na, Nb, M, K, itemsize)
    assert geo.form == "rows"
    gx, gy = geo.grid
    tiles = -(-Na // geo.ta)
    assert gy == min(tiles, 65535)
    assert _covered_once(tiles, [(t, t + 1) for by in range(gy)
                                 for t in range(by, tiles, gy)])
    chunks = [(bx * geo.chunk, min((bx + 1) * geo.chunk, Nb))
              for bx in range(gx)]
    assert all(a < b for a, b in chunks)
    rows, warps = adc_ops.GROUP_ROWS, adc_ops.ROWS_WARPS
    assert geo.chunk % rows == 0
    groups = [(j0, min(j0 + rows, b)) for a, b in chunks
              for warp in range(warps)
              for j0 in range(a + rows * warp, b, rows * warps)]
    assert _covered_once(Nb, groups)
    assert gx == 1 or gx * Na * M * K * itemsize <= 0.75 * Na * Nb * 4


@pytest.mark.parametrize("itemsize,ta", [(4, 16), (1, 32), (2, 32)])
def test_sym_geometry_main_path(itemsize, ta):
    """At the main path's 768 x 6144 codes, M = 8, K = 256, every table
    type takes the row-staged form (f32: 16 queries a tile, int8 and
    bf16: a warp of 32), the grid within one wave of the 132 SMs."""
    geo = adc_ops.sym_geometry(768, 6144, 8, 256, itemsize)
    assert (geo.form, geo.ta) == ("rows", ta)
    assert geo.grid[0] * geo.grid[1] <= 132
    assert adc_ops.sym_geometry(768, 6144, 8, 8192 // itemsize,
                                itemsize).form == "thread"


def test_sym_geometry_ta_that_does_not_fit_raises():
    assert adc_ops.sym_geometry(768, 6144, 8, 256, 4, ta=16).ta == 16
    with pytest.raises(ValueError, match="shared memory"):
        adc_ops.sym_geometry(768, 6144, 8, 256, 4, ta=32)


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("M,K,Na,Nb", [(8, 256, 77, 301), (3, 16, 9, 5),
                                       (16, 256, 33, 1000), (8, 256, 1, 70),
                                       (8, 1024, 4, 6), (8, 2048, 4, 6),
                                       (8, 4096, 4, 6)])
def test_adc_sym_hands_its_form(monkeypatch, dtype, M, K, Na, Nb):
    """adc_sym_cdist (float32) and adc_sym_cdist_quant (int8, bfloat16)
    hand the row-staged entry the table's type code (2, 0, 1) and
    sym_geometry's tile, pitch, chunk and grid wherever a tile fits, and
    the thread form's entry (pq_adc_sym / pq_adc_sym_quant with its type
    code) elsewhere; one launch counted under the row's name."""
    rng = np.random.default_rng(2)
    ca = torch.from_numpy(rng.integers(0, K, (Na, M)).astype(np.int32))
    cb = torch.from_numpy(rng.integers(0, K, (Nb, M)).astype(np.int32))
    lut = torch.zeros(M, K, K)
    lib = _Lib()
    _on_fake_card(monkeypatch, adc_ops)
    monkeypatch.setattr(adc_ops._build, "lib", lambda: lib)
    monkeypatch.setattr(adc_ops._build, "stream", lambda dev: 0)
    name = "adc_sym" if dtype == "float32" else "adc_sym_quant"
    monkeypatch.setitem(_build.LAUNCHES, name, 0)
    if dtype == "float32":
        out = adc_ops.adc_sym_cdist(ca, cb, lut)
        itemsize, code = 4, 2
    else:
        q, scale, zero = adc_ops.quantize_lut(lut, dtype)
        out = adc_ops.adc_sym_cdist_quant(ca, cb, q, scale, zero)
        itemsize, code = q.element_size(), {"int8": 0, "bfloat16": 1}[dtype]
    assert out.shape == (Na, Nb)
    assert _build.LAUNCHES[name] == 1
    (entry, args), = lib.called
    geo = adc_ops.sym_geometry(Na, Nb, M, K, itemsize)
    if geo.form == "rows":
        assert entry == "pq_adc_sym_rows"
        assert args[6:15] == (Na, Nb, M, K, code, geo.ta, geo.pitch,
                              geo.chunk, geo.grid[1])
        assert (args[3] is None) == (dtype == "float32")  # scale
        assert args[2] % 4 == 0   # the table, 4-byte aligned
    elif dtype == "float32":
        assert entry == "pq_adc_sym"
        assert args[4:9] == (Na, Nb, M, K, geo.grid[1])
    else:
        assert entry == "pq_adc_sym_quant"
        assert args[6:12] == (Na, Nb, M, K, code, geo.grid[1])
    # at these M, a tile of 8 queries' rows fits up to 2 KB a row
    assert (geo.form == "rows") == (K * itemsize <= 2048)


def test_quantised_table_view_is_aligned_for_the_rows():
    """An int8 table viewed at an odd offset is copied to a 4-byte-aligned
    address (the row-staged form copies rows in 4-byte words)."""
    base = torch.zeros(4 + 2 * 16 * 16, dtype=torch.int8)
    view = base[1:1 + 2 * 16 * 16].view(2, 16, 16)
    assert view.data_ptr() % 4 != 0
    got = adc_ops._quant_table(view)
    assert got.data_ptr() % 4 == 0 and torch.equal(got, view)
    aligned = base[4:4 + 2 * 16 * 16].view(2, 16, 16)
    assert adc_ops._quant_table(aligned).data_ptr() == aligned.data_ptr()


# -- the ADC lookup (rows 4 and 10): row-staged form or table form --

def _lookup_fits(M, K, itemsize):
    return [ta for ta in adc_ops.ROWS_TA
            if (K * itemsize) % 4 == 0
            and adc_ops.rows_smem_bytes(ta, M, K, itemsize, lookup=True)
            <= SMEM_MAX]


@pytest.mark.parametrize("itemsize", SIZES)
@pytest.mark.parametrize("M,K", [(3, 16), (8, 256), (16, 256), (8, 512),
                                 (8, 1024), (4, 2048), (8, 4096), (8, 6)])
def test_lookup_geometry_fits_shared_memory(itemsize, M, K):
    """From LOOKUP_ROWS_MIN_NQ queries on, the lookup takes the largest
    tile of ROWS_TA whose rows, warps' words and (quantised) per-query
    affine fit the card's 227 KB a block; where none fits, the table
    form, whose smem is one query's table (and its scale and zero)."""
    Nq = 768
    geo = adc_ops.lookup_geometry(Nq, 6144, M, K, itemsize)
    fitting = _lookup_fits(M, K, itemsize)
    if not fitting:
        assert geo.form == "table" and geo.ta == 0
        assert geo.smem == -(-M * K * itemsize // 4) * 4 + (
            8 * M if itemsize != 4 else 0)
        return
    assert geo.form == "rows" and geo.ta == fitting[0] == max(fitting)
    assert geo.smem <= SMEM_MAX
    pitch = adc_ops.row_pitch(K, itemsize, geo.ta)
    assert geo.pitch == pitch
    rows, warps = adc_ops.GROUP_ROWS, adc_ops.ROWS_WARPS
    warp_words = rows * M + geo.ta * (rows + 32 // geo.ta)
    affine = 2 * M * geo.ta if itemsize != 4 else 0
    assert geo.smem == 4 * (M * geo.ta * pitch + warps * warp_words + affine)
    # the symmetric scan's affine is per subspace: 2 M (ta - 1) words less
    assert geo.smem - adc_ops.rows_smem_bytes(geo.ta, M, K, itemsize) == (
        4 * 2 * M * (geo.ta - 1) if itemsize != 4 else 0)


@pytest.mark.parametrize("itemsize", SIZES)
@pytest.mark.parametrize("Nq", [1, 5, 768, 6144, 70000])
@pytest.mark.parametrize("N", [1, 5, 768, 6144, 70000])
def test_lookup_grid_covers_every_output_once(itemsize, Nq, N):
    """Either form covers every (query, code row) exactly once: the
    row-staged form by (chunk, tile) blocks and each warp's groups of
    GROUP_ROWS code rows, the grid's y walking the tiles grid-stride, the
    chunks restaging the tables within three quarters of the output's
    bytes; the table form by its x blocks of 256 threads walking the code
    rows grid-stride and its y walking the queries grid-stride."""
    M, K = 8, 256
    geo = adc_ops.lookup_geometry(Nq, N, M, K, itemsize)
    gx, gy = geo.grid
    assert geo.form == ("rows" if Nq >= adc_ops.LOOKUP_ROWS_MIN_NQ[itemsize]
                        else "table")
    if geo.form == "table":
        assert gy == min(Nq, 65535) and geo.chunk == 256
        assert _covered_once(Nq, [(q, q + 1) for by in range(gy)
                                  for q in range(by, Nq, gy)])
        stride = gx * geo.chunk
        assert _covered_once(N, [(n, n + 1) for t in range(stride)
                                 for n in range(t, N, stride)])
        assert gx * gy <= max(4096, gy)
        return
    tiles = -(-Nq // geo.ta)
    assert gy == min(tiles, 65535)
    assert _covered_once(tiles, [(t, t + 1) for by in range(gy)
                                 for t in range(by, tiles, gy)])
    chunks = [(bx * geo.chunk, min((bx + 1) * geo.chunk, N))
              for bx in range(gx)]
    assert all(a < b for a, b in chunks)
    rows, warps = adc_ops.GROUP_ROWS, adc_ops.ROWS_WARPS
    assert geo.chunk % rows == 0
    groups = [(j0, min(j0 + rows, b)) for a, b in chunks
              for warp in range(warps)
              for j0 in range(a + rows * warp, b, rows * warps)]
    assert _covered_once(N, groups)
    assert gx == 1 or gx * Nq * M * K * itemsize <= 0.75 * Nq * N * 4


@pytest.mark.parametrize("itemsize,ta,grid", [(4, 16, (2, 48)),
                                              (1, 32, (5, 24)),
                                              (2, 32, None)])
def test_lookup_geometry_main_path(itemsize, ta, grid):
    """At the main path's 768 query tables x 6144 codes, M = 8, K = 256,
    every table type takes the row-staged form (f32: 16 queries a tile,
    2 chunks; int8 and bf16: a warp of 32), the grid within one wave of
    the 132 SMs; one query's table takes the table form."""
    geo = adc_ops.lookup_geometry(768, 6144, 8, 256, itemsize)
    assert (geo.form, geo.ta) == ("rows", ta)
    assert grid is None or geo.grid == grid
    assert geo.grid[0] * geo.grid[1] <= 132
    assert adc_ops.lookup_geometry(1, 6144, 8, 256, itemsize).form == "table"


@pytest.mark.parametrize("itemsize", SIZES)
def test_lookup_geometry_crossover_in_the_query_count(itemsize):
    """The table form up to LOOKUP_ROWS_MIN_NQ[itemsize] - 1 queries, the
    row-staged form from there on (the crossover measured on the card)."""
    least = adc_ops.LOOKUP_ROWS_MIN_NQ[itemsize]
    assert 1 < least <= 768
    for Nq, form in ((1, "table"), (least - 1, "table"), (least, "rows"),
                     (768, "rows")):
        assert adc_ops.lookup_geometry(Nq, 6144, 8, 256,
                                       itemsize).form == form


def test_lookup_geometry_ta_that_does_not_fit_raises():
    assert adc_ops.lookup_geometry(768, 6144, 8, 256, 4, ta=16).ta == 16
    # a tile forces the row-staged form, whatever the query count
    assert adc_ops.lookup_geometry(1, 6144, 8, 256, 1, ta=8).form == "rows"
    with pytest.raises(ValueError, match="shared memory"):
        adc_ops.lookup_geometry(768, 6144, 8, 256, 4, ta=32)
    with pytest.raises(ValueError, match="shared memory"):
        adc_ops.lookup_geometry(768, 6144, 8, 6, 1, ta=32)  # 6-byte rows


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("M,K,Nq,N", [(8, 256, 77, 301), (8, 256, 301, 77),
                                      (3, 16, 259, 5), (16, 256, 263, 1000),
                                      (8, 256, 1, 70), (8, 6, 300, 70),
                                      (8, 1024, 260, 6), (8, 4096, 260, 6),
                                      (8, 256, 0, 70)])
def test_adc_lookup_hands_its_form(monkeypatch, dtype, M, K, Nq, N):
    """adc_lookup (float32) and adc_lookup_quant (int8, bfloat16) hand the
    row-staged entry the table's type code (2, 0, 1) and lookup_geometry's
    tile, pitch, chunk and grid where it picks that form, and the table
    form's entry (pq_adc_lookup / pq_adc_lookup_quant) its 256 threads and
    grid elsewhere: under LOOKUP_ROWS_MIN_NQ queries, for rows that are
    not whole 4-byte words (int8 at K = 6) and rows no tile holds.  Nq = 0
    stands for one (M, K) table (the 2-D call).  One launch counted."""
    single = Nq == 0
    Nq = Nq or 1
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, K, (N, M)).astype(np.int32))
    qlut = torch.zeros(Nq, M, K)
    lib = _Lib()
    _on_fake_card(monkeypatch, adc_ops)
    monkeypatch.setattr(adc_ops._build, "lib", lambda: lib)
    monkeypatch.setattr(adc_ops._build, "stream", lambda dev: 0)
    name = "adc_lookup" if dtype == "float32" else "adc_lookup_quant"
    monkeypatch.setitem(_build.LAUNCHES, name, 0)
    if dtype == "float32":
        out = adc_ops.adc_lookup(codes, qlut[0] if single else qlut)
        itemsize, code = 4, 2
    else:
        q, scale, zero = adc_ops.quantize_lut(qlut.reshape(Nq * M, K), dtype)
        q, scale, zero = (t.reshape(Nq, M, -1) for t in (q, scale, zero))
        if single:
            q, scale, zero = q[0], scale[0], zero[0]
        out = adc_ops.adc_lookup_quant(codes, q, scale, zero)
        itemsize, code = q.element_size(), {"int8": 0, "bfloat16": 1}[dtype]
    assert out.shape == ((N,) if single else (Nq, N))
    assert _build.LAUNCHES[name] == 1
    (entry, args), = lib.called
    geo = adc_ops.lookup_geometry(Nq, N, M, K, itemsize)
    fits = _lookup_fits(M, K, itemsize)
    assert geo.form == ("rows" if fits
                        and Nq >= adc_ops.LOOKUP_ROWS_MIN_NQ[itemsize]
                        else "table")
    if geo.form == "rows":
        assert entry == "pq_adc_lookup_rows"
        assert args[5:14] == (Nq, N, M, K, code, geo.ta, geo.pitch,
                              geo.chunk, geo.grid[1])
        assert (args[1] is None) == (dtype == "float32")  # scale
        assert args[0] % 4 == 0   # the tables, 4-byte aligned
    elif dtype == "float32":
        assert entry == "pq_adc_lookup"
        assert args[3:10] == (Nq, N, M, K, 256, *geo.grid)
    else:
        assert entry == "pq_adc_lookup_quant"
        assert args[5:13] == (Nq, N, M, K, code, 256, *geo.grid)


def test_adc_lookup_quant_hands_an_aligned_table(monkeypatch):
    """Query tables viewed at an odd offset reach the row-staged entry
    copied to a 4-byte-aligned address (it copies rows in 4-byte words)."""
    Nq, M, K = 300, 8, 16
    base = torch.zeros(4 + Nq * M * K, dtype=torch.int8)
    view = base[1:1 + Nq * M * K].view(Nq, M, K)
    assert view.data_ptr() % 4 != 0
    scale = torch.ones(Nq, M, 1)
    lib = _Lib()
    _on_fake_card(monkeypatch, adc_ops)
    monkeypatch.setattr(adc_ops._build, "lib", lambda: lib)
    monkeypatch.setattr(adc_ops._build, "stream", lambda dev: 0)
    adc_ops.adc_lookup_quant(torch.zeros(5, M, dtype=torch.int32), view,
                             scale, 0 * scale)
    (entry, args), = lib.called
    assert entry == "pq_adc_lookup_rows"
    assert args[0] % 4 == 0 and args[0] != view.data_ptr()
