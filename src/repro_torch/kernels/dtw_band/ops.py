"""Wrappers of the banded elastic CUDA kernels (``csrc/dtw_band.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches in
:data:`repro_torch.kernels._build.LAUNCHES`.

Where :func:`cdist_bucket` finds a register bucket for the band (narrow
bands), the zipped and all-pairs forms keep the band row in registers
(:func:`pairs_reg_geometry`, :func:`reg_grid`); the adaptive form sweeps
each pair with one warp up to width 256 (:func:`adaptive_warp_geometry`).
Elsewhere one thread sweeps a pair, its band row (``2w+2`` floats; the
adaptive sweep's three diagonals, ``3 * width``) in shared memory when a
block of at least 32 threads fits in the default 48 KB, i.e. up to
``w = 191``, beyond that in a device scratch buffer allocated here and
capped at 1 GiB, with the grid cut to match (the kernels walk their pairs
grid-stride).  So every ``(L, window)`` the reference takes is taken, and
each form gives the same bits.  The zipped and all-pairs forms' bucket
(and the zipped register form's warps) come from the tuning table
(:mod:`..tune`: ``dtw_band``, ``dtw_band_cdist``), the selectors' choice
by default.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build, tune
from ...core import measures
from ...core.dispatch import effective_window
from ...core.measures import MeasureArg
from .ref import (dtw_band_adaptive_ref, dtw_band_cdist_ref,
                  dtw_band_full_ref, dtw_band_ref)

__all__ = ["dtw_band", "dtw_band_cdist", "dtw_band_adaptive",
           "launch_dtw_band_adaptive",
           "launch_dtw_band_full", "band_geometry", "band_width",
           "cdist_bucket", "check_bucket", "cdist_form", "reg_grid",
           "pairs_reg_geometry",
           "full_warp_geometry", "warp_cells", "adaptive_variant",
           "adaptive_warp_geometry", "adaptive_launch_name",
           "check_corridor"]

_THREADS = 128
_MIN_THREADS = 32  # the least block of the shared-memory forms
_SMEM_LIMIT = 48 * 1024
_SCRATCH_LIMIT = 1 << 30
_INT_MAX = 2 ** 31 - 1
_GRID_Y = 65535
# dtw_band.cu: register slots of the band row, for every measure; dtw also
# takes 64 and 128 (on an H100, 128 slots beat the shared-memory row at
# w = 51, L = 512: 25.4 against 34.7 ms for 128 x 6144 pairs, PERF.md)
REG_BUCKETS = (8, 16, 32)
DTW_REG_BUCKETS = (64, 128)
_DTW, _WDTW, _ERP, _MSM = 0, 1, 2, 3  # wavefront.cuh's Measure
# dtw_band.cu: rows a lane of the full-width sweep's warp form (L <= 1024)
FULL_WARP_CELLS = (1, 2, 4, 8, 16, 32)
_FULL_WARPS = 4  # warps (pairs) a block
PAIR_ROWS = 32   # dtw_band.cu::kPairRows: table rows a staged chunk
WARP_MAX_WIDTH = 256  # the adaptive warp forms: at most 8 slots a lane
_WARPS = 4       # warps a block of the zipped and adaptive warp forms
_SMEM_MAX = 227 * 1024


def cdist_bucket(w: int, kid: int, length: int) -> Optional[int]:
    """The register bucket of ``dtw_band_cdist``'s register form for an
    effective band ``w``, kernel measure id ``kid`` and series length: the
    least of :data:`REG_BUCKETS` (and for dtw :data:`DTW_REG_BUCKETS`)
    that holds the row's ``2w + 2`` slots, or ``None`` (the shared-memory
    form) where none does or what the block stages (the B row padded by
    ``bucket`` on each side, and wdtw's ``length`` weights) exceeds 48 KB.

    >>> [cdist_bucket(w, 0, 74) for w in (0, 3, 7, 15, 16, 51, 63, 64)]
    [8, 8, 16, 32, 64, 128, 128, None]
    >>> [cdist_bucket(w, 3, 74) for w in (7, 15, 16)]
    [16, 32, None]
    >>> cdist_bucket(7, 0, 20000) is None, cdist_bucket(7, 1, 6200)
    (True, None)
    """
    slots = 2 * int(w) + 2
    staged = length * (2 if int(kid) == _WDTW else 1)
    buckets = REG_BUCKETS + (DTW_REG_BUCKETS if int(kid) == _DTW else ())
    for bucket in buckets:
        if slots <= bucket:
            return (bucket if (staged + 2 * bucket) * 4 <= _SMEM_LIMIT
                    else None)
    return None


def cdist_form(w: int, kid: int, length: int) -> str:
    """The form :func:`dtw_band_cdist` takes for an effective band ``w``,
    kernel measure id ``kid`` and series length: ``"registers"`` where
    :func:`cdist_bucket` gives a bucket, else ``"shared"`` where a block of
    32 threads' band rows (``2w + 2`` floats each) fits in 48 KB, else
    ``"scratch"`` (:func:`band_geometry`).

    >>> [cdist_form(w, 0, 192) for w in (19, 95, 191, 192)]
    ['registers', 'shared', 'shared', 'scratch']
    """
    if cdist_bucket(w, kid, length) is not None:
        return "registers"
    return "shared" if _row_in_shared(2 * int(w) + 2) else "scratch"


def reg_grid(N: int, M: int) -> Tuple[bool, int, int]:
    """``(swap, blocks_x, blocks_y)`` of the register form for ``N x M``
    pairs: the threads take the longer operand's rows (B's with ``swap``),
    128 to a block, and the grid's y walks the other's (at most 65535
    blocks, grid-stride beyond).

    >>> reg_grid(6144, 256), reg_grid(16, 6144), reg_grid(3, 70000)
    ((False, 48, 256), (True, 48, 16), (True, 547, 3))
    """
    swap = M > N
    rows, other = (M, N) if swap else (N, M)
    return swap, -(-rows // _THREADS), max(1, min(other, _GRID_Y))


def check_bucket(bucket: int, w: int, kid: int, length: int) -> int:
    """``bucket`` if the register form can take it for an effective band
    ``w``, kernel measure ``kid`` and series length (one of the measure's
    buckets, at least ``2w + 2`` slots, its staged row within 48 KB), else
    ``ValueError`` (a tuning candidate the form cannot launch).

    >>> check_bucket(128, 7, 0, 74)
    128
    """
    bucket = int(bucket)
    buckets = REG_BUCKETS + (DTW_REG_BUCKETS if int(kid) == _DTW else ())
    staged = length * (2 if int(kid) == _WDTW else 1)
    if (bucket not in buckets or 2 * int(w) + 2 > bucket
            or (staged + 2 * bucket) * 4 > _SMEM_LIMIT):
        raise ValueError(f"no register form with {bucket} slots for band "
                         f"{w}, measure {kid}, length {length}")
    return bucket


def pairs_reg_geometry(n: int, L: int, w: int, kid: int,
                       bucket: Optional[int] = None,
                       warps: Optional[int] = None
                       ) -> Optional[Tuple[int, int, int]]:
    """``(bucket, warps, blocks)`` of ``dtw_band``'s register form for
    ``n`` zipped pairs of length ``L`` at effective band ``w`` under kernel
    measure ``kid``: the bucket :func:`cdist_bucket` gives, each warp
    staging its 32 pairs' ``PAIR_ROWS + bucket - 1`` columns in shared
    memory (wdtw's ``L`` weights beside them), up to 4 warps a block within
    48 KB, a block for every 128 pairs (the kernel walks them
    grid-stride); ``None`` (the shared-memory form) where no bucket holds
    the band.

    >>> pairs_reg_geometry(1572864, 74, 7, 0)
    (16, 4, 12288)
    >>> pairs_reg_geometry(5, 512, 51, 0)
    (128, 2, 1)
    >>> pairs_reg_geometry(9, 74, 16, 3) is None
    True

    A ``bucket`` or ``warps`` given (the tuner's candidates) is taken as
    is, or refused with ``ValueError`` where the form cannot launch it.
    """
    if bucket is None:
        bucket = cdist_bucket(w, kid, L)
        if bucket is None:
            return None
    else:
        check_bucket(bucket, w, kid, L)
    fixed = L * 4 if int(kid) == _WDTW else 0  # within 48 KB by the bucket
    per_warp = 32 * (PAIR_ROWS + bucket - 1) * 4
    if warps is None:
        warps = max(1, min(_WARPS, (_SMEM_LIMIT - fixed) // per_warp))
    elif not 1 <= int(warps) <= 32 or fixed + warps * per_warp > _SMEM_LIMIT:
        raise ValueError(f"{warps} warps of {bucket}-slot rows exceed 48 KB")
    warps = int(warps)
    return bucket, warps, max(1, min(-(-n // (32 * warps)), _INT_MAX))


def warp_cells(w: int) -> int:
    """Cells (or corridor slots) a lane of the warp forms keeps for
    ``w + 1`` of them: ``ceil((w+1)/32)`` rounded up to 1, 2, 4 or 8
    (the template ``C`` of ``lb_cascade.cu`` and of ``dtw_band.cu``'s
    adaptive warp form).

    >>> [warp_cells(w) for w in (0, 31, 32, 51, 64, 255)]
    [1, 1, 2, 2, 4, 8]
    """
    need = -(-(int(w) + 1) // 32)
    return next(c for c in (1, 2, 4, 8) if c >= need)


def adaptive_variant(width: int) -> str:
    """The adaptive kernels' form for a register ``width``: ``"warp"``
    (one warp per pair, the corridor's slots across the lanes) up to
    :data:`WARP_MAX_WIDTH`, ``"thread"`` (one thread per pair) beyond.

    >>> adaptive_variant(32), adaptive_variant(256), adaptive_variant(257)
    ('warp', 'warp', 'thread')
    """
    return "warp" if int(width) <= WARP_MAX_WIDTH else "thread"


def adaptive_warp_geometry(n: int, L: int, width: int, kid: int
                           ) -> Optional[Tuple[int, int]]:
    """``(warps, blocks)`` of ``dtw_band_adaptive``'s warp form for ``n``
    pairs of length ``L`` at register ``width`` under kernel measure
    ``kid``: each warp stages its pair as ``[a | 32 C floats | b]`` (``C =
    warp_cells(width - 1)``), for erp followed by the border sums (``2 L``
    floats more), wdtw's ``L`` weights once a block; up to 4 warps a
    block within the card's 227 KB.  ``None`` (the thread form) beyond
    :data:`WARP_MAX_WIDTH` or where one warp's rows do not fit.

    >>> adaptive_warp_geometry(7680, 512, 32, 0)
    (4, 1920)
    >>> adaptive_warp_geometry(7680, 512, 257, 0) is None
    True
    >>> adaptive_warp_geometry(3, 15000, 32, 2) is None
    True
    """
    if adaptive_variant(width) != "warp":
        return None
    per_warp = (2 * L + 32 * warp_cells(int(width) - 1)
                + (2 * L if int(kid) == _ERP else 0)) * 4
    fixed = L * 4 if int(kid) == _WDTW else 0
    if fixed + per_warp > _SMEM_MAX:
        return None
    warps = max(1, min(_WARPS, (_SMEM_MAX - fixed) // per_warp))
    return warps, max(1, -(-n // warps))


def full_warp_geometry(n: int, L: int) -> Optional[Tuple[int, int, int]]:
    """``(cells, warps, blocks)`` of the full-width sweep's warp form for
    ``n`` pairs of length ``L``: one warp a pair, each lane holding
    ``cells`` rows (the least of :data:`FULL_WARP_CELLS` with ``32 * cells
    >= L``), ``warps`` pairs a block; ``None`` beyond ``L = 1024``, where
    the thread form sweeps.

    >>> full_warp_geometry(7680, 512), full_warp_geometry(5, 33)
    ((16, 4, 1920), (2, 4, 2))
    >>> full_warp_geometry(1, 1025) is None
    True
    """
    for cells in FULL_WARP_CELLS:
        if 32 * cells >= L:
            return cells, _FULL_WARPS, max(1, -(-n // _FULL_WARPS))
    return None


def adaptive_launch_name(kid: int) -> str:
    """The launch ledger's name of an adaptive sweep under kernel measure
    ``kid``: the bare name for dtw, ``op[measure]`` for the others (the
    dispatch ledger's key form).

    >>> [adaptive_launch_name(k) for k in range(4)]
    ['dtw_band_adaptive', 'dtw_band_adaptive[wdtw]', \
'dtw_band_adaptive[erp]', 'dtw_band_adaptive[msm]']
    """
    suffix = {_WDTW: "[wdtw]", _ERP: "[erp]", _MSM: "[msm]"}.get(int(kid), "")
    return "dtw_band_adaptive" + suffix


def band_width(length: int, window: Optional[int], lane: int = 8) -> int:
    """The reference's compressed register width: the band's cells per
    anti-diagonal padded up to a ``lane`` multiple, capped at ``length``
    (exactly the cell count when that is already a lane multiple).  The
    adaptive sweep's slots follow it; the static kernels need no width.

    >>> band_width(128, 15), band_width(128, 16), band_width(64, 1000)
    (16, 24, 64)
    """
    w = length if window is None else int(window)
    need = min(w, length - 1) + 1
    if need % lane == 0:
        return min(length, need)
    return min(length, -(-need // lane) * lane)


def band_geometry(n_items: int, w: int, device: torch.device
                  ) -> Tuple[int, int, Optional[torch.Tensor]]:
    """``(threads, blocks, scratch)`` for ``n_items`` pairs at band ``w``;
    ``scratch`` is ``None`` when the band rows fit in shared memory."""
    return row_geometry(n_items, 2 * w + 2, device)


def row_geometry(n_items: int, floats: int, device: torch.device
                 ) -> Tuple[int, int, Optional[torch.Tensor]]:
    """``(threads, blocks, scratch)`` for ``n_items`` pairs that each keep
    ``floats`` floats of DP state, in shared memory or in scratch."""
    row_bytes = floats * 4
    if _row_in_shared(floats):
        threads = _THREADS
        while threads * row_bytes > _SMEM_LIMIT:
            threads //= 2
        return threads, max(1, -(-n_items // threads)), None
    threads = _THREADS
    max_blocks = max(1, _SCRATCH_LIMIT // (row_bytes * threads))
    blocks = max(1, min(-(-n_items // threads), max_blocks))
    scratch = torch.empty(blocks * threads * floats,
                          dtype=torch.float32, device=device)
    return threads, blocks, scratch


def _row_in_shared(floats: int) -> bool:
    """A block of at least 32 threads keeps ``floats`` floats a thread in
    the default 48 KB of shared memory."""
    return _MIN_THREADS * floats * 4 <= _SMEM_LIMIT


def _series(x: torch.Tensor, name: str) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"{name} must be a 2-D tensor (rows, L)")
    return x.to(torch.float32).contiguous()


def _measure_args(spec: measures.MeasureSpec, L: int, dev: torch.device):
    wt = measures.wdtw_weights(spec, L, dev) if spec.uses_position else None
    return measures.kernel_measure_id(spec), measures.kernel_param(spec), wt


def dtw_band(A: torch.Tensor, B: torch.Tensor, window: Optional[int] = None,
             measure: MeasureArg = None,
             mode: str = "compressed") -> torch.Tensor:
    """Banded elastic cost over zipped pairs: ``A (N, L)``, ``B (N, L)`` ->
    ``(N,)`` (squared banded DTW under the default measure).

    ``mode="full"`` runs the reference's full-width sweep instead (every
    anti-diagonal over all ``L`` rows, the band only a mask): its
    DTW-only benchmark baseline, equal to the default sweep to the bit."""
    spec = measures.resolve(measure)
    A, B = _series(A, "A"), _series(B, "B")
    if A.shape != B.shape:
        raise ValueError(f"zipped pairs need equal shapes, got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    if mode == "full":
        if spec.name != "dtw":
            raise ValueError(
                "mode='full' is the legacy DTW-only benchmark baseline; "
                f"measure {spec.name!r} requires mode='compressed'")
        return _dtw_band_full(A, B, window)
    if mode != "compressed":
        raise ValueError(f"unknown dtw_band mode: {mode!r}")
    dev = _build.kernel_device(A, B)
    if dev is None:
        return dtw_band_ref(A, B, window, spec)
    n, L = A.shape
    if n > _INT_MAX:
        raise ValueError(f"{n} pairs exceed one launch")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    w = effective_window(L, window)
    kid, param, wt = _measure_args(spec, L, dev)
    reg = pairs_reg_geometry(n, L, w, kid)
    default = ({"bucket": reg[0], "warps": reg[1]} if reg is not None
               else {"bucket": 0, "warps": 0})

    def launch(params, dst):
        _launch_pairs(A, B, dst, wt, w, kid, param, params["bucket"],
                      params["warps"])

    def runner(params):
        fresh = torch.empty_like(out)
        launch(params, fresh)
        return (fresh,)

    def check(params):
        if params["bucket"]:
            pairs_reg_geometry(n, L, w, kid, params["bucket"],
                               params["warps"])

    launch(tune.resolve("dtw_band", default, length=L, window=w,
                        measure=spec.name, runner=runner, device=dev,
                        check=check), out)
    return out


def _launch_pairs(A: torch.Tensor, B: torch.Tensor, out: torch.Tensor,
                  wt: Optional[torch.Tensor], w: int, kid: int, param: float,
                  bucket: int, warps: int) -> None:
    """``dtw_band``'s launch alone: the register form with ``bucket``
    slots and ``warps`` a block, or (``bucket = 0``) the shared-memory
    row as :func:`band_geometry` lays it out."""
    n, L = A.shape
    if bucket:
        bucket, warps, blocks = pairs_reg_geometry(n, L, w, kid, bucket,
                                                   warps)
        threads, scratch = 32 * warps, None
    else:
        threads, blocks, scratch = band_geometry(n, w, A.device)
    status = _build.lib().pq_dtw_band(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), _build.ptr(wt),
        _build.ptr(scratch), n, L, w, kid, param, bucket, threads, blocks,
        _build.stream(A.device))
    _build.check(status, "dtw_band")
    _build.count_launch("dtw_band")


def _dtw_band_full(A: torch.Tensor, B: torch.Tensor,
                   window: Optional[int]) -> torch.Tensor:
    dev = _build.kernel_device(A, B)
    if dev is None:
        return dtw_band_full_ref(A, B, window)
    out = torch.empty(A.shape[0], dtype=torch.float32, device=dev)
    launch_dtw_band_full(A, B, effective_window(A.shape[1], window), out)
    return out


def launch_dtw_band_full(A: torch.Tensor, B: torch.Tensor, w: int,
                         out: torch.Tensor) -> None:
    """The full-width launch alone, into ``out (N,)``, for contiguous
    float32 ``A, B (N, L)`` on one CUDA device and the effective band
    ``w``.  Up to ``L = 1024`` one warp sweeps a pair, its two diagonals
    in registers (:func:`full_warp_geometry`); beyond, each thread keeps
    two diagonals (``2L`` floats), in shared memory or device scratch as
    :func:`row_geometry` decides."""
    n, L = A.shape
    if n > _INT_MAX:
        raise ValueError(f"{n} pairs exceed one launch")
    if n == 0:
        return
    warp = full_warp_geometry(n, L)
    if warp is not None:
        cells, warps, blocks = warp
        threads, scratch = 32 * warps, None
    else:
        cells = 0
        threads, blocks, scratch = row_geometry(n, 2 * L, A.device)
    status = _build.lib().pq_dtw_band_full(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), _build.ptr(scratch), n,
        L, w, cells, threads, blocks, _build.stream(A.device))
    _build.check(status, "dtw_band_full")
    _build.count_launch("dtw_band_full")


def dtw_band_cdist(A: torch.Tensor, B: torch.Tensor,
                   window: Optional[int] = None,
                   measure: MeasureArg = None) -> torch.Tensor:
    """All-pairs banded elastic cost: ``A (N, L)``, ``B (M, L)`` ->
    ``(N, M)``; the ``N * M`` pairs are indexed inside the kernel, never
    materialised."""
    spec = measures.resolve(measure)
    A, B = _series(A, "A"), _series(B, "B")
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"series lengths differ: {A.shape[1]} vs "
                         f"{B.shape[1]}")
    dev = _build.kernel_device(A, B)
    if dev is None:
        return dtw_band_cdist_ref(A, B, window, spec)
    (N, L), M = A.shape, B.shape[0]
    if N > _INT_MAX or M > _INT_MAX:
        raise ValueError(f"({N}, {M}) pairs exceed one launch")
    out = torch.empty((N, M), dtype=torch.float32, device=dev)
    if N * M == 0:
        return out
    w = effective_window(L, window)
    kid, param, wt = _measure_args(spec, L, dev)

    def runner(params):
        fresh = torch.empty_like(out)
        _launch_cdist(A, B, fresh, wt, w, kid, param, params["bucket"])
        return (fresh,)

    bucket = tune.tuned("dtw_band_cdist", "bucket", length=L, window=w,
                        measure=spec.name,
                        default=cdist_bucket(w, kid, L) or 0,
                        runner=runner, device=dev,
                        check=lambda b: b and check_bucket(b, w, kid, L))
    _launch_cdist(A, B, out, wt, w, kid, param, bucket)
    return out


def _launch_cdist(A: torch.Tensor, B: torch.Tensor, out: torch.Tensor,
                  wt: Optional[torch.Tensor], w: int, kid: int, param: float,
                  bucket: int) -> None:
    """``dtw_band_cdist``'s launch alone: the register form with
    ``bucket`` slots (:func:`check_bucket`), or (``bucket = 0``) the band
    rows in shared memory or scratch (:func:`band_geometry`)."""
    (N, L), M = A.shape, B.shape[0]
    dev = A.device
    if bucket:
        check_bucket(bucket, w, kid, L)
        swap, blocks_x, blocks_y = reg_grid(N, M)
        status = _build.lib().pq_dtw_band_cdist_reg(
            A.data_ptr(), B.data_ptr(), out.data_ptr(), _build.ptr(wt), N, M,
            L, w, kid, param, bucket, int(swap), _THREADS, blocks_x,
            blocks_y, _build.stream(dev))
    else:
        threads, blocks, scratch = band_geometry(N * M, w, dev)
        status = _build.lib().pq_dtw_band_cdist(
            A.data_ptr(), B.data_ptr(), out.data_ptr(), _build.ptr(wt),
            _build.ptr(scratch), N, M, L, w, kid, param, threads,
            min(blocks, _INT_MAX), _build.stream(dev))
    _build.check(status, "dtw_band_cdist")
    _build.count_launch("dtw_band_cdist")


def check_corridor(corridor, n: int, L: int):
    """``(lo, hi)`` as contiguous int32 ``(n, 2L-1)`` tensors.  The
    kernels trust the structural invariants that
    :mod:`repro_torch.core.corridor` builds (``lo`` non-decreasing with
    drift <= 1 inside the static band, ``lo <= hi``); they clamp every
    index, so a corridor that breaks them gives a wrong cost, never a
    fault."""
    lo, hi = corridor
    out = []
    for name, c in (("lo", lo), ("hi", hi)):
        shape = (n, 2 * L - 1)
        if not isinstance(c, torch.Tensor) or tuple(c.shape) != shape:
            got = tuple(c.shape) if isinstance(c, torch.Tensor) else type(c)
            raise ValueError(f"corridor {name} must be {shape}, got {got}")
        out.append(c.to(torch.int32).contiguous())
    return out[0], out[1]


def dtw_band_adaptive(A: torch.Tensor, B: torch.Tensor, corridor,
                      width: int, window: Optional[int] = None,
                      measure: MeasureArg = None) -> torch.Tensor:
    """Elastic cost of zipped pairs inside per-pair corridors:
    ``A, B (N, L)`` with ``corridor = (lo, hi)`` int32 ``(N, 2L-1)`` and
    the register ``width`` -> ``(N,)``, under any measure (for erp the
    kernel forms the border sums in the reference's log-depth order)."""
    spec = measures.resolve(measure)
    A, B = _series(A, "A"), _series(B, "B")
    if A.shape != B.shape:
        raise ValueError(f"zipped pairs need equal shapes, got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    n, L = A.shape
    width = int(width)
    if width < 1:
        raise ValueError(f"width={width} must be >= 1")
    lo, hi = check_corridor(corridor, n, L)
    dev = _build.kernel_device(A, B, lo, hi)
    if dev is None:
        return dtw_band_adaptive_ref(A, B, lo, hi, window, width, spec)
    kid, param, wt = _measure_args(spec, L, dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    launch_dtw_band_adaptive(A, B, lo, hi, width, kid, wt, out, param)
    return out


def launch_dtw_band_adaptive(A: torch.Tensor, B: torch.Tensor,
                             lo: torch.Tensor, hi: torch.Tensor, width: int,
                             kid: int, wt: Optional[torch.Tensor],
                             out: torch.Tensor, param: float = 0.0) -> None:
    """The launch alone, into ``out (N,)``, for inputs
    :func:`dtw_band_adaptive` has checked; ``param`` is the measure's
    (erp's gap value, msm's split cost).  Up to width 256 one warp sweeps
    a pair (:func:`adaptive_warp_geometry`, erp's border sums formed in
    shared memory); beyond, one thread a pair, its three diagonals laid
    out as :func:`row_geometry` says and erp's border sums in a scratch
    buffer of ``2L`` floats a thread, the grid cut to fit 1 GiB.  Counted
    under :func:`adaptive_launch_name`."""
    n, L = A.shape
    if n > _INT_MAX:
        raise ValueError(f"{n} pairs exceed one launch")
    if n == 0:
        return
    warp = adaptive_warp_geometry(n, L, width, kid)
    gaps = scratch = None
    if warp is not None:
        (warps, blocks), threads = warp, 0
    else:
        warps = 0
        threads, blocks, scratch = row_geometry(n, 3 * width, A.device)
        if kid == _ERP:
            blocks = max(1, min(blocks, _SCRATCH_LIMIT // (8 * L * threads)))
            gaps = torch.empty(2 * L * threads * blocks,
                               dtype=torch.float32, device=A.device)
    status = _build.lib().pq_dtw_band_adaptive(
        A.data_ptr(), B.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        out.data_ptr(), _build.ptr(wt), _build.ptr(scratch),
        _build.ptr(gaps), n, L, width, kid, float(param), threads, blocks,
        warps, _build.stream(A.device))
    name = adaptive_launch_name(kid)
    _build.check(status, name)
    _build.count_launch(name)
