"""Wrapper of the fused LB-cascade kernel (``csrc/lb_cascade.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  The launch is counted in
:data:`repro_torch.kernels._build.LAUNCHES` as ``lb_refine``, one launch
per call.  Its form follows from the band alone (:func:`refine_variant`):
up to ``w = 255`` one warp per pair sweeps the band's anti-diagonals
across its lanes (:func:`warp_geometry`: 4 warps a CTA, each staging its
pair in shared memory); beyond, one thread per pair sweeps the band row
by row, its rows laid out as :func:`..dtw_band.ops.band_geometry` says.
The tuning table (:mod:`..tune`, ``lb_refine``'s ``warps``; 0 = a thread
per pair) may pick another warp count or the thread form.
The kernel sweeps the DTW cell only (the one measure with a Keogh
cascade); other measures raise on the card.

With ``corridor=(lo, hi)`` the refine runs inside each pair's corridor
(``csrc/lb_cascade.cu``'s adaptive entries, counted as
``lb_refine_adaptive``): the bound is the same, the refined value the
corridor-restricted cost, an upper bound of the static one.  Its form
follows from the register width alone (:func:`adaptive_variant`): up to
``W = 256`` one warp per pair sweeps the corridor's diagonals across its
lanes on rows staged in shared memory (:func:`corridor_warp_geometry`),
clamping no index where the corridor keeps its invariants; beyond, one
thread per pair.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build, tune
from ...core import measures
from ...core.dispatch import effective_window
from ...core.measures import MeasureArg
from ..dtw_band.ops import (adaptive_variant, band_geometry,
                           check_corridor, row_geometry, warp_cells)
from .ref import lb_refine_ref

__all__ = ["lb_refine", "launch_lb_refine", "launch_lb_refine_adaptive",
           "refine_variant", "warp_cells", "warp_geometry",
           "adaptive_variant", "corridor_warp_geometry"]

_INT_MAX = 2 ** 31 - 1
WARP_MAX_W = 255          # lb_cascade.cu: at most 8 band cells a lane
_WARPS = 4                # warps (pairs) per CTA of the warp form
_SMEM_MAX = 227 * 1024


def refine_variant(w: int) -> str:
    """The kernel form for an effective band ``w``: ``"warp"`` (one warp
    per pair, the band's anti-diagonals across the lanes) up to
    :data:`WARP_MAX_W`, ``"thread"`` (one thread per pair) beyond.

    >>> refine_variant(51), refine_variant(255), refine_variant(256)
    ('warp', 'warp', 'thread')
    """
    return "warp" if int(w) <= WARP_MAX_W else "thread"


def warp_geometry(n_pairs: int, L: int, w: int,
                  warps: Optional[int] = None) -> Tuple[int, int, int]:
    """``(warps, blocks, smem_bytes)`` of the warp form for ``n_pairs``
    pairs of length ``L`` at band ``w``: :data:`_WARPS` warps a CTA, each
    staging its pair's two rows with ``32 * C`` NaNs on each side
    (``2 (L + 64 C)`` floats) in shared memory; fewer warps where that
    exceeds the card's 227 KB, and ``smem_bytes = 0`` (rows read from
    device memory) where even one warp's rows do not fit.

    >>> warp_geometry(512, 512, 51), warp_geometry(7, 8000, 51)
    ((4, 128, 20480), (3, 3, 195072))
    >>> warp_geometry(3, 40000, 7)
    (1, 3, 0)

    A ``warps`` given (a tuning candidate) is taken as is, or refused with
    ``ValueError`` where its rows exceed 227 KB.
    """
    per_warp = 2 * (L + 2 * 32 * warp_cells(w)) * 4
    if warps is None:
        warps = max(1, min(_WARPS, _SMEM_MAX // per_warp))
    elif not 1 <= int(warps) <= 32 or (
            per_warp <= _SMEM_MAX and warps * per_warp > _SMEM_MAX):
        raise ValueError(f"{warps} warps' rows of length {L} exceed "
                         f"shared memory")
    warps = int(warps)
    smem = warps * per_warp if per_warp <= _SMEM_MAX else 0
    return warps, max(1, -(-n_pairs // warps)), smem


def corridor_warp_geometry(n_pairs: int, L: int,
                           width: int) -> Tuple[int, int, int]:
    """``(warps, blocks, smem_bytes)`` of the adaptive warp form for
    ``n_pairs`` pairs of length ``L`` at register ``width``: :data:`_WARPS`
    warps a CTA, each staging its pair's two rows with ``32 * C`` floats
    between them (``2 L + 32 C`` floats, ``C = warp_cells(width - 1)``) in
    shared memory; fewer warps where that exceeds the card's 227 KB, and
    ``smem_bytes = 0`` (rows read from device memory, indices clamped)
    where even one warp's rows do not fit.

    >>> corridor_warp_geometry(7680, 512, 32)
    (4, 1920, 16896)
    >>> corridor_warp_geometry(5, 10000, 100)
    (2, 3, 161024)
    >>> corridor_warp_geometry(3, 40000, 8)
    (1, 3, 0)
    """
    per_warp = (2 * L + 32 * warp_cells(int(width) - 1)) * 4
    warps = max(1, min(_WARPS, _SMEM_MAX // per_warp))
    smem = warps * per_warp if per_warp <= _SMEM_MAX else 0
    return warps, max(1, -(-n_pairs // warps)), smem


def _rows(x: torch.Tensor, name: str, shape) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or tuple(x.shape) != tuple(shape):
        got = tuple(x.shape) if isinstance(x, torch.Tensor) else type(x)
        raise ValueError(f"{name} must be a tensor of shape {tuple(shape)}, "
                         f"got {got}")
    return x.to(torch.float32).contiguous()


def lb_refine(A: torch.Tensor, B: torch.Tensor, upper: torch.Tensor,
              lower: torch.Tensor, thresh: torch.Tensor,
              window: Optional[int] = None, measure: MeasureArg = None,
              corridor=None, width: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cascaded bound + conditional banded refine over zipped pairs.

    ``A (N, L)`` queries, ``B (N, L)`` candidates, ``upper``/``lower``
    ``(N, L)`` Keogh envelopes of ``A`` (built with the effective window
    of the band), ``thresh (N,)``.  Returns ``(d (N,), refined (N,)
    bool)``: ``d`` is the exact squared banded DTW where
    ``max(LB_Kim, LB_Keogh) < thresh`` and that bound elsewhere.
    ``corridor=(lo, hi)`` int32 ``(N, 2L-1)`` with the register ``width``
    refines inside the per-pair corridors instead.
    """
    spec = measures.resolve(measure)
    if A.dim() != 2:
        raise ValueError("A must be a 2-D tensor (pairs, L)")
    n, L = A.shape
    A = _rows(A, "A", (n, L))
    B, upper, lower = (_rows(t, name, (n, L)) for t, name in
                       ((B, "B"), (upper, "upper"), (lower, "lower")))
    thresh = _rows(thresh, "thresh", (n,))
    cor = () if corridor is None else check_corridor(corridor, n, L)
    if cor and (width is None or int(width) < 1):
        raise ValueError(f"a corridor needs a register width >= 1, got "
                         f"{width}")
    dev = _build.kernel_device(A, B, upper, lower, thresh, *cor)
    if dev is None:
        return lb_refine_ref(A, B, upper, lower, thresh, window, spec,
                             cor or None, width)
    if measures.kernel_measure_id(spec) != measures.DTW_KERNEL_ID:
        raise ValueError(f"the lb_refine kernel sweeps dtw only, got "
                         f"{spec.name!r}")
    d = torch.empty(n, dtype=torch.float32, device=dev)
    flag = torch.empty(n, dtype=torch.int32, device=dev)
    if cor:
        launch_lb_refine_adaptive(A, B, upper, lower, thresh, *cor,
                                  int(width), d, flag)
    else:
        launch_lb_refine(A, B, upper, lower, thresh, window, d, flag)
    return d, flag.bool()


def launch_lb_refine(A: torch.Tensor, B: torch.Tensor, upper: torch.Tensor,
                     lower: torch.Tensor, thresh: torch.Tensor,
                     window: Optional[int], d: torch.Tensor,
                     flag: torch.Tensor) -> None:
    """The launch alone, into ``d (N,)`` float32 and ``flag (N,)`` int32,
    for inputs :func:`lb_refine` has checked (contiguous float32 on one
    CUDA device)."""
    n, L = A.shape
    if n > _INT_MAX:
        raise ValueError(f"{n} pairs exceed one launch")
    if n == 0:
        return
    w = effective_window(L, window)

    def runner(params):
        fresh = torch.empty_like(d), torch.empty_like(flag)
        _launch_static(A, B, upper, lower, thresh, w, *fresh,
                       params["warps"])
        return fresh

    default = warp_geometry(n, L, w)[0] if refine_variant(w) == "warp" else 0
    warps = tune.tuned("lb_refine", "warps", length=L, window=w,
                       default=default, runner=runner, device=A.device,
                       check=lambda k: _static_geometry(n, L, w, k))
    _launch_static(A, B, upper, lower, thresh, w, d, flag, warps)


def _static_geometry(n: int, L: int, w: int, warps: int):
    """:func:`warp_geometry` at ``warps`` a CTA (``0``: the thread form,
    no geometry); ``ValueError`` where the warp form cannot take it."""
    if not warps:
        return None
    if refine_variant(w) != "warp":
        raise ValueError(f"the warp form sweeps w <= {WARP_MAX_W}")
    return warp_geometry(n, L, w, warps)


def _launch_static(A: torch.Tensor, B: torch.Tensor, upper: torch.Tensor,
                   lower: torch.Tensor, thresh: torch.Tensor, w: int,
                   d: torch.Tensor, flag: torch.Tensor, warps: int) -> None:
    """The static launch alone: the warp form at ``warps`` a CTA
    (:func:`warp_geometry`; up to ``w = 255``), or (``warps = 0``) a
    thread per pair."""
    n, L = A.shape
    if warps:
        warps, blocks, smem = _static_geometry(n, L, w, warps)
        status = _build.lib().pq_lb_refine_warp(
            A.data_ptr(), B.data_ptr(), upper.data_ptr(), lower.data_ptr(),
            thresh.data_ptr(), d.data_ptr(), flag.data_ptr(), n, L, w, warps,
            blocks, smem, _build.stream(A.device))
    else:
        threads, blocks, scratch = band_geometry(n, w, A.device)
        status = _build.lib().pq_lb_refine(
            A.data_ptr(), B.data_ptr(), upper.data_ptr(), lower.data_ptr(),
            thresh.data_ptr(), d.data_ptr(), flag.data_ptr(),
            _build.ptr(scratch), n, L, w, threads, blocks,
            _build.stream(A.device))
    _build.check(status, "lb_refine")
    _build.count_launch("lb_refine")


def launch_lb_refine_adaptive(A: torch.Tensor, B: torch.Tensor,
                              upper: torch.Tensor, lower: torch.Tensor,
                              thresh: torch.Tensor, lo: torch.Tensor,
                              hi: torch.Tensor, width: int, d: torch.Tensor,
                              flag: torch.Tensor) -> None:
    """The adaptive launch alone (corridors ``lo, hi`` int32 ``(N, 2L-1)``,
    register ``width``), into ``d`` and ``flag``, for inputs
    :func:`lb_refine` has checked."""
    n, L = A.shape
    if n > _INT_MAX:
        raise ValueError(f"{n} pairs exceed one launch")
    if n == 0:
        return
    if adaptive_variant(width) == "warp":
        warps, blocks, smem = corridor_warp_geometry(n, L, width)
        status = _build.lib().pq_lb_refine_adaptive_warp(
            A.data_ptr(), B.data_ptr(), upper.data_ptr(), lower.data_ptr(),
            thresh.data_ptr(), lo.data_ptr(), hi.data_ptr(), d.data_ptr(),
            flag.data_ptr(), n, L, width, warps, blocks, smem, 1,
            _build.stream(A.device))
    else:
        threads, blocks, scratch = row_geometry(n, 3 * width, A.device)
        status = _build.lib().pq_lb_refine_adaptive(
            A.data_ptr(), B.data_ptr(), upper.data_ptr(), lower.data_ptr(),
            thresh.data_ptr(), lo.data_ptr(), hi.data_ptr(), d.data_ptr(),
            flag.data_ptr(), _build.ptr(scratch), n, L, width, threads,
            blocks, _build.stream(A.device))
    _build.check(status, "lb_refine_adaptive")
    _build.count_launch("lb_refine_adaptive")
