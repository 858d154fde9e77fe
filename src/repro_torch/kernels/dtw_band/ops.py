"""Wrappers of the banded elastic CUDA kernels (``csrc/dtw_band.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches in
:data:`repro_torch.kernels._build.LAUNCHES`.

Band rows (``2w+2`` floats per thread; the adaptive sweep's three
diagonals, ``3 * width``) live in shared memory when a block of at least
32 threads fits in the default 48 KB, i.e. up to ``w = 190``; beyond that
they live in a device scratch buffer allocated here and capped at 1 GiB,
with the grid cut to match (the kernels walk their pairs grid-stride).
So every ``(L, window)`` the reference takes is taken.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from ...core import measures
from ...core.dispatch import effective_window
from ...core.measures import MeasureArg
from .ref import dtw_band_adaptive_ref, dtw_band_cdist_ref, dtw_band_ref

__all__ = ["dtw_band", "dtw_band_cdist", "dtw_band_adaptive",
           "launch_dtw_band_adaptive", "band_geometry", "band_width",
           "check_corridor"]

_THREADS = 128
_SMEM_LIMIT = 48 * 1024
_SCRATCH_LIMIT = 1 << 30
_INT_MAX = 2 ** 31 - 1


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
    threads = _THREADS
    while threads > 32 and threads * row_bytes > _SMEM_LIMIT:
        threads //= 2
    if threads * row_bytes <= _SMEM_LIMIT:
        return threads, max(1, -(-n_items // threads)), None
    threads = _THREADS
    max_blocks = max(1, _SCRATCH_LIMIT // (row_bytes * threads))
    blocks = max(1, min(-(-n_items // threads), max_blocks))
    scratch = torch.empty(blocks * threads * floats,
                          dtype=torch.float32, device=device)
    return threads, blocks, scratch


def _series(x: torch.Tensor, name: str) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"{name} must be a 2-D tensor (rows, L)")
    return x.to(torch.float32).contiguous()


def _measure_args(spec: measures.MeasureSpec, L: int, dev: torch.device):
    wt = measures.wdtw_weights(spec, L, dev) if spec.uses_position else None
    return measures.kernel_measure_id(spec), measures.kernel_param(spec), wt


def dtw_band(A: torch.Tensor, B: torch.Tensor, window: Optional[int] = None,
             measure: MeasureArg = None) -> torch.Tensor:
    """Banded elastic cost over zipped pairs: ``A (N, L)``, ``B (N, L)`` ->
    ``(N,)`` (squared banded DTW under the default measure)."""
    spec = measures.resolve(measure)
    A, B = _series(A, "A"), _series(B, "B")
    if A.shape != B.shape:
        raise ValueError(f"zipped pairs need equal shapes, got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
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
    threads, blocks, scratch = band_geometry(n, w, dev)
    status = _build.lib().pq_dtw_band(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), _build.ptr(wt),
        _build.ptr(scratch), n, L, w, kid, param, threads, blocks,
        _build.stream(dev))
    _build.check(status, "dtw_band")
    _build.count_launch("dtw_band")
    return out


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
    threads, blocks, scratch = band_geometry(N * M, w, dev)
    status = _build.lib().pq_dtw_band_cdist(
        A.data_ptr(), B.data_ptr(), out.data_ptr(), _build.ptr(wt),
        _build.ptr(scratch), N, M, L, w, kid, param, threads,
        min(blocks, _INT_MAX), _build.stream(dev))
    _build.check(status, "dtw_band_cdist")
    _build.count_launch("dtw_band_cdist")
    return out


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
    the register ``width`` -> ``(N,)``.  The kernel sweeps dtw and wdtw;
    other measures raise on the card (their plain version runs on the
    CPU)."""
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
    if spec.name not in ("dtw", "wdtw"):
        raise ValueError(f"the adaptive kernel sweeps dtw and wdtw only, "
                         f"got {spec.name!r} (its plain version takes every "
                         f"measure on CPU tensors)")
    kid = measures.kernel_measure_id(spec)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    wt = measures.wdtw_weights(spec, L, dev) if spec.uses_position else None
    launch_dtw_band_adaptive(A, B, lo, hi, width, kid, wt, out)
    return out


def launch_dtw_band_adaptive(A: torch.Tensor, B: torch.Tensor,
                             lo: torch.Tensor, hi: torch.Tensor, width: int,
                             kid: int, wt: Optional[torch.Tensor],
                             out: torch.Tensor) -> None:
    """The launch alone, into ``out (N,)``, for inputs
    :func:`dtw_band_adaptive` has checked."""
    n, L = A.shape
    if n > _INT_MAX:
        raise ValueError(f"{n} pairs exceed one launch")
    if n == 0:
        return
    threads, blocks, scratch = row_geometry(n, 3 * width, A.device)
    status = _build.lib().pq_dtw_band_adaptive(
        A.data_ptr(), B.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        out.data_ptr(), _build.ptr(wt), _build.ptr(scratch), n, L, width,
        kid, threads, blocks, _build.stream(A.device))
    _build.check(status, "dtw_band_adaptive")
    _build.count_launch("dtw_band_adaptive")
