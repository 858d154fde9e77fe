"""Wrappers of the banded elastic CUDA kernels (``csrc/dtw_band.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  Each wrapper counts its launches in
:data:`repro_torch.kernels._build.LAUNCHES`.

Band rows (``2w+2`` floats per thread) live in shared memory when a block
of at least 32 threads fits in the default 48 KB, i.e. up to ``w = 190``;
beyond that they live in a device scratch buffer allocated here and capped
at 1 GiB, with the grid cut to match (the kernels walk their pairs
grid-stride).  So every ``(L, window)`` the reference takes is taken.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from ...core import measures
from ...core.dispatch import effective_window
from ...core.measures import MeasureArg
from .ref import dtw_band_cdist_ref, dtw_band_ref

__all__ = ["dtw_band", "dtw_band_cdist", "band_geometry"]

_THREADS = 128
_SMEM_LIMIT = 48 * 1024
_SCRATCH_LIMIT = 1 << 30
_INT_MAX = 2 ** 31 - 1


def band_geometry(n_items: int, w: int, device: torch.device
                  ) -> Tuple[int, int, Optional[torch.Tensor]]:
    """``(threads, blocks, scratch)`` for ``n_items`` pairs at band ``w``;
    ``scratch`` is ``None`` when the band rows fit in shared memory."""
    row_bytes = (2 * w + 2) * 4
    threads = _THREADS
    while threads > 32 and threads * row_bytes > _SMEM_LIMIT:
        threads //= 2
    if threads * row_bytes <= _SMEM_LIMIT:
        return threads, max(1, -(-n_items // threads)), None
    threads = _THREADS
    max_blocks = max(1, _SCRATCH_LIMIT // (row_bytes * threads))
    blocks = max(1, min(-(-n_items // threads), max_blocks))
    scratch = torch.empty(blocks * threads * (2 * w + 2),
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
