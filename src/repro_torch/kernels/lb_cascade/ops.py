"""Wrapper of the fused LB-cascade kernel (``csrc/lb_cascade.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  The launch is counted in
:data:`repro_torch.kernels._build.LAUNCHES` as ``lb_refine``.  Band rows
follow :func:`..dtw_band.ops.band_geometry`: shared memory up to
``w = 190``, a device scratch buffer beyond.  The kernel sweeps the DTW
cell only (the one measure with a Keogh cascade); other measures raise on
the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from ...core import measures
from ...core.dispatch import effective_window
from ...core.measures import MeasureArg
from ..dtw_band.ops import band_geometry
from .ref import lb_refine_ref

__all__ = ["lb_refine", "launch_lb_refine"]

_INT_MAX = 2 ** 31 - 1


def _rows(x: torch.Tensor, name: str, shape) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or tuple(x.shape) != tuple(shape):
        got = tuple(x.shape) if isinstance(x, torch.Tensor) else type(x)
        raise ValueError(f"{name} must be a tensor of shape {tuple(shape)}, "
                         f"got {got}")
    return x.to(torch.float32).contiguous()


def lb_refine(A: torch.Tensor, B: torch.Tensor, upper: torch.Tensor,
              lower: torch.Tensor, thresh: torch.Tensor,
              window: Optional[int] = None, measure: MeasureArg = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cascaded bound + conditional banded refine over zipped pairs.

    ``A (N, L)`` queries, ``B (N, L)`` candidates, ``upper``/``lower``
    ``(N, L)`` Keogh envelopes of ``A`` (built with the effective window
    of the band), ``thresh (N,)``.  Returns ``(d (N,), refined (N,)
    bool)``: ``d`` is the exact squared banded DTW where
    ``max(LB_Kim, LB_Keogh) < thresh`` and that bound elsewhere.
    """
    spec = measures.resolve(measure)
    if A.dim() != 2:
        raise ValueError("A must be a 2-D tensor (pairs, L)")
    n, L = A.shape
    A = _rows(A, "A", (n, L))
    B, upper, lower = (_rows(t, name, (n, L)) for t, name in
                       ((B, "B"), (upper, "upper"), (lower, "lower")))
    thresh = _rows(thresh, "thresh", (n,))
    dev = _build.kernel_device(A, B, upper, lower, thresh)
    if dev is None:
        return lb_refine_ref(A, B, upper, lower, thresh, window, spec)
    if measures.kernel_measure_id(spec) != measures.DTW_KERNEL_ID:
        raise ValueError(f"the lb_refine kernel sweeps dtw only, got "
                         f"{spec.name!r}")
    d = torch.empty(n, dtype=torch.float32, device=dev)
    flag = torch.empty(n, dtype=torch.int32, device=dev)
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
    threads, blocks, scratch = band_geometry(n, w, A.device)
    status = _build.lib().pq_lb_refine(
        A.data_ptr(), B.data_ptr(), upper.data_ptr(), lower.data_ptr(),
        thresh.data_ptr(), d.data_ptr(), flag.data_ptr(),
        _build.ptr(scratch), n, L, w, threads, blocks, _build.stream(A.device))
    _build.check(status, "lb_refine")
    _build.count_launch("lb_refine")
