"""Plain PyTorch version of the ``dtw_band`` kernels: the batched
anti-diagonal sweep of :mod:`repro_torch.core.dtw`."""

from __future__ import annotations

from typing import Optional

import torch

from ...core.dtw import dtw_batch, dtw_cdist
from ...core.measures import MeasureArg

__all__ = ["dtw_band_ref", "dtw_band_cdist_ref"]


def dtw_band_ref(A: torch.Tensor, B: torch.Tensor,
                 window: Optional[int] = None,
                 measure: MeasureArg = None) -> torch.Tensor:
    return dtw_batch(A, B, window, measure)


def dtw_band_cdist_ref(A: torch.Tensor, B: torch.Tensor,
                       window: Optional[int] = None,
                       measure: MeasureArg = None) -> torch.Tensor:
    return dtw_cdist(A, B, window, measure=measure)
