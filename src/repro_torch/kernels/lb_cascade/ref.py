"""Plain PyTorch version of the ``lb_refine`` kernel (counterpart of
:func:`repro.kernels.lb_cascade.ref.lb_refine_ref`): the cascade bound from
the :mod:`repro_torch.core.lb` helpers, the exact banded cost of EVERY pair
from the plain sweep, then a select.  The kernel's pruning (a pruned pair
never sweeps its band) is a speed-up, not a difference in results."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...core.dtw import dtw_batch
from ...core.lb import cascade_bound
from ...core.measures import MeasureArg

__all__ = ["lb_refine_ref"]


def lb_refine_ref(A: torch.Tensor, B: torch.Tensor, upper: torch.Tensor,
                  lower: torch.Tensor, thresh: torch.Tensor,
                  window: Optional[int] = None,
                  measure: MeasureArg = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    lb = cascade_bound(B, A, upper, lower)      # LB_Keogh(b, env(a))
    d = dtw_batch(A, B, window, measure)
    surv = lb < thresh
    return torch.where(surv, d, lb), surv
