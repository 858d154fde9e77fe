"""The number that decides ``correct``: how far the program's answers lie
from the reference's, as a share of the reference's own distances.

``nn_gap``: for 1-NN, how much farther (under the reference's distances)
the neighbour the program chose lies than the nearest one, over that
query's nearest distance or the median query's, whichever is larger (the
query's median distance where both are 0).  0 when the program's choice
is a nearest neighbour.
"""

from __future__ import annotations

import torch

__all__ = ["nn_gap"]

_INF = float("inf")


def nn_gap(d_ref: torch.Tensor, chosen: torch.Tensor) -> float:
    """``d_ref (N, N_train)``, ``chosen (N,)`` training indices."""
    d_ref = d_ref.to(torch.float32)
    n_train = d_ref.shape[1]
    chosen = chosen.to(device=d_ref.device, dtype=torch.int64)
    ok = (chosen >= 0) & (chosen < n_train)
    dmin = d_ref.min(dim=1).values
    sel = d_ref.gather(1, chosen.clamp(0, n_train - 1)[:, None])[:, 0]
    scale = torch.maximum(dmin, dmin.median())
    scale = torch.where(scale > 0, scale, d_ref.median(dim=1).values)
    gap = torch.where(sel == dmin, 0.0, (sel - dmin) / scale)
    gap = torch.where(ok, gap, _INF)
    return float(torch.nan_to_num(gap, nan=_INF, posinf=_INF).max())
