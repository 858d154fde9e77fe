"""Top-k with ``jax.lax.top_k``'s tie order, for every ranking of the port.

``torch.topk`` promises no order among equal values; the reference's
``lax.top_k`` puts the lower index first.  Duplicate rows, a query that is
a database row and equal ADC sums all make ties, so every ranking whose
ids are compared with the reference goes through :func:`smallest_k`.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["smallest_k"]


def smallest_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries along the last axis, ascending, lower
    index first among equal values -> ``(values, indices int64)``.

    >>> smallest_k(torch.tensor([3.0, 1.0, 3.0, 1.0]), 3)[1].tolist()
    [1, 3, 0]
    """
    srt = torch.sort(x, dim=-1, stable=True)
    return srt.values[..., :k], srt.indices[..., :k]
