"""Plain PyTorch version of the fused prealign+encode kernel: the two-step
path it fuses, :func:`repro_torch.core.modwt.prealign` followed by an exact
per-subspace elastic 1-NN scan (first index on ties)."""

from __future__ import annotations

from typing import Optional

import torch

from ...core.dtw import dtw_cdist
from ...core.measures import MeasureArg
from ...core.modwt import prealign

__all__ = ["prealign_encode_ref", "check_geometry"]


def check_geometry(D: int, centroids: torch.Tensor, tail: int) -> None:
    """Clear error when series length / codebook / tail disagree."""
    M, _, S = centroids.shape
    want = D // M + tail
    if S != want:
        raise ValueError(
            f"prealign geometry mismatch: centroids have subseq_len={S} but "
            f"series of length {D} with n_sub={M}, tail={tail} produce "
            f"segments of length {want}")


def prealign_encode_ref(X: torch.Tensor, centroids: torch.Tensor,
                        level: int, tail: int, window: Optional[int] = None,
                        measure: MeasureArg = None,
                        lin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``X (N, D)``, ``centroids (M, K, S)`` -> codes ``(N, M)`` int32."""
    X = X.to(torch.float32)
    centroids = centroids.to(torch.float32)
    check_geometry(X.shape[-1], centroids, tail)
    M = centroids.shape[0]
    segs = prealign(X, M, level, tail, lin)                 # (N, M, S)
    d = torch.stack([dtw_cdist(segs[:, m].contiguous(), centroids[m], window,
                               measure=measure)
                     for m in range(M)], dim=1)             # (N, M, K)
    return torch.argmin(d, dim=-1).to(torch.int32)
