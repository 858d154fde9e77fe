"""Wrapper of the fused MODWT prealign + elastic 1-NN encode CUDA kernel
(``csrc/prealign_encode.cu``).

A CPU tensor takes the plain two-step version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises.  One block per series; its series, segments
and band rows live in shared memory, so the block shrinks (down to one
warp) as the band widens, and a geometry that does not fit even then is
refused with a ``ValueError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ...core import measures
from ...core.dispatch import effective_window
from ...core.measures import MeasureArg
from ...core.modwt import linspace01
from .ref import check_geometry, prealign_encode_ref

__all__ = ["prealign_encode", "block_geometry"]

_THREADS = 256
_SMEM_LIMIT = 227 * 1024


def block_geometry(D: int, M: int, S: int, w: int) -> int:
    """Threads per block (a power of two, 32..256) whose shared memory fits;
    raises ``ValueError`` when none does."""
    def smem(threads: int) -> int:
        return 4 * (3 * D + M * S + threads * (2 * w + 2) + 2 * threads
                    + M + 1)
    threads = _THREADS
    while threads > 32 and smem(threads) > _SMEM_LIMIT:
        threads //= 2
    if smem(threads) > _SMEM_LIMIT:
        raise ValueError(
            f"prealign_encode: D={D}, M={M}, S={S}, window={w} needs "
            f"{smem(threads)} bytes of shared memory per block")
    return threads


def prealign_encode(X: torch.Tensor, centroids: torch.Tensor, level: int,
                    tail: int, window: Optional[int] = None,
                    measure: MeasureArg = None) -> torch.Tensor:
    """``X (N, D)`` against ``centroids (M, K, S)`` with ``S = D // M +
    tail`` -> codes ``(N, M)`` int32, equal to ``modwt.prealign`` followed
    by an exact 1-NN scan of every subspace codebook."""
    spec = measures.resolve(measure)
    X = X.to(torch.float32).contiguous()
    centroids = centroids.to(torch.float32).contiguous()
    if X.dim() != 2 or centroids.dim() != 3:
        raise ValueError("X must be (N, D) and centroids (M, K, S)")
    N, D = X.shape
    M, K, S = centroids.shape
    check_geometry(D, centroids, tail)
    dev = _build.kernel_device(X, centroids)
    lin = linspace01(S, X.device)
    if dev is None:
        return prealign_encode_ref(X, centroids, level, tail, window, spec,
                                   lin)
    codes = torch.empty((N, M), dtype=torch.int32, device=dev)
    if N == 0:
        return codes
    w = effective_window(S, window)
    threads = block_geometry(D, M, S, w)
    wt = measures.wdtw_weights(spec, S, dev) if spec.uses_position else None
    status = _build.lib().pq_prealign_encode(
        X.data_ptr(), centroids.data_ptr(), lin.data_ptr(), _build.ptr(wt),
        codes.data_ptr(), N, D, M, K, S, level, tail, w,
        measures.kernel_measure_id(spec), measures.kernel_param(spec),
        threads, _build.stream(dev))
    _build.check(status, "prealign_encode")
    _build.count_launch("prealign_encode")
    return codes
