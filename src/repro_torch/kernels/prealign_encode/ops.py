"""Wrapper of the fused MODWT prealign + elastic 1-NN encode CUDA kernel
(``csrc/prealign_encode.cu``).

A CPU tensor takes the plain two-step version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises.  One block per series; its series and
segments live in shared memory.  Where the band's ``2w + 2`` slots fit a
register bucket (:func:`repro_torch.kernels.dtw_band.ops.cdist_bucket`)
each thread sweeps its centroids with the band row in registers, against
the codebook transposed to ``(M, S, K)`` (a copy of ``M * K * S`` floats
made here, per call); else the band rows live in shared memory too, so
the block shrinks (down to one warp) as the band widens.  A geometry that
does not fit is refused with a ``ValueError``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from ...core import measures
from ...core.dispatch import effective_window
from ...core.measures import MeasureArg
from ...core.modwt import linspace01
from ..dtw_band.ops import cdist_bucket
from .ref import check_geometry, prealign_encode_ref

__all__ = ["prealign_encode", "block_geometry", "encode_geometry"]

_THREADS = 256
_SMEM_LIMIT = 227 * 1024


def _refuse(D: int, M: int, S: int, w: int, nbytes: int) -> ValueError:
    return ValueError(
        f"prealign_encode: D={D}, M={M}, S={S}, window={w} needs {nbytes} "
        "bytes of shared memory per block")


def block_geometry(D: int, M: int, S: int, w: int) -> int:
    """Threads per block of the shared-memory form (a power of two,
    32..256) whose shared memory fits; raises ``ValueError`` when none
    does."""
    def smem(threads: int) -> int:
        return 4 * (3 * D + M * S + threads * (2 * w + 2) + 2 * threads
                    + M + 1)
    threads = _THREADS
    while threads > 32 and smem(threads) > _SMEM_LIMIT:
        threads //= 2
    if smem(threads) > _SMEM_LIMIT:
        raise _refuse(D, M, S, w, smem(threads))
    return threads


def encode_geometry(D: int, M: int, K: int, S: int, w: int,
                    kid: int) -> Tuple[int, int]:
    """``(bucket, threads)`` of the launch for an effective band ``w`` and
    kernel measure id ``kid``: the register form with ``bucket`` slots
    exactly where :func:`cdist_bucket` gives one, a block of one thread
    per centroid in whole warps (at most 256); else ``bucket = 0``, the
    shared-memory form at :func:`block_geometry`'s threads.

    >>> encode_geometry(512, 8, 256, 74, 7, 0)
    (16, 256)
    >>> encode_geometry(512, 4, 40, 138, 64, 0)
    (0, 256)
    """
    bucket = cdist_bucket(w, kid, S)
    if bucket is None:
        return 0, block_geometry(D, M, S, w)
    threads = min(_THREADS, 32 * -(-K // 32))
    nbytes = 4 * (3 * D + M * (S + 2 * bucket) + S + 4 * (threads // 32)
                  + M + 1)
    if nbytes > _SMEM_LIMIT:
        raise _refuse(D, M, S, w, nbytes)
    return bucket, threads


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
    kid = measures.kernel_measure_id(spec)
    bucket, threads = encode_geometry(D, M, K, S, w, kid)
    if bucket:
        centroids = centroids.transpose(1, 2).contiguous()
    wt = measures.wdtw_weights(spec, S, dev) if spec.uses_position else None
    _launch(X, centroids, lin, wt, codes, level, tail, w, kid,
            measures.kernel_param(spec), bucket, threads)
    return codes


def _launch(X: torch.Tensor, cents: torch.Tensor, lin: torch.Tensor,
            wt: Optional[torch.Tensor], codes: torch.Tensor, level: int,
            tail: int, w: int, kid: int, param: float, bucket: int,
            threads: int) -> None:
    """The launch alone, into ``codes (N, M)``, for contiguous float32
    inputs on one CUDA device: ``cents`` is ``(M, S, K)`` for the register
    form (``bucket > 0``), ``(M, K, S)`` for the shared-memory form
    (``bucket = 0``)."""
    (N, D), M = X.shape, codes.shape[1]
    K = cents.shape[2] if bucket else cents.shape[1]
    S = lin.shape[0]
    status = _build.lib().pq_prealign_encode(
        X.data_ptr(), cents.data_ptr(), lin.data_ptr(), _build.ptr(wt),
        codes.data_ptr(), N, D, M, K, S, level, tail, w, kid, float(param),
        bucket, threads, _build.stream(X.device))
    _build.check(status, "prealign_encode")
    _build.count_launch("prealign_encode")
