"""Squared Sakoe-Chiba banded DTW in plain PyTorch, written for the
benchmark's checks.

The recurrence is the paper's::

    T[i, j] = (a_i - b_j)^2 + min(T[i-1, j-1], T[i-1, j], T[i, j-1])

with ``T[0, 0] = (a_0 - b_0)^2``, cells outside ``|i - j| <= w`` at +inf,
and the cost ``T[L-1, L-1]``.  The sweep goes anti-diagonal by
anti-diagonal, and a diagonal keeps only its ``w + 1`` band slots: slot
``s`` of diagonal ``d`` is row ``i = ceil((d - w) / 2) + s``.

In float32 each cell is one fused multiply-add, ``fma(diff, diff,
best)``, computed through float64 (the float32 product is exact there,
so one rounding to float32 follows); that is the operation the paper's
compiled reference and the CUDA kernels perform.  Under
``dtype=torch.bfloat16`` (the lower-precision control) every value and
every operation is bfloat16.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["band_dtw", "band_cdist"]

_INF = float("inf")
# cells of one (pairs, band) temporary in a chunk of pairs
CHUNK_CELLS = 1 << 25


def _base(d: int, w: int) -> int:
    """First band row of anti-diagonal ``d``: ``ceil((d - w) / 2)``."""
    return -((w - d) // 2)


def _sweep(A: torch.Tensor, B: torch.Tensor, w: int,
           cross: bool) -> torch.Tensor:
    """Zipped pairs ``A, B (P, L)`` -> ``(P,)``, or with ``cross`` every
    pair of ``A (Pa, L)`` and ``B (Pb, L)`` -> ``(Pa * Pb,)``, row-major."""
    L = A.shape[1]
    W = w + 1
    dev, dt = A.device, A.dtype
    exact = dt == torch.float32
    P = A.shape[0] * B.shape[0] if cross else A.shape[0]
    slots = torch.arange(W, device=dev)
    bufs = [torch.full((P, W + 2), _INF, dtype=dt, device=dev)
            for _ in range(3)]
    wide = torch.empty((P, W), dtype=torch.float64, device=dev) if exact \
        else None
    for d in range(2 * L - 1):
        p1, p2, new = bufs[(d - 1) % 3], bufs[(d - 2) % 3], bufs[d % 3]
        b = _base(d, w)
        # band slots of this diagonal that hold a cell of the L x L table
        s_lo = max(0, -b, d - (L - 1) - b, -((w - d + 2 * b) // 2))
        s_hi = min(W - 1, L - 1 - b, d - b, (d + w) // 2 - b)
        i = (b + slots).clamp(0, L - 1)
        x = A.index_select(1, i)
        y = B.index_select(1, (d - b - slots).clamp(0, L - 1))
        diff = (x[:, None, :] - y[None, :, :]).reshape(P, W) if cross \
            else x - y
        oh = b - _base(d - 1, w)          # 0 or 1: row shift to diagonal d-1
        best = torch.minimum(torch.minimum(p2[:, 1:1 + W],      # T[i-1, j-1]
                                           p1[:, 1 + oh:1 + oh + W]),  # T[i, j-1]
                             p1[:, oh:oh + W])                  # T[i-1, j]
        if d == 0:
            best[:, -b] = 0.0
        out = new[:, 1:1 + W]
        if exact:
            dd = diff.to(torch.float64)
            torch.addcmul(best.to(torch.float64), dd, dd, out=wide)
            out.copy_(wide)
        else:
            torch.addcmul(best, diff, diff, out=out)
        if s_lo > 0:
            out[:, :s_lo] = _INF
        if s_hi < W - 1:
            out[:, s_hi + 1:] = _INF
    last = (L - 1) - _base(2 * L - 2, w)
    return bufs[(2 * L - 2) % 3][:, 1 + last].clone()


def band_dtw(A: torch.Tensor, B: torch.Tensor, w: int, *,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Squared banded DTW of zipped pairs ``A, B (P, L)`` -> ``(P,)`` in
    ``dtype`` (float32 with fused cells, or bfloat16)."""
    A = A.to(dtype)
    B = B.to(dtype)
    P, L = A.shape
    w = max(0, min(int(w), L - 1))
    out = torch.empty(P, dtype=dtype, device=A.device)
    rows = max(1, CHUNK_CELLS // (w + 1))
    for s in range(0, P, rows):
        e = min(P, s + rows)
        out[s:e] = _sweep(A[s:e], B[s:e], w, cross=False)
    return out


def band_cdist(A: torch.Tensor, B: torch.Tensor, w: int, *,
               dtype: torch.dtype = torch.float32,
               rows: Optional[int] = None) -> torch.Tensor:
    """Every pair: ``A (Na, L)``, ``B (Nb, L)`` -> ``(Na, Nb)``."""
    A = A.to(dtype)
    B = B.to(dtype)
    Na, L = A.shape
    Nb = B.shape[0]
    w = max(0, min(int(w), L - 1))
    out = torch.empty((Na, Nb), dtype=dtype, device=A.device)
    if rows is None:
        rows = max(1, CHUNK_CELLS // ((w + 1) * max(Nb, 1)))
    for s in range(0, Na, rows):
        e = min(Na, s + rows)
        out[s:e] = _sweep(A[s:e], B, w, cross=True).view(e - s, Nb)
    return out
