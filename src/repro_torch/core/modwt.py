"""MODWT (Haar) pre-alignment, §3.5 of the paper (PyTorch counterpart of
:mod:`repro.core.modwt`).

  1. Haar MODWT scale coefficients at level J (circular):
     ``v_j[i] = (v_{j-1}[i] + v_{j-1}[i - 2^{j-1}]) / 2``.
  2. Segment points = sign changes of ``x - v_J`` (zeros carry the
     previous nonzero sign).
  3. Each fixed split ``l_m = m * (D/M)`` snaps to the right-most segment
     point inside ``[l_m - t, l_m]`` (if any).
  4. Each segment is linearly re-interpolated to ``D/M + t`` points.

Every step is batched over series; data-dependent boundaries are gather
indices, never shapes.  The lerp grid comes from :func:`linspace01`, which
reproduces ``jnp.linspace(0, 1, S)`` bit for bit (``torch.linspace``
computes its points by another formula, on the card above all).  The
position ``start + lin * (n - 1)`` and the lerp ``x_lo * (1 - frac) +
x_hi * frac`` are fused multiply-adds where the compiled reference
contracts them (:func:`.measures.fma`), so segments match it to the bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .measures import fma

__all__ = ["modwt_scale", "segment_points", "snap_splits", "linspace01",
           "extract_segments", "prealign", "fixed_segments"]


def modwt_scale(x: torch.Tensor, level: int) -> torch.Tensor:
    """Level-``level`` Haar MODWT scaling coefficients ``(..., L)``."""
    v = x.to(torch.float32)
    for j in range(1, level + 1):
        v = 0.5 * (v + torch.roll(v, 2 ** (j - 1), dims=-1))
    return v


def segment_points(x: torch.Tensor, level: int) -> torch.Tensor:
    """Boolean mask of positions ``i`` where ``sign(x - v_J)`` changes
    between ``i-1`` and ``i`` (exact zeros carry the previous nonzero
    sign)."""
    x = x.to(torch.float32)
    s = torch.sign(x - modwt_scale(x, level))
    # forward fill: each position reads the last nonzero sign at or before
    # it (position 0 when there is none, whose sign is then 0 too)
    pos = torch.arange(s.shape[-1], device=s.device).expand_as(s)
    last = torch.cummax(torch.where(s != 0, pos, torch.zeros_like(pos)),
                        dim=-1).values
    s = torch.gather(s, -1, last)
    prev = torch.cat([s[..., :1], s[..., :-1]], dim=-1)
    change = (s * prev) < 0
    change[..., 0] = False
    return change


def snap_splits(points: torch.Tensor, n_sub: int, tail: int) -> torch.Tensor:
    """Boundaries ``(..., n_sub + 1)`` (int64, including 0 and L): each
    interior split ``l`` moves to the right-most true position in
    ``[l - tail, l]`` (never position 0), else stays at ``l``."""
    L = points.shape[-1]
    seg = L // n_sub
    dev = points.device
    fixed = torch.arange(1, n_sub, device=dev) * seg          # (n_sub-1,)
    offs = torch.arange(tail + 1, device=dev)                  # 0 = at l
    cand = fixed[:, None] - offs[None, :]                      # (n_sub-1, t+1)
    ok = points[..., cand.clamp(0, L - 1)] & (cand >= 1)       # (..., n_sub-1, t+1)
    any_ok = ok.any(-1)
    first = ok.to(torch.int8).argmax(-1)    # first True = right-most point
    interior = torch.where(any_ok, fixed - first, fixed.expand_as(first))
    batch = points.shape[:-1]
    zero = torch.zeros(batch + (1,), dtype=torch.int64, device=dev)
    end = torch.full(batch + (1,), L, dtype=torch.int64, device=dev)
    return torch.cat([zero, interior.to(torch.int64), end], dim=-1)


def linspace01(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n, dtype=float32)`` to the bit, as XLA computes
    it: point ``s`` is ``float32(s) * float32(1 / (n - 1))`` (the compiler
    turns the division by a constant into a product with its float32
    reciprocal) and the last point is exactly 1.  Made where it is used,
    so a call on the card uploads nothing."""
    grid = torch.arange(n, dtype=torch.float32, device=device)
    if n > 1:
        grid = grid * float(np.float32(1.0) / np.float32(n - 1))
        grid[-1:].fill_(1.0)
    return grid


def extract_segments(X: torch.Tensor, bounds: torch.Tensor, out_len: int,
                     lin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``X (N, L)``, ``bounds (N, M+1)`` -> ``(N, M, out_len)`` segments,
    each ``X[start:stop]`` resampled linearly onto the grid ``lin``."""
    X = X.to(torch.float32)
    N, L = X.shape
    if lin is None:
        lin = linspace01(out_len, X.device)
    starts, stops = bounds[:, :-1], bounds[:, 1:]               # (N, M)
    n = (stops - starts).to(torch.float32)
    pos = fma(lin, (n - 1.0)[..., None], starts.to(torch.float32)[..., None])
    lo = torch.floor(pos).to(torch.int64).clamp(0, L - 1)       # (N, M, S)
    hi = (lo + 1).clamp(0, L - 1)
    frac = pos - lo.to(torch.float32)
    M = starts.shape[1]
    x_lo = torch.gather(X, 1, lo.view(N, -1)).view(N, M, out_len)
    x_hi = torch.gather(X, 1, hi.view(N, -1)).view(N, M, out_len)
    return fma(x_hi, frac, x_lo * (1.0 - frac))


def prealign(X: torch.Tensor, n_sub: int, level: int, tail: int,
             lin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full pre-alignment: ``X (N, D)`` -> ``(N, n_sub, D//n_sub + tail)``."""
    X = X.to(torch.float32)
    out_len = X.shape[-1] // n_sub + tail
    bounds = snap_splits(segment_points(X, level), n_sub, tail)
    return extract_segments(X, bounds, out_len, lin)


def fixed_segments(X: torch.Tensor, n_sub: int) -> torch.Tensor:
    """Equal-length chop without pre-alignment: ``(N, n_sub, D//n_sub)``."""
    N, D = X.shape
    seg = D // n_sub
    return X[:, :n_sub * seg].reshape(N, n_sub, seg).to(torch.float32)
