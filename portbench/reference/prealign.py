"""MODWT (Haar) pre-alignment, section 3.5 of the paper, in plain PyTorch:
a frozen copy of the port's plain version, kept here so that a change to
the program cannot move the benchmark's reference.

1. Level-J Haar MODWT scale coefficients (circular):
   ``v_j[i] = (v_{j-1}[i] + v_{j-1}[i - 2^(j-1)]) / 2``.
2. Segment points: sign changes of ``x - v_J`` (a zero carries the last
   nonzero sign).
3. Each fixed split ``l_m = m * (D / M)`` snaps to the right-most segment
   point in ``[l_m - t, l_m]`` (never position 0), else stays.
4. Each segment is resampled linearly onto ``D / M + t`` points of the
   grid ``s * float32(1 / (S - 1))`` (the last point exactly 1).

In float32 the position ``start + lin * (n - 1)`` and the lerp ``x_hi *
frac + x_lo * (1 - frac)`` are fused multiply-adds (through float64, one
rounding), as the paper's compiled reference and the kernels compute
them.  Under bfloat16 the series values, the MODWT and the lerp are
bfloat16; the resampling positions (index arithmetic, not data) stay
float32.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["prealign"]


def _fma(a, b, c):
    if a.dtype == torch.float32:
        return (a.to(torch.float64) * b.to(torch.float64)
                + c.to(torch.float64)).to(torch.float32)
    return a * b + c


def _segment_points(x: torch.Tensor, level: int) -> torch.Tensor:
    v = x
    for j in range(1, level + 1):
        v = 0.5 * (v + torch.roll(v, 2 ** (j - 1), dims=-1))
    s = torch.sign(x - v)
    pos = torch.arange(s.shape[-1], device=s.device).expand_as(s)
    last = torch.cummax(torch.where(s != 0, pos, torch.zeros_like(pos)),
                        dim=-1).values
    s = torch.gather(s, -1, last)
    prev = torch.cat([s[..., :1], s[..., :-1]], dim=-1)
    change = (s * prev) < 0
    change[..., 0] = False
    return change


def _snap(points: torch.Tensor, n_sub: int, tail: int) -> torch.Tensor:
    N, L = points.shape
    seg = L // n_sub
    dev = points.device
    fixed = torch.arange(1, n_sub, device=dev) * seg
    cand = fixed[:, None] - torch.arange(tail + 1, device=dev)[None, :]
    ok = points[:, cand.clamp(0, L - 1)] & (cand >= 1)      # (N, M-1, t+1)
    first = ok.to(torch.int8).argmax(-1)       # first True = right-most
    interior = torch.where(ok.any(-1), fixed - first, fixed.expand_as(first))
    zero = torch.zeros((N, 1), dtype=torch.int64, device=dev)
    end = torch.full((N, 1), L, dtype=torch.int64, device=dev)
    return torch.cat([zero, interior.to(torch.int64), end], dim=-1)


def _grid(n: int, device) -> torch.Tensor:
    g = torch.arange(n, dtype=torch.float32, device=device)
    if n > 1:
        g = g * float(np.float32(1.0) / np.float32(n - 1))
        g[-1:].fill_(1.0)
    return g


def prealign(X: torch.Tensor, n_sub: int, level: int, tail: int, *,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``X (N, D)`` -> pre-aligned segments ``(N, n_sub, D // n_sub +
    tail)`` in ``dtype``."""
    X = X.to(dtype)
    N, L = X.shape
    S = L // n_sub + tail
    bounds = _snap(_segment_points(X, level), n_sub, tail)
    starts, stops = bounds[:, :-1], bounds[:, 1:]
    n = (stops - starts).to(torch.float32)
    lin = _grid(S, X.device)
    pos = _fma(lin, (n - 1.0)[..., None], starts.to(torch.float32)[..., None])
    lo = torch.floor(pos).to(torch.int64).clamp(0, L - 1)
    hi = (lo + 1).clamp(0, L - 1)
    frac = (pos - lo.to(torch.float32)).to(dtype)
    x_lo = torch.gather(X, 1, lo.view(N, -1)).view(N, n_sub, S)
    x_hi = torch.gather(X, 1, hi.view(N, -1)).view(N, n_sub, S)
    return _fma(x_hi, frac, x_lo * (1.0 - frac))
