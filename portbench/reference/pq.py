"""The product quantizer's arithmetic in plain PyTorch (paper, sections 3.3
and Algorithm 2): Keogh envelopes, the encode's LB filter and refine, the
symmetric LUT, and symmetric ADC distances.

Semantics follow the paper and the configuration, with the tie rules a
user can observe: the LB filter keeps the ``T`` centroids of smallest
``max(LB_Kim, LB_Keogh)``, lower index first among equal bounds; the code
is the candidate of least refined DTW, earlier in that order among equal
costs; ADC sums the subspaces in order, then takes the root.

``dtype`` is float32 (the configuration's precision) or bfloat16 (the
control).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .dtw import band_cdist, band_dtw

__all__ = ["Codebook", "envelope", "cascade_bound", "make_codebook",
           "encode", "lut", "root", "adc_sym"]

# elements of one (rows, K, S) temporary of the LB filter
BOUND_ELEMS = 1 << 27


class Codebook(NamedTuple):
    centroids: torch.Tensor   # (M, K, S)
    upper: torch.Tensor       # (M, K, S)
    lower: torch.Tensor       # (M, K, S)
    window: int


def envelope(x: torch.Tensor, w: int):
    """Keogh envelope of ``x (..., L)``: max and min over ``|shift| <= w``,
    truncated at the ends."""
    L = x.shape[-1]
    w = max(0, min(int(w), L - 1))
    if w == 0:
        return x, x
    pad_hi = torch.nn.functional.pad(x, (w, w), value=float("-inf"))
    pad_lo = torch.nn.functional.pad(x, (w, w), value=float("inf"))
    upper = pad_hi.unfold(-1, 2 * w + 1, 1).amax(-1)
    lower = pad_lo.unfold(-1, 2 * w + 1, 1).amin(-1)
    return upper, lower


def cascade_bound(q, c, upper, lower):
    """``max(LB_Kim(q, c), LB_Keogh(q, env(c)))``; broadcasts ``(..., S)``."""
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    above = torch.where(q > upper, (q - upper) ** 2, zero)
    below = torch.where(q < lower, (lower - q) ** 2, zero)
    keogh = (above + below).sum(-1)
    kim = (q[..., 0] - c[..., 0]) ** 2 + (q[..., -1] - c[..., -1]) ** 2
    return torch.maximum(kim, keogh)


def make_codebook(centroids: torch.Tensor, window: int) -> Codebook:
    up, lo = envelope(centroids, window)
    return Codebook(centroids, up, lo, int(window))


def encode(segs: torch.Tensor, cb: Codebook, refine_t: int) -> torch.Tensor:
    """``segs (N, M, S)`` -> codes ``(N, M)`` int64."""
    N, M, S = segs.shape
    K = cb.centroids.shape[1]
    T = min(refine_t, K)
    rows = max(1, BOUND_ELEMS // (K * S))
    codes = torch.empty((N, M), dtype=torch.int64, device=segs.device)
    for m in range(M):
        c, up, lo = cb.centroids[m], cb.upper[m], cb.lower[m]
        for s in range(0, N, rows):
            e = min(N, s + rows)
            q = segs[s:e, m]
            lbs = cascade_bound(q[:, None, :], c[None], up[None], lo[None])
            cand = torch.sort(lbs, dim=-1, stable=True).indices[:, :T]
            qs = q[:, None, :].expand(e - s, T, S).reshape(-1, S)
            d = band_dtw(qs, c[cand].reshape(-1, S), cb.window,
                         dtype=segs.dtype).view(e - s, T)
            codes[s:e, m] = torch.gather(cand, 1, torch.argmin(d, 1,
                                                               keepdim=True))[:, 0]
    return codes


def lut(cb: Codebook) -> torch.Tensor:
    """Symmetric table ``(M, K, K)``: squared DTW between centroids."""
    return torch.stack([band_cdist(c, c, cb.window, dtype=c.dtype)
                        for c in cb.centroids])


def root(acc: torch.Tensor) -> torch.Tensor:
    acc = torch.clamp(acc, min=0.0)
    if acc.dtype == torch.float32 and not acc.is_cuda:
        # the CPU's float32 root is not always correctly rounded
        return torch.sqrt(acc.to(torch.float64)).to(torch.float32)
    return torch.sqrt(acc)


def adc_sym(codes_a: torch.Tensor, codes_b: torch.Tensor,
            table: torch.Tensor) -> torch.Tensor:
    """``(Na, M) x (Nb, M)`` codes -> ``(Na, Nb)``."""
    a, b = codes_a.long(), codes_b.long()
    acc = table[0][a[:, 0, None], b[None, :, 0]]
    for m in range(1, table.shape[0]):
        acc = acc + table[m][a[:, m, None], b[None, :, m]]
    return root(acc)
