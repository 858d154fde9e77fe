"""Per-pair adaptive alignment corridors: a FastDTW-style coarse projection
(PyTorch counterpart of :mod:`repro.core.corridor`).

The static Sakoe-Chiba band sweeps about ``window + 1`` cells of every
anti-diagonal even when the optimal path hugs the diagonal.  This module
bounds the corridor per pair from a cheap coarse pass:

1. PAA-downsample both series by ``factor`` (edge-padded means), giving a
   coarse grid of ``Lc = ceil(L / factor)`` cells per side;
2. banded DTW on the coarse grid, forward and backward, with full tables;
3. a coarse cell is on a (near-)optimal path iff
   ``F[i,j] + G[i,j] - cost(i,j) <= opt * (1+rtol) + atol``; per coarse
   anti-diagonal the on-path cells give a ``[lo_c, hi_c]`` range, widened
   over the neighbouring diagonals (a diagonal move skips one);
4. projection back to the fine grid with a safety ``radius``, intersected
   with the static band and closed so that ``lo`` is non-decreasing with
   per-diagonal drift <= 1, ``lo(0) = 0``, ``lo(2L-2) = L-1`` and
   ``lo <= hi`` on every diagonal.

Exactness contract: the corridor is a subset of the static band, so the
adaptive cost is an upper bound of the static banded cost, and equals it
(bit for bit: the same cells in the same order) whenever the corridor
contains the static optimal path.  :func:`certify_adaptive` checks this
at the corridor's boundary; a pair that fails keeps the documented
approximate result.  The check is the reference's heuristic, not a proof:
a re-sweep one cell wider cannot see a static optimum far outside the
corridor, and on CBF series at L=512, w=51 most certified pairs still
exceed their static cost, in the JAX package alike.

The corridor is plain PyTorch on either device (integer output; it equals
the reference's).  :func:`corridor_sweep` and :func:`certify_adaptive`
sweep through the ``dtw_band_adaptive`` kernel wrapper, so on CUDA
tensors they launch the adaptive kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .dtw import _diag_sweep
from .measures import MeasureArg, fma

__all__ = [
    "paa",
    "build_corridor",
    "static_band",
    "clip_to_width",
    "corridor_width",
    "dilate",
    "certify_adaptive",
    "corridor_sweep",
]

# on-path tolerance for the coarse through-cost test (float32 sums run in
# another order in the forward and the backward table)
_RTOL = 1e-4
_ATOL = 1e-5


def _eff_window(length: int, window: Optional[int]) -> int:
    w = length - 1 if window is None else int(window)
    return max(0, min(w, length - 1))


def _floordiv(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.div(x, k, rounding_mode="floor")


def paa(X: torch.Tensor, factor: int) -> torch.Tensor:
    """Piecewise-aggregate downsample ``(N, L) -> (N, ceil(L/factor))``;
    the tail segment is edge-padded so every coarse cell is a mean of
    ``factor`` values.  The sum runs left to right, then divides, as the
    reference's compiled mean does."""
    n, L = X.shape
    Lc = -(-L // factor)
    pad = Lc * factor - L
    if pad:
        X = torch.cat([X, X[:, -1:].expand(n, pad)], dim=1)
    seg = X.reshape(n, Lc, factor)
    acc = seg[:, :, 0]
    for k in range(1, factor):
        acc = acc + seg[:, :, k]
    return acc / float(factor)


def static_band(length: int, window: Optional[int],
                device: Optional[torch.device] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The static Sakoe-Chiba envelope as ``(lo, hi)`` int32 ``(2L-1,)``
    tensors: the widest corridor any adaptive one is clipped to.

    >>> lo, hi = static_band(4, 1)
    >>> lo.tolist(), hi.tolist()
    ([0, 0, 1, 1, 2, 2, 3], [0, 1, 1, 2, 2, 3, 3])
    """
    L = length
    w = _eff_window(length, window)
    d = torch.arange(2 * L - 1, dtype=torch.int64, device=device)
    lo = torch.maximum(torch.clamp(d - (L - 1), min=0),
                       -_floordiv(w - d, 2))
    hi = torch.minimum(torch.clamp(d, max=L - 1), _floordiv(d + w, 2))
    return lo.to(torch.int32), hi.to(torch.int32)


def build_corridor(A: torch.Tensor, B: torch.Tensor,
                   window: Optional[int] = None, *, factor: int = 8,
                   radius: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pair corridor envelopes for zipped batches ``A, B (N, L)``.

    Returns ``(lo, hi)`` int32 tensors of shape ``(N, 2L-1)`` on the inputs'
    device that satisfy the structural invariants in the module header.
    Below ``Lc = 4`` coarse cells the static band is returned (adaptive ==
    static, trivially certified).
    """
    N, L = A.shape
    dev = A.device
    A = A.to(torch.float32)
    B = B.to(torch.float32)
    w = _eff_window(L, window)
    lo_s, hi_s = static_band(L, w, dev)
    Lc = -(-L // factor)
    if Lc < 4:
        return (lo_s.expand(N, 2 * L - 1).contiguous(),
                hi_s.expand(N, 2 * L - 1).contiguous())

    Ac = paa(A, factor)
    Bc = paa(B, factor)
    wc = min(Lc - 1, w // factor + 2)
    # tables (2Lc-1, N, Lc) -> (N, 2Lc-1, Lc): F[n, d, i] = T[i, d-i]
    F = _diag_sweep(Ac, Bc, wc, True)[1].permute(1, 0, 2)
    G = _diag_sweep(Ac.flip(1), Bc.flip(1), wc, True)[1].permute(1, 0, 2)
    G = G.flip(1).flip(2)                               # cost-to-go

    i_c = torch.arange(Lc, device=dev)
    d_c = torch.arange(2 * Lc - 1, device=dev)
    j_mat = d_c[:, None] - i_c[None, :]                 # (2Lc-1, Lc)
    diff = Ac[:, None, :] - Bc[:, j_mat.clamp(0, Lc - 1)]
    opt = F[:, -1:, -1:]
    # the reference's compiled form of both sides: F + G - diff**2 as one
    # fused multiply-add, the threshold opt * (1 + rtol) + atol as another
    through = fma(-diff, diff, F + G)
    limit = fma(opt, torch.full_like(opt, 1.0 + _RTOL),
                torch.full_like(opt, _ATOL))
    on = ((j_mat >= 0) & (j_mat < Lc)
          & torch.isfinite(F) & torch.isfinite(G) & (through <= limit))

    lo_c = torch.where(on, i_c, Lc).amin(dim=2)         # (N, 2Lc-1)
    hi_c = torch.where(on, i_c, -1).amax(dim=2)
    # a diagonal move skips one anti-diagonal: cover skipped diagonals
    # from their neighbours
    lo_p = torch.nn.functional.pad(lo_c, (1, 1), value=Lc)
    hi_p = torch.nn.functional.pad(hi_c, (1, 1), value=-1)
    lo_c = torch.minimum(torch.minimum(lo_p[:, :-2], lo_p[:, 1:-1]),
                         lo_p[:, 2:])
    hi_c = torch.maximum(torch.maximum(hi_p[:, :-2], hi_p[:, 1:-1]),
                         hi_p[:, 2:])

    # project: fine diagonal d meets the blocks of coarse diagonals
    # floor(d/f)-1 and floor(d/f) only
    d_f = torch.arange(2 * L - 1, device=dev)
    dc0 = (d_f // factor).clamp(0, 2 * Lc - 2)
    dc1 = (dc0 - 1).clamp(min=0)
    lo_raw = factor * torch.minimum(lo_c[:, dc1], lo_c[:, dc0]) - radius
    hi_raw = (factor * torch.maximum(hi_c[:, dc1], hi_c[:, dc0])
              + factor - 1 + radius)

    # structural closure of lo: clamp to feasible cells, make every cell
    # reachable from the left (a running min of lo - d), then monotone (a
    # reverse running min); both only lower lo, so the corridor still
    # contains what it contained.  The max with the static band's lo
    # keeps both invariants and pins lo(0) = 0, lo(2L-2) = L-1.
    feas_hi = torch.clamp(d_f, max=L - 1)
    lo0 = torch.minimum(lo_raw, feas_hi)
    lo1 = d_f + torch.cummin(lo0 - d_f, dim=1).values
    lo2 = torch.cummin(lo1.flip(1), dim=1).values.flip(1)
    lo = torch.maximum(lo2, lo_s.long())
    hi = torch.maximum(torch.minimum(hi_raw, hi_s.long()), lo)
    return lo.to(torch.int32), hi.to(torch.int32)


def clip_to_width(lo: torch.Tensor, hi: torch.Tensor,
                  width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cap the corridor at the register ``width``.  A clipped pair may lose
    the optimal path, which :func:`certify_adaptive` detects."""
    return lo, torch.minimum(hi, lo + (width - 1))


def corridor_width(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Per-pair maximum of live cells on any diagonal: the register width
    the pair needs."""
    return (hi - lo + 1).amax(dim=-1)


def dilate(lo: torch.Tensor, hi: torch.Tensor, length: int,
           window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Widen the corridor by one cell per side, re-clipped to the static
    band (every structural invariant is kept)."""
    lo_s, hi_s = static_band(length, window, lo.device)
    return torch.maximum(lo - 1, lo_s), torch.minimum(hi + 1, hi_s)


def corridor_sweep(A: torch.Tensor, B: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, *, window: Optional[int], width: int,
                   measure: MeasureArg = None) -> torch.Tensor:
    """Adaptive band-compressed sweep: ``A, B (N, L)`` with corridors
    ``(N, 2L-1)`` -> ``(N, 1)`` costs (the adaptive kernel on CUDA
    tensors, its plain version on CPU tensors)."""
    from ..kernels.dtw_band.ops import dtw_band_adaptive
    return dtw_band_adaptive(A, B, (lo, hi), width, window, measure)[:, None]


def certify_adaptive(A: torch.Tensor, B: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, *, window: Optional[int], width: int,
                     measure: MeasureArg = None) -> torch.Tensor:
    """Corridor-boundary convergence check per pair -> bool ``(N,)``.

    Re-sweeps with the corridor dilated by one cell (still inside the
    static band) at ``width + 2``: an unchanged cost suggests the optimum
    has converged inside the corridor (a heuristic, see the module
    header).  Costs are compared with ``==``, so the
    two sweeps must be bit-exact, as the kernel and its plain version are.
    """
    L = A.shape[1]
    base = corridor_sweep(A, B, lo, hi, window=window, width=width,
                          measure=measure)
    lo_d, hi_d = dilate(lo, hi, L, window)
    wide = corridor_sweep(A, B, lo_d, hi_d, window=window, width=width + 2,
                          measure=measure)
    return (base == wide)[:, 0]
