"""DTW Barycenter Averaging (Petitjean et al.) in PyTorch (counterpart of
:mod:`repro.core.dba`).

DBA aligns every member series to the current barycenter with DTW and
replaces each barycenter point by the mean of the member points aligned
to it.  Paths are recovered by backtracking the DP table of
:func:`repro_torch.core.dtw.dtw_full_table`, batched over pairs: a
fixed-length loop of ``2L-1`` steps carrying ``(i, j, done)`` per pair.
Training time only; plain PyTorch on either device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .dtw import dtw_full_table

__all__ = ["alignment_path", "dba_update", "dba"]

_INF = float("inf")


def alignment_path(c: torch.Tensor, x: torch.Tensor,
                   window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimal-path cells aligning barycenters ``c (P, L)`` (index i) to
    series ``x (P, L)`` (index j), pair by pair.  Returns ``(i_cells,
    j_cells, active)``, each ``(P, 2L-1)``; inactive tail entries repeat
    (0, 0) with ``active=False``.  Ties go to the diagonal, then the left,
    then the up move (the first index, as ``jnp.argmin``)."""
    P, L = x.shape
    dev = x.device
    flat = dtw_full_table(c.expand(P, L), x, window).reshape(-1)
    rows = torch.arange(P, device=dev)

    def value(i, j):
        ok = (i >= 0) & (j >= 0)
        d = (i + j).clamp(0, 2 * L - 2)
        v = flat[(d * P + rows) * L + i.clamp(0, L - 1)]
        return torch.where(ok, v, torch.full_like(v, _INF))

    i = torch.full((P,), L - 1, dtype=torch.int64, device=dev)
    j = i.clone()
    done = torch.zeros(P, dtype=torch.bool, device=dev)
    i_cells, j_cells, active = [], [], []
    for _ in range(2 * L - 1):
        i_cells.append(i)
        j_cells.append(j)
        active.append(~done)
        v_diag = value(i - 1, j - 1)
        v_left = value(i, j - 1)
        v_up = value(i - 1, j)
        take_diag = (v_diag <= v_left) & (v_diag <= v_up)
        take_left = ~take_diag & (v_left <= v_up)
        ni = torch.where(take_left, i, i - 1)
        nj = torch.where(take_diag | take_left, j - 1, j)
        done = done | ((i == 0) & (j == 0))
        i = torch.where(done, torch.zeros_like(ni), ni)
        j = torch.where(done, torch.zeros_like(nj), nj)
    return (torch.stack(i_cells, 1), torch.stack(j_cells, 1),
            torch.stack(active, 1))


def dba_update(c: torch.Tensor, X: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               window: Optional[int] = None) -> torch.Tensor:
    """One DBA iteration: re-estimate barycenter ``c (L,)`` from
    ``X (N, L)``; points with a zero total count keep their value."""
    X = X.to(torch.float32)
    N, L = X.shape
    if weights is None:
        weights = torch.ones(N, dtype=torch.float32, device=X.device)
    i_cells, j_cells, active = alignment_path(c[None], X, window)
    w = active.to(torch.float32) * weights[:, None]
    vals = torch.gather(X, 1, j_cells) * w
    assoc = torch.zeros(L, dtype=torch.float32, device=X.device)
    count = torch.zeros(L, dtype=torch.float32, device=X.device)
    assoc.index_add_(0, i_cells.reshape(-1), vals.reshape(-1))
    count.index_add_(0, i_cells.reshape(-1), w.reshape(-1))
    return torch.where(count > 0, assoc / torch.clamp(count, min=1e-9), c)


def dba(c0: torch.Tensor, X: torch.Tensor, iters: int = 5,
        window: Optional[int] = None) -> torch.Tensor:
    """Run ``iters`` DBA iterations starting from ``c0 (L,)``.

    >>> X = torch.tensor([[0., 1., 2., 1.], [0., 2., 2., 0.]])
    >>> dba(X[0], X, iters=2).tolist()
    [0.0, 1.5, 2.0, 0.5]
    """
    c = torch.as_tensor(c0, dtype=torch.float32, device=X.device)
    for _ in range(iters):
        c = dba_update(c, X, None, window)
    return c
