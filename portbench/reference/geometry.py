"""Sizes a configuration derives from its settings (the paper's section 3
and 5 rules, as the configuration files state them)."""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["PQGeometry", "pq_geometry"]


class PQGeometry(NamedTuple):
    D: int          # series length
    M: int          # subspaces
    K: int          # centroids a subspace
    tail: int       # pre-alignment tail t
    S: int          # subsequence length D // M + t
    window: int     # Sakoe-Chiba half-width inside a subspace
    refine_t: int   # candidates refined by the encode's LB filter
    level: int      # MODWT level J


def pq_geometry(pq: dict, D: int) -> PQGeometry:
    """``pq`` holds ``n_sub``, ``codebook_size``, ``window_frac``,
    ``tail_frac``, ``refine_frac`` and ``wavelet_level``."""
    M, K = int(pq["n_sub"]), int(pq["codebook_size"])
    tail = max(1, int(round(pq["tail_frac"] * (D // M))))
    S = D // M + tail
    window = max(1, int(round(pq["window_frac"] * S)))
    refine_t = max(1, int(round(pq["refine_frac"] * K)))
    return PQGeometry(D, M, K, tail, S, window, refine_t,
                      int(pq["wavelet_level"]))
