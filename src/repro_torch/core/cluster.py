"""Agglomerative hierarchical clustering (§4.2) from a distance matrix
(numpy copy of :mod:`repro.core.cluster`).

Lance-Williams agglomeration with single / complete / average linkage.
The merge loop is sequential and tiny next to the distance matrix, which
is the part the card computes, so it runs on the host: a tensor is
brought there first.  On the same matrix the linkage and the labels are
the reference's bit for bit.

>>> d = [[0, 1, 4, 5], [1, 0, 3, 4], [4, 3, 0, 1], [5, 4, 1, 0]]
>>> hierarchical_labels(d, 2).tolist()
[0, 0, 1, 1]
"""

from __future__ import annotations

import numpy as np

from .._device import to_host as _host

__all__ = ["linkage", "cut_k", "hierarchical_labels"]

_LW = {
    "single": lambda da, db, na, nb: np.minimum(da, db),
    "complete": lambda da, db, na, nb: np.maximum(da, db),
    "average": lambda da, db, na, nb: (na * da + nb * db) / (na + nb),
}


def linkage(dist, method: str = "complete") -> np.ndarray:
    """SciPy-compatible linkage matrix ``(N-1, 4)`` from a square distance
    matrix (values: merged id a, id b, merge distance, new cluster size)."""
    d = np.array(_host(dist), np.float64, copy=True)
    n = d.shape[0]
    np.fill_diagonal(d, np.inf)
    update = _LW[method]
    size = np.ones(n)
    cid = np.arange(n)          # current cluster id per active row
    active = np.ones(n, bool)
    Z = np.zeros((n - 1, 4))
    next_id = n
    for t in range(n - 1):
        masked = np.where(active[:, None] & active[None, :], d, np.inf)
        i, j = np.unravel_index(np.argmin(masked), masked.shape)
        if i > j:
            i, j = j, i
        Z[t] = (min(cid[i], cid[j]), max(cid[i], cid[j]), masked[i, j],
                size[i] + size[j])
        # merge j into i via Lance-Williams
        d[i, :] = update(d[i, :], d[j, :], size[i], size[j])
        d[:, i] = d[i, :]
        d[i, i] = np.inf
        active[j] = False
        size[i] += size[j]
        cid[i] = next_id
        next_id += 1
    return Z


def cut_k(Z: np.ndarray, n: int, k: int) -> np.ndarray:
    """Cut the dendrogram at the minimum height producing ``k`` clusters."""
    parent = np.arange(n + len(Z))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    # apply merges in order until k clusters remain
    merges = len(Z) - (k - 1) if k >= 1 else len(Z)
    for t in range(max(0, merges)):
        a, b = int(Z[t, 0]), int(Z[t, 1])
        ra, rb = find(a), find(b)
        parent[ra] = n + t
        parent[rb] = n + t
    roots = np.array([find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def hierarchical_labels(dist, k: int,
                        method: str = "complete") -> np.ndarray:
    """Distance matrix -> flat cluster labels with ``k`` clusters."""
    dist = _host(dist)
    n = dist.shape[0]
    if k >= n:
        return np.arange(n)
    return cut_k(linkage(dist, method), n, k)
