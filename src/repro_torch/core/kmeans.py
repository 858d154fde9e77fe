"""DBA k-means, the codebook learner (counterpart of
:mod:`repro.core.kmeans`).

Assignment runs through :func:`.dispatch.elastic_cdist` (the all-pairs
kernel on the card) under any registered measure; the update runs DBA
iterations in which each series contributes only to its assigned
centroid (a scatter-add by cluster id).  The DBA update always averages
along DTW paths.  A Euclidean variant backs the PQ_ED baseline.

Randomness: the reference draws its initial centroids with
``jax.random.choice``, whose bits PyTorch cannot reproduce.  Both
learners take the initial centroids ``init (K, L)`` explicitly or draw
them with a ``torch.Generator``.

On the card the scatter-add sums in a nondeterministic order, so two
fits can differ by ulps; compare results of one fit, never of two.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .dba import alignment_path
from .dispatch import elastic_cdist
from .dtw import euclidean_sq
from .measures import MeasureArg

__all__ = ["KMeansResult", "init_centroids", "dba_kmeans",
           "euclidean_kmeans"]


class KMeansResult(NamedTuple):
    centroids: torch.Tensor   # (K, L)
    assignment: torch.Tensor  # (N,)
    inertia: torch.Tensor     # scalar: sum of within-cluster costs


def init_centroids(X: torch.Tensor, k: int,
                   generator: torch.Generator) -> torch.Tensor:
    """``k`` rows of ``X`` drawn without replacement (with replacement
    when ``X`` has fewer than ``k`` rows)."""
    n = X.shape[0]
    if n >= k:
        idx = torch.randperm(n, generator=generator)[:k]
    else:
        idx = torch.randint(n, (k,), generator=generator)
    return X[idx.to(X.device)].clone()


def _start(X: torch.Tensor, k: int, init: Optional[torch.Tensor],
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if init is not None:
        init = torch.as_tensor(init, dtype=torch.float32, device=X.device)
        if init.shape != (k, X.shape[1]):
            raise ValueError(f"init must be ({k}, {X.shape[1]}), got "
                             f"{tuple(init.shape)}")
        return init.clone()
    if generator is None:
        raise ValueError("pass the initial centroids (init=) or a "
                         "torch.Generator (generator=)")
    return init_centroids(X, k, generator)


def _dba_assigned_update(C: torch.Tensor, X: torch.Tensor,
                         assign: torch.Tensor,
                         window: Optional[int]) -> torch.Tensor:
    """Scatter-add DBA update: every series aligns to its own centroid."""
    K, L = C.shape
    i_cells, j_cells, active = alignment_path(C[assign], X, window)
    w = active.to(torch.float32)
    vals = torch.gather(X, 1, j_cells) * w
    flat = (assign[:, None] * L + i_cells).reshape(-1)
    assoc = torch.zeros(K * L, dtype=torch.float32, device=X.device)
    count = torch.zeros(K * L, dtype=torch.float32, device=X.device)
    assoc.index_add_(0, flat, vals.reshape(-1))
    count.index_add_(0, flat, w.reshape(-1))
    assoc, count = assoc.view(K, L), count.view(K, L)
    return torch.where(count > 0, assoc / torch.clamp(count, min=1e-9), C)


def dba_kmeans(X: torch.Tensor, k: int, iters: int = 10, dba_iters: int = 2,
               window: Optional[int] = None, measure: MeasureArg = None, *,
               init: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> KMeansResult:
    """DBA k-means over ``X (N, L)`` with ``k`` clusters."""
    X = X.to(torch.float32).contiguous()
    C = _start(X, k, init, generator)
    for _ in range(iters):
        assign = torch.argmin(elastic_cdist(X, C, window, measure=measure),
                              dim=1)
        for _ in range(dba_iters):
            C = _dba_assigned_update(C, X, assign, window)
    d = elastic_cdist(X, C, window, measure=measure)
    assign = torch.argmin(d, dim=1)
    return KMeansResult(C, assign, d.min(dim=1).values.sum())


def euclidean_kmeans(X: torch.Tensor, k: int, iters: int = 20, *,
                     init: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> KMeansResult:
    """Plain Lloyd k-means (squared Euclidean) for the PQ_ED baseline."""
    X = X.to(torch.float32).contiguous()
    C = _start(X, k, init, generator)
    assign = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    d = euclidean_sq(X, C)
    for _ in range(iters):
        d = euclidean_sq(X, C)
        assign = torch.argmin(d, dim=1)
        oh = torch.nn.functional.one_hot(assign, k).to(torch.float32)
        count = oh.sum(0)[:, None]
        mean = (oh.T @ X) / torch.clamp(count, min=1e-9)
        C = torch.where(count > 0, mean, C)
    return KMeansResult(C, assign, d.min(dim=1).values.sum())
