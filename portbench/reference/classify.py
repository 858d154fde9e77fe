"""1-NN classification under symmetric PQDTW (paper, section 4.1), from
the benchmark's raw inputs: pre-align the training set, take the drawn
segments as centroids, build the LUT, encode both sets, and rank every
training series by its ADC distance."""

from __future__ import annotations

import torch

from . import pq
from .geometry import PQGeometry
from .prealign import prealign

__all__ = ["Classifier", "centroids_from"]


def centroids_from(segs: torch.Tensor, centroid_rows: torch.Tensor
                   ) -> torch.Tensor:
    """``segs (N, M, S)`` and ``centroid_rows (M, K)`` (training rows drawn
    from the seed) -> centroids ``(M, K, S)``: subspace ``m``'s segments of
    those rows."""
    return torch.stack([segs[centroid_rows[m], m]
                        for m in range(segs.shape[1])])


class Classifier:
    """The reference side of a classify cell, in ``dtype``."""

    def __init__(self, train: torch.Tensor, centroid_rows: torch.Tensor,
                 geo: PQGeometry, dtype: torch.dtype = torch.float32):
        self.geo, self.dtype = geo, dtype
        segs = self._segments(train)
        self.cb = pq.make_codebook(centroids_from(segs, centroid_rows),
                                   geo.window)
        self.table = pq.lut(self.cb)
        self.train_codes = pq.encode(segs, self.cb, geo.refine_t)

    def _segments(self, X: torch.Tensor) -> torch.Tensor:
        g = self.geo
        return prealign(X, g.M, g.level, g.tail, dtype=self.dtype)

    def distances(self, test: torch.Tensor) -> torch.Tensor:
        """ADC distances ``(N_test, N_train)`` of a test set."""
        codes = pq.encode(self._segments(test), self.cb, self.geo.refine_t)
        return pq.adc_sym(codes, self.train_codes, self.table)

    def nearest(self, test: torch.Tensor) -> torch.Tensor:
        """Index of each test series' nearest training series (the first
        among equal distances)."""
        return torch.argmin(self.distances(test), dim=1)
