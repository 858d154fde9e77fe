"""Evaluation metrics: Rand index, adjusted Rand index and error rate
(numpy, as :mod:`repro.core.metrics`; tensors are brought to the host
first)."""

from __future__ import annotations

import numpy as np

from .._device import to_host as _host

__all__ = ["rand_index", "adjusted_rand_index", "error_rate"]


def _contingency(a, b) -> np.ndarray:
    ua, ia = np.unique(_host(a), return_inverse=True)
    ub, ib = np.unique(_host(b), return_inverse=True)
    c = np.zeros((len(ua), len(ub)), np.int64)
    np.add.at(c, (ia, ib), 1)
    return c


def rand_index(labels_true, labels_pred) -> float:
    """Rand (1971) index: fraction of concordant pairs."""
    c = _contingency(labels_true, labels_pred)
    n = c.sum()
    sum_sq = (c.astype(np.float64) ** 2).sum()
    sum_a = (c.sum(1).astype(np.float64) ** 2).sum()
    sum_b = (c.sum(0).astype(np.float64) ** 2).sum()
    agreements = n * (n - 1) / 2 + sum_sq - 0.5 * (sum_a + sum_b)
    return float(agreements / (n * (n - 1) / 2))


def adjusted_rand_index(labels_true, labels_pred) -> float:
    """Hubert-Arabie adjusted Rand index (1.0 where the expected and the
    largest index coincide, e.g. one cluster on each side)."""
    c = _contingency(labels_true, labels_pred).astype(np.float64)
    n = c.sum()
    comb = lambda x: x * (x - 1) / 2.0
    sum_ij = comb(c).sum()
    sum_a = comb(c.sum(1)).sum()
    sum_b = comb(c.sum(0)).sum()
    expected = sum_a * sum_b / comb(n)
    max_idx = 0.5 * (sum_a + sum_b)
    if max_idx == expected:
        return 1.0
    return float((sum_ij - expected) / (max_idx - expected))


def error_rate(y_true, y_pred) -> float:
    return float(np.mean(_host(y_true) != _host(y_pred)))
