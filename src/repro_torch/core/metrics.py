"""Evaluation metrics: Rand index and error rate (numpy, as
:mod:`repro.core.metrics`; tensors are brought to the host first)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rand_index", "error_rate"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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


def error_rate(y_true, y_pred) -> float:
    return float(np.mean(_host(y_true) != _host(y_pred)))
