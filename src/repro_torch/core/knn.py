"""1-NN classification with PQ approximates (§4.1), exact elastic 1-NN and
its LB-cascade pruned form (counterpart of :mod:`repro.core.knn`).  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; labels come back as a tensor
on that device."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _device
from ..obs import span
from .dispatch import elastic_cdist
from .lb_search import filtered_topk
from .measures import MeasureArg
from .pq import PQCodebook, PQConfig, cdist_asym, cdist_sym, encode

__all__ = ["knn_classify_sym", "knn_classify_asym", "nn_dtw_exact",
           "nn_dtw_pruned"]


def _labels(labels, dev: torch.device) -> torch.Tensor:
    return _device.to_tensor(labels, dev, torch.int64)


def knn_classify_sym(train_codes, train_labels, Q, cb: PQCodebook,
                     cfg: PQConfig, *,
                     device: _device.DeviceArg = None) -> torch.Tensor:
    """Symmetric 1-NN: encode the queries, then M LUT gathers per pair.
    The call is the ``classify.sym`` span, around ``pq.encode``,
    ``pq.adc`` and ``classify.nearest`` (the argmin and label gather)."""
    with span("classify.sym"):
        dev = _device.resolve_device(device)
        q_codes = encode(Q, cb, cfg, device=dev)
        with span("pq.adc"):
            d = cdist_sym(q_codes, train_codes, cb.lut, device=dev)
        with span("classify.nearest"):
            return _labels(train_labels, dev)[torch.argmin(d, dim=1)]


def knn_classify_asym(train_codes, train_labels, Q, cb: PQCodebook,
                      cfg: PQConfig, *,
                      device: _device.DeviceArg = None) -> torch.Tensor:
    """Asymmetric 1-NN: one M x K elastic table per query, then gathers."""
    dev = _device.resolve_device(device)
    d = cdist_asym(Q, train_codes, cb, cfg, device=dev)
    return _labels(train_labels, dev)[torch.argmin(d, dim=1)]


def nn_dtw_exact(X, labels, Q, window: Optional[int] = None,
                 measure: MeasureArg = None, *,
                 device: _device.DeviceArg = None) -> torch.Tensor:
    """Exact (banded) elastic 1-NN — the accuracy reference."""
    dev = _device.resolve_device(device)
    d = elastic_cdist(_device.to_tensor(Q, dev, torch.float32),
                      _device.to_tensor(X, dev, torch.float32), window,
                      measure=measure)
    return _labels(labels, dev)[torch.argmin(d, dim=1)]


def nn_dtw_pruned(X, labels, Q, window: Optional[int] = None, *,
                  budget: Optional[int] = None, measure: MeasureArg = None,
                  device: _device.DeviceArg = None
                  ) -> Tuple[torch.Tensor, float]:
    """LB-cascade filter-and-refine elastic 1-NN through
    :func:`repro_torch.core.lb_search.filtered_topk`: the same predictions
    as :func:`nn_dtw_exact`.  Returns ``(predictions, pruned)``, the labels
    as a tensor on the device and the fraction of (query, candidate) pairs
    the cascade excluded from exact refinement."""
    dev = _device.resolve_device(device)
    X = _device.to_tensor(X, dev, torch.float32)
    Q = _device.to_tensor(Q, dev, torch.float32)
    _, idx, n_dtw = filtered_topk(Q, X, window, 1, budget=budget,
                                  measure=measure)
    preds = _labels(labels, dev)[idx[:, 0].long()]
    pruned = 1.0 - int(n_dtw) / float(Q.shape[0] * X.shape[0])
    return preds, pruned
