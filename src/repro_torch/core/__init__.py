"""PQDTW core in PyTorch (counterpart of :mod:`repro.core`).

    dispatch    — elastic / ADC ops, routed by tensor device
    measures    — elastic-measure registry (dtw/wdtw/erp/msm)
    dtw         — batched anti-diagonal sweep (the kernels' plain version)
    lb          — Keogh envelopes + lower bounds
    modwt       — MODWT pre-alignment (§3.5)
    dba/kmeans  — DBA barycenters and DBA k-means codebook learning
    pq          — PQConfig / fit / encode / symmetric & asymmetric distances
    knn         — 1-NN with PQ approximates + exact elastic 1-NN
    metrics     — error rate, Rand index
"""

from .dispatch import (adc_cdist, adc_lookup, effective_window,
                       elastic_cdist, elastic_pairwise, prealign_encode)
from .knn import knn_classify_asym, knn_classify_sym, nn_dtw_exact
from .measures import MeasureSpec, get_measure, register_measure
from .metrics import error_rate, rand_index
from .pq import (PQCodebook, PQConfig, cdist_asym, cdist_sym,
                 codebook_from_numpy, codebook_to_numpy, encode,
                 encode_with_stats, fit, memory_cost, query_lut_batch,
                 segment, uses_fused_prealign)

__all__ = [
    "PQConfig", "PQCodebook", "fit", "encode", "encode_with_stats",
    "cdist_sym", "cdist_asym", "query_lut_batch", "segment", "memory_cost",
    "uses_fused_prealign", "codebook_from_numpy", "codebook_to_numpy",
    "elastic_pairwise", "elastic_cdist", "adc_cdist", "adc_lookup",
    "prealign_encode", "effective_window", "MeasureSpec", "get_measure",
    "register_measure", "knn_classify_sym", "knn_classify_asym",
    "nn_dtw_exact", "error_rate", "rand_index",
]
