"""PQDTW core in PyTorch (counterpart of :mod:`repro.core`).

    dispatch    — elastic / ADC ops, routed by tensor device
    measures    — elastic-measure registry (dtw/wdtw/erp/msm)
    dtw         — batched anti-diagonal sweep (the kernels' plain version)
    lb          — Keogh envelopes + lower bounds
    lb_search   — batched LB-cascade filter-and-refine top-k search
    modwt       — MODWT pre-alignment (§3.5)
    dba/kmeans  — DBA barycenters and DBA k-means codebook learning
    pq          — PQConfig / fit / encode / symmetric & asymmetric distances
    knn         — 1-NN with PQ approximates + exact elastic 1-NN
    cluster     — agglomerative hierarchical clustering
    baselines   — ED / cDTW / SBD / SAX comparators
    metrics     — error rate, Rand index, adjusted Rand index

The reference's backend switch (``get_backend`` / ``set_backend`` /
``use_backend``) has no counterpart: the route follows the tensors'
device.
"""

from .baselines import (GAUSS_BREAKPOINTS, cdtw_cdist, ed_cdist, sbd_cdist,
                        sax_mindist_cdist, sax_transform)
from .cluster import cut_k, hierarchical_labels, linkage
from .dba import alignment_path, dba, dba_update
from .dispatch import (adc_cdist, adc_lookup, effective_window,
                       elastic_cdist, elastic_pairwise, lb_refine,
                       prealign_encode)
from .dtw import dtw_batch, dtw_cdist, dtw_pair
from .kmeans import dba_kmeans, euclidean_kmeans
from .knn import (knn_classify_asym, knn_classify_sym, nn_dtw_exact,
                  nn_dtw_pruned)
from .lb import keogh_envelope, lb_cascade, lb_keogh, lb_kim, lb_lut
from .lb_search import filtered_topk
from .measures import (MeasureSpec, available as available_measures,
                       get_measure, register_measure, registry_rows,
                       resolve as resolve_measure)
from .metrics import adjusted_rand_index, error_rate, rand_index
from .modwt import fixed_segments, modwt_scale, prealign
from .pq import (PQCodebook, PQConfig, cdist_asym, cdist_sym,
                 cdist_sym_refined, codebook_from_numpy, codebook_to_numpy,
                 encode, encode_with_stats, fit, memory_cost, query_lut,
                 query_lut_batch, segment, uses_fused_prealign)

__all__ = [
    "PQConfig", "PQCodebook", "fit", "encode", "encode_with_stats",
    "cdist_sym", "cdist_asym", "cdist_sym_refined", "segment", "memory_cost",
    "query_lut", "query_lut_batch", "uses_fused_prealign",
    "codebook_from_numpy", "codebook_to_numpy",
    "dtw_pair", "dtw_batch", "dtw_cdist",
    "elastic_pairwise", "elastic_cdist", "adc_cdist", "adc_lookup",
    "prealign_encode", "lb_refine", "effective_window",
    "MeasureSpec", "register_measure", "get_measure", "resolve_measure",
    "available_measures", "registry_rows",
    "keogh_envelope", "lb_keogh", "lb_kim", "lb_cascade", "lb_lut",
    "filtered_topk",
    "prealign", "fixed_segments", "modwt_scale",
    "dba", "dba_update", "alignment_path",
    "dba_kmeans", "euclidean_kmeans",
    "knn_classify_sym", "knn_classify_asym", "nn_dtw_exact", "nn_dtw_pruned",
    "linkage", "cut_k", "hierarchical_labels",
    "ed_cdist", "cdtw_cdist", "sbd_cdist", "sax_transform",
    "sax_mindist_cdist", "GAUSS_BREAKPOINTS",
    "rand_index", "adjusted_rand_index", "error_rate",
]
