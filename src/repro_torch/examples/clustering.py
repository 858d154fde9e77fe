"""Hierarchical clustering with PQDTW distances (paper §4.2), the port of
``examples/clustering.py``.

    python -m repro_torch.examples.clustering [--device cpu]

Builds the pairwise matrix three ways — exact DTW, plain symmetric PQDTW,
and the §4.2 LB-refined symmetric PQDTW (identical codes replaced by the
Keogh lower bound so rankings stay informative) — and compares Rand indices
of the complete-linkage clustering.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device, to_tensor
from repro_torch.core.cluster import hierarchical_labels
from repro_torch.core.dispatch import elastic_cdist
from repro_torch.core.measures import sqrt_rn
from repro_torch.core.metrics import adjusted_rand_index, rand_index
from repro_torch.core.pq import (PQConfig, cdist_sym, cdist_sym_refined,
                                 encode, fit, segment)
from repro_torch.data.timeseries import cbf


def _timed(fn):
    t0 = time.time()
    out = fn().cpu().numpy()     # to the host: waits for the card
    return out, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    X, y = cbf(n_per_class=15, length=128, seed=3)
    Xd = to_tensor(X, dev, torch.float32)
    k = len(np.unique(y))
    window = int(0.1 * X.shape[1])
    print(f"{X.shape[0]} series, {k} classes, on {dev}")

    cfg = PQConfig(n_sub=4, codebook_size=16, use_prealign=True,
                   kmeans_iters=5)
    cb = fit(Xd, cfg, torch.Generator().manual_seed(0), device=dev)
    codes = encode(Xd, cb, cfg, device=dev)
    segs = segment(Xd, cfg)

    d_exact, t_exact = _timed(
        lambda: sqrt_rn(elastic_cdist(Xd, Xd, window)))
    d_sym, t_sym = _timed(lambda: cdist_sym(codes, codes, cb.lut,
                                            device=dev))
    d_ref, t_ref = _timed(lambda: cdist_sym_refined(codes, segs, codes, segs,
                                                    cb, device=dev))

    print(f"\n{'distance':24s} {'RI':>7s} {'ARI':>7s} {'seconds':>8s}")
    for name, d, sec in (("exact DTW", d_exact, t_exact),
                         ("PQDTW symmetric", d_sym, t_sym),
                         ("PQDTW sym + LB refine", d_ref, t_ref)):
        labels = hierarchical_labels(d, k, method="complete")
        print(f"{name:24s} {rand_index(y, labels):7.3f} "
              f"{adjusted_rand_index(y, labels):7.3f} {sec:8.3f}")

    same_code = (d_sym == 0).mean()
    print(f"\nzero symmetric distances (identical codes): {same_code:.1%} "
          "of pairs -> refined by the Keogh lower bound")


if __name__ == "__main__":
    main()
