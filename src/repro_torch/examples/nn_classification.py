"""1-NN time-series classification with PQ over any elastic measure
(paper §4.1), the port of ``examples/nn_classification.py``.

    python -m repro_torch.examples.nn_classification [--measure MEASURE] \\
        [--device cpu]

Compares symmetric PQ, asymmetric PQ, exact elastic 1-NN, and the
LB-pruned search baseline (with its pruning statistics) on a Trace-like
dataset.  ``--measure`` takes any registered measure ("dtw", "wdtw",
"erp", "msm", optionally with params: "erp:g=0.5"); measures without a
sound LB cascade use the exact dense search path.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device, to_tensor
from repro_torch.core import measures
from repro_torch.core.knn import (knn_classify_asym, knn_classify_sym,
                                  nn_dtw_exact, nn_dtw_pruned)
from repro_torch.core.pq import PQConfig, encode, fit
from repro_torch.data.timeseries import trace_like


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measure", default="dtw",
                    help="elastic measure: registry name, optionally with "
                         "params ('erp:g=0.5'); see repro_torch.core.measures")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = measures.resolve(args.measure)
    print(f"elastic measure: {spec.label} "
          f"(LB cascade: {'yes' if spec.can_prune else 'no — dense path'})")

    def sync():
        if dev.type == "cuda":
            # repro: ignore[RS101] the example's timing, off the hot path
            torch.cuda.synchronize(dev)

    Xtr, ytr = trace_like(n_per_class=15, length=128, seed=0)
    Xte, yte = trace_like(n_per_class=10, length=128, seed=7)
    Xtr_d, Xte_d = to_tensor(Xtr, dev, torch.float32), to_tensor(
        Xte, dev, torch.float32)
    window = int(0.1 * Xtr.shape[1])
    print(f"train {Xtr.shape}, test {Xte.shape}, classes "
          f"{len(np.unique(ytr))}, on {dev}")

    cfg = PQConfig(n_sub=4, codebook_size=min(32, len(Xtr)),
                   metric=spec.name, measure_params=spec.params,
                   use_prealign=True, kmeans_iters=5)
    t0 = time.time()
    cb = fit(Xtr_d, cfg, torch.Generator().manual_seed(0), device=dev)
    tr_codes = encode(Xtr_d, cb, cfg, device=dev)
    sync()
    print(f"PQ train+encode: {time.time() - t0:.2f}s (one-time)")

    runs = {}
    for name, fn in (
            ("PQ sym", lambda: knn_classify_sym(tr_codes, ytr, Xte_d, cb,
                                                cfg, device=dev)),
            ("PQ asym", lambda: knn_classify_asym(tr_codes, ytr, Xte_d, cb,
                                                  cfg, device=dev)),
            ("NN exact", lambda: nn_dtw_exact(Xtr_d, ytr, Xte_d, window,
                                              spec, device=dev))):
        t0 = time.time()
        pred = fn().cpu().numpy()
        runs[name] = (pred, time.time() - t0)

    t0 = time.time()
    pred, pruned = nn_dtw_pruned(Xtr_d, ytr, Xte_d, window, measure=spec,
                                 device=dev)
    runs["NN LB-pruned"] = (pred.cpu().numpy(), time.time() - t0)
    print(f"LB cascade pruned {pruned:.1%} of exact distance computations")

    print(f"\n{'method':20s} {'accuracy':>9s} {'seconds':>9s}")
    for name, (pred, sec) in runs.items():
        acc = float((pred == yte).mean())
        print(f"{name:20s} {acc:9.2%} {sec:9.3f}")


if __name__ == "__main__":
    main()
