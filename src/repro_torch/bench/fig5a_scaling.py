"""Fig 5a on the port: pairwise-distance-matrix runtime of PQDTW against
banded DTW on random walks, sweeping series length and collection size
(the torch leg of ``benchmarks/fig5a_scaling.py``).

The same protocol and sizes as the reference: the DTW matrix is
:func:`repro_torch.core.dispatch.elastic_cdist` (on the card the
``dtw_band_cdist`` kernel) at the PQ configuration's subspace window; the
PQDTW matrix is :func:`repro_torch.core.pq.cdist_sym` (the ``adc_sym``
kernel) after a timed fit + encode, reported beside it and amortized over
the collection.  Medians of repeated calls, each ending in a synchronize.
``keep``, a list, receives each row's inputs and outputs (a check holds
them against the plain versions).

    python -m repro_torch.bench.fig5a_scaling [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from .. import _device
from ..core.dispatch import elastic_cdist
from ..core.pq import PQConfig, cdist_sym, encode, fit
from ..data.timeseries import random_walks
from ._writer import Bench, OUT_DIR, device_args, sync, timeit

__all__ = ["run", "main"]


def run(quick: bool = False, device: _device.DeviceArg = None,
        out_dir: str = OUT_DIR, keep: Optional[list] = None) -> Bench:
    dev = _device.resolve_device(device)
    b = Bench("fig5a_scaling", dev, out_dir)
    lengths = (64, 128, 256) if quick else (128, 256, 512, 1024)
    counts = (40, 80) if quick else (100, 200, 400)
    for D in lengths:
        for N in counts:
            X = _device.to_tensor(random_walks(N, D, seed=0), dev,
                                  torch.float32)
            cfg = PQConfig(n_sub=max(2, round(1 / 0.2)),
                           codebook_size=min(64, N), use_prealign=False,
                           kmeans_iters=4, dba_iters=1)
            window = cfg.window(D)
            t0 = timeit(lambda: elastic_cdist(X, X, window), dev, repeats=2)
            sync(dev)
            t1 = time.perf_counter()
            cb = fit(X, cfg, torch.Generator().manual_seed(0), device=dev)
            codes = encode(X, cb, cfg, device=dev)
            sync(dev)
            train_s = time.perf_counter() - t1
            t2 = timeit(lambda: cdist_sym(codes, codes, cb.lut, device=dev),
                        dev, repeats=3)
            b.add(length=D, n_series=N,
                  dtw_s=t0["median_s"], pqdtw_s=t2["median_s"],
                  pq_train_encode_s=train_s,
                  speedup=t0["median_s"] / max(t2["median_s"], 1e-9),
                  speedup_amortized=t0["median_s"]
                  / max(t2["median_s"] + train_s / max(N, 1), 1e-9))
            if keep is not None:
                keep.append(dict(length=D, n_series=N, X=X, window=window,
                                 cfg=cfg, cb=cb, codes=codes,
                                 dtw=t0["last"], sym=t2["last"]))
    b.save(headline={"quick": quick})
    return b


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the reference's quick sizes")
    device_args(ap)
    args = ap.parse_args(argv)
    run(args.quick, args.device, args.out)


if __name__ == "__main__":
    main()
