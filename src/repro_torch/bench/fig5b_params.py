"""Fig 5b on the port: the effect of the subspace count M and the
codebook size K on PQDTW's encode and symmetric-distance times (the torch
leg of ``benchmarks/fig5b_params.py``, the same sweep and sizes).

Encoding is O(K D^2 / M): its time rises with K and falls with M; the
symmetric distance is O(M) a pair.  Medians of repeated calls, each
ending in a synchronize.  ``keep``, a list, receives each row's inputs
and outputs (a check holds them against the plain versions).

    python -m repro_torch.bench.fig5b_params [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from .. import _device
from ..core.pq import PQConfig, cdist_sym, encode, fit
from ..data.timeseries import random_walks
from ._writer import Bench, OUT_DIR, device_args, timeit

__all__ = ["run", "main"]


def run(quick: bool = False, device: _device.DeviceArg = None,
        out_dir: str = OUT_DIR, keep: Optional[list] = None) -> Bench:
    dev = _device.resolve_device(device)
    b = Bench("fig5b_params", dev, out_dir)
    D = 128 if quick else 512
    N = 60 if quick else 200
    X = _device.to_tensor(random_walks(N, D, seed=1), dev, torch.float32)
    subspaces = (2, 4, 8) if quick else (2, 4, 8, 16)
    codebooks = (16, 32, 64) if quick else (64, 128, 256)
    for M in subspaces:
        for K in codebooks:
            cfg = PQConfig(n_sub=M, codebook_size=min(K, N),
                           use_prealign=False, kmeans_iters=3, dba_iters=1)
            cb = fit(X, cfg, torch.Generator().manual_seed(0), device=dev)
            enc = timeit(lambda: encode(X, cb, cfg, device=dev), dev,
                         repeats=2)
            codes = enc["last"]
            sym = timeit(lambda: cdist_sym(codes, codes, cb.lut, device=dev),
                         dev, repeats=3)
            b.add(n_sub=M, codebook=K,
                  encode_s=enc["median_s"], sym_cdist_s=sym["median_s"],
                  encode_per_series_ms=1e3 * enc["median_s"] / N)
            if keep is not None:
                keep.append(dict(n_sub=M, codebook=K, X=X, cfg=cfg, cb=cb,
                                 codes=codes, sym=sym["last"]))
    b.save(headline={"quick": quick, "n": N, "length": D})
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
