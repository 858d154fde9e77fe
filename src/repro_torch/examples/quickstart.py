"""Quickstart: the PQDTW public API of the port in ~60 lines (the port of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]

Trains a product quantizer under DTW on a small synthetic collection,
encodes it, and compares symmetric / asymmetric / exact distances.
"""

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device, to_tensor
from repro_torch.core.dispatch import elastic_cdist
from repro_torch.core.measures import sqrt_rn
from repro_torch.core.pq import (PQConfig, cdist_asym, cdist_sym, encode,
                                 fit, memory_cost)
from repro_torch.data.timeseries import cbf


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- data: 60 Cylinder-Bell-Funnel series, length 128 ------------------
    X, y = cbf(n_per_class=20, length=128, seed=0)
    Xd = to_tensor(X, dev, torch.float32)
    N, D = X.shape
    print(f"dataset: {N} series of length {D} on {dev}")

    # --- train the quantizer (Algorithm 1) ---------------------------------
    cfg = PQConfig(n_sub=4,            # M subspaces
                   codebook_size=32,   # K centroids per subspace
                   window_frac=0.1,    # Sakoe-Chiba band inside subspaces
                   use_prealign=True)  # MODWT pre-alignment (paper §3.5)
    cb = fit(Xd, cfg, torch.Generator().manual_seed(0), device=dev)
    print(f"codebook: M={cb.n_sub} K={cb.codebook_size} "
          f"subseq_len={cb.subseq_len}")

    # --- encode (Algorithm 2: LB-filtered DTW-1NN per subspace) ------------
    codes = encode(Xd, cb, cfg, device=dev)
    print(f"codes: {tuple(codes.shape)} {codes.dtype} "
          f"(was {N}x{D} float32)")

    mem = memory_cost(cfg, D, N)
    print(f"compression: {mem['compression']:.1f}x "
          f"(+{mem['aux_bytes'] / 1e6:.2f}MB one-time auxiliaries)")

    # --- distances (§3.3) ---------------------------------------------------
    d_sym = cdist_sym(codes, codes, cb.lut, device=dev)  # M gathers a pair
    d_asym = cdist_asym(Xd, codes, cb, cfg, device=dev)  # a LUT per query
    d_true = sqrt_rn(elastic_cdist(Xd, Xd, cfg.window(D)))

    off = ~torch.eye(N, dtype=torch.bool, device=dev)
    for name, d in (("symmetric", d_sym), ("asymmetric", d_asym)):
        err = (d - d_true).abs()[off]
        corr = np.corrcoef(d[off].cpu().numpy(),
                           d_true[off].cpu().numpy())[0, 1]
        print(f"{name:10s} vs exact DTW: mean |err| = {float(err.mean()):.3f},"
              f" corr = {corr:.3f}")

    # --- 1-NN sanity ---------------------------------------------------------
    nn = torch.argsort(d_sym, dim=1, stable=True)[:, 1].cpu().numpy()
    acc = float((y[nn] == y).mean())
    print(f"leave-one-out 1NN accuracy with symmetric PQDTW: {acc:.2%}")


if __name__ == "__main__":
    main()
