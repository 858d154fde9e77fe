"""Fig 5c on the port: the cost of the MODWT pre-alignment, and the
encode-path sweep (the torch leg of ``benchmarks/fig5c_prealign.py``, the
same sweeps and sizes).

Segmentation: fixed splits against ``modwt.prealign`` at wavelet levels J
and tail fractions t.  Encode paths, each an exact full-scan encode so
that the work compared is the same:

    no_prealign   fixed segments + exact encode (the paper's ablation)
    two_step      modwt.prealign -> segment tensor -> exact encode
    fused         one prealign_encode launch: MODWT, snap,
                  re-interpolation and the elastic 1-NN scan

The reference sweeps two dispatch backends (``jax`` and
``pallas_interpret``); the port has one route a device, so each row names
it (``cuda``: the hand-written kernels; ``torch``: their plain versions).
Medians of repeated calls, each ending in a synchronize.  ``keep``, a
list, receives each encode row's inputs and codes (a check holds them
against the plain versions).

    python -m repro_torch.bench.fig5c_prealign [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from .. import _device
from ..core.modwt import fixed_segments, prealign
from ..core.pq import PQConfig, encode, fit, uses_fused_prealign
from ..data.timeseries import trace_like
from ._writer import Bench, OUT_DIR, device_args, timeit

__all__ = ["run", "main"]


def run(quick: bool = False, device: _device.DeviceArg = None,
        out_dir: str = OUT_DIR, keep: Optional[list] = None) -> Bench:
    dev = _device.resolve_device(device)
    route = "cuda" if dev.type == "cuda" else "torch"
    b = Bench("fig5c_prealign", dev, out_dir)
    n = 30 if quick else 100
    length = 128 if quick else 256
    X, _ = trace_like(n, length=length, seed=0)
    X = _device.to_tensor(X, dev, torch.float32)
    D = X.shape[1]
    M = 4

    # -- segmentation-only sweep (paper fig 5c) -----------------------------
    base = timeit(lambda: fixed_segments(X, M), dev, repeats=3)
    b.add(mode="fixed", level=0, tail_frac=0.0,
          segment_s=base["median_s"], overhead=1.0)
    for J in ((1, 2, 3) if quick else (1, 2, 3, 4, 5)):
        for tail_frac in (0.1, 0.2):
            tail = max(1, int(round(tail_frac * (D // M))))
            t = timeit(lambda: prealign(X, M, J, tail), dev, repeats=3)
            b.add(mode="modwt", level=J, tail_frac=tail_frac,
                  segment_s=t["median_s"],
                  overhead=t["median_s"] / max(base["median_s"], 1e-9))

    # -- encode-path sweep: no-prealign vs two-step vs fused ----------------
    K = min(32, X.shape[0])
    base_cfg = PQConfig(n_sub=M, codebook_size=K, kmeans_iters=3,
                        dba_iters=1, exact_encode=True)
    cfgs = {
        "no_prealign": dataclasses.replace(base_cfg, use_prealign=False),
        "two_step": dataclasses.replace(base_cfg, fused_encode=False),
        "fused": base_cfg,
    }
    assert uses_fused_prealign(cfgs["fused"])
    books = {}   # one codebook per segmentation geometry
    for name, cfg in cfgs.items():
        geom = cfg.subseq_len(D)
        if geom not in books:
            books[geom] = fit(X, cfg, torch.Generator().manual_seed(0),
                              device=dev)
        cb = books[geom]
        t = timeit(lambda: encode(X, cb, cfg, device=dev), dev, repeats=2)
        b.add(mode=f"encode_{name}", route=route,
              level=cfg.wavelet_level, tail=cfg.tail(D),
              encode_s=t["median_s"],
              per_series_us=t["median_s"] / X.shape[0] * 1e6)
        if keep is not None:
            keep.append(dict(mode=name, X=X, cfg=cfg, cb=cb,
                             codes=t["last"]))
    b.save(headline={"quick": quick, "n": int(X.shape[0]), "length": int(D)})
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
