"""Table 1 on the port: PQDTW against the baseline distance measures, by
1-NN classification error, the hierarchical-clustering Rand index and
runtime speedups (the torch leg of ``benchmarks/table1_accuracy.py``).

The same grid, configurations, data and rows as the reference: the
class-structured synthetic surrogates of CBF, Trace and GunPoint from
:func:`repro_torch.data.timeseries.make_dataset`; the measures ED, DTW
(full, ``cdtw_cdist(., ., None)``), cDTW5 / cDTW10, SBD, SAX, PQ_ED and
PQDTW (symmetric for 1-NN, the §4.2 LB-refined symmetric distance for
clustering).  For each baseline a row gives its error and Rand-index
difference against PQDTW and the speedup of the PQDTW distance phase:
the mean over runs, as the reference reports it (nothing is warmed up
first, so a run's first call of a library routine carries its set-up,
such as cuFFT's plan for SBD), and beside it the median over runs.

Initial centroids: both PQ fits start from the training segments at the
indices the reference's ``fit(jax.random.PRNGKey(seed), ...)`` draws
(``jax.random.choice(split(key, M)[m], n, (k,), replace=n < k)``), read
from ``table1_init.json`` beside this file (the port never draws them
through JAX; ``tests/test_torch_table1.py`` regenerates and checks them).
With the same initial centroids the errors and Rand indices are meant to
equal the reference's on the same data, up to decisions between two
candidates within :data:`TIE_REL` of each other (:func:`compare_runs`).

    python -m repro_torch.bench.table1_accuracy [--quick] [--device cpu]

The default is the reference's full grid (40 series a class, L = 192,
seeds 0-4); ``--quick`` its quick grid (12 a class, L = 96, seeds 0-1).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import _device
from ..core.baselines import (cdtw_cdist, ed_cdist, sax_mindist_cdist,
                              sax_transform, sbd_cdist)
from ..core.cluster import hierarchical_labels, linkage
from ..core.metrics import error_rate, rand_index
from ..core.pq import (PQConfig, cdist_sym, cdist_sym_refined, encode, fit,
                       segment)
from ..data.timeseries import make_dataset
from ._writer import Bench, OUT_DIR, device_args, sync

__all__ = ["DATASETS", "MEASURES", "TIE_REL", "INIT_PATH", "grid",
           "pq_configs", "load_init", "init_centroids", "one_run", "run",
           "compare_runs", "ed_close", "sq_close", "main"]

DATASETS = ("cbf", "trace", "gunpoint")
# the row order of the reference's table
MEASURES = ("PQDTW", "ED", "DTW", "cDTW5", "cDTW10", "SBD", "SAX", "PQ_ED")
# two candidates of a decision (an argmin, a merge) this close (relative)
# may fall either way between two summation orders
TIE_REL = 1e-5
INIT_PATH = os.path.join(os.path.dirname(__file__), "table1_init.json")


def grid(quick: bool) -> dict:
    """The reference's grid: quick or full."""
    if quick:
        return dict(n_per_class=12, length=96, seeds=(0, 1))
    return dict(n_per_class=40, length=192, seeds=(0, 1, 2, 3, 4))


def pq_configs(n_train: int):
    """The reference's PQDTW and PQ_ED configurations for ``n_train``
    training series."""
    k = min(48, n_train)
    pq_cfg = PQConfig(n_sub=5, codebook_size=k, window_frac=0.1,
                      use_prealign=True, kmeans_iters=4, dba_iters=1)
    pq_ed_cfg = PQConfig(n_sub=5, codebook_size=k, metric="euclidean",
                         use_prealign=False, kmeans_iters=6)
    return pq_cfg, pq_ed_cfg


def load_init(path: str = INIT_PATH) -> dict:
    """The initial-centroid indices, keyed ``"<dataset>/<n>/<seed>"``, each
    ``(M, k)``."""
    with open(path) as f:
        return json.load(f)["indices"]


def init_centroids(table: dict, dataset: str, seed: int,
                   segs: torch.Tensor, k: int) -> torch.Tensor:
    """``segs (n, M, S)`` rows at the reference's indices -> ``(M, k, S)``."""
    n, M, _ = segs.shape
    key = f"{dataset}/{n}/{seed}"
    if key not in table:
        raise KeyError(f"no initial centroids for {key} in {INIT_PATH}")
    idx = torch.as_tensor(np.asarray(table[key]), dtype=torch.int64,
                          device=segs.device)
    if tuple(idx.shape) != (M, k):
        raise ValueError(f"{key}: indices {tuple(idx.shape)}, want {(M, k)}")
    return torch.stack([segs[idx[m], m] for m in range(M)])


def _fetch(fn, dev: torch.device):
    """``fn()``'s result on the host and the seconds to get it there."""
    sync(dev)
    t0 = time.perf_counter()
    d = _device.to_host(fn())
    return d, time.perf_counter() - t0


def one_run(dataset: str, seed: int, n_per_class: int, length: int,
            device: _device.DeviceArg = None, table: Optional[dict] = None,
            books=None) -> dict:
    """One (dataset, seed) of the table: every measure's test-by-train and
    test-by-test matrices (numpy), 1-NN error, Rand index and seconds, and
    the codes.  ``books=(cb, cb_ed)`` skips both fits and uses those
    codebooks (a check runs the CPU route on the card's codebooks)."""
    dev = _device.resolve_device(device)
    table = load_init() if table is None and books is None else table
    Xtr, ytr = make_dataset(dataset, n_per_class, length, seed=seed)
    Xte, yte = make_dataset(dataset, n_per_class, length, seed=seed + 100)
    Xtr_d = _device.to_tensor(Xtr, dev, torch.float32)
    Xte_d = _device.to_tensor(Xte, dev, torch.float32)
    D, n = Xtr.shape[1], Xtr.shape[0]
    k_classes = len(np.unique(ytr))
    pq_cfg, pq_ed_cfg = pq_configs(n)

    def train(cfg, book):
        sync(dev)
        t0 = time.perf_counter()
        if book is None:
            init = init_centroids(table, dataset, seed,
                                  segment(Xtr_d, cfg), cfg.codebook_size)
            book = fit(Xtr_d, cfg, init_centroids=init, device=dev)
        codes = encode(Xtr_d, book, cfg, device=dev)
        sync(dev)
        return book, codes, time.perf_counter() - t0

    cb, tr_codes, pq_train_s = train(pq_cfg, None if books is None
                                     else books[0])
    d, dtt, secs = {}, {}, {}
    d["PQDTW"], secs["PQDTW"] = _fetch(lambda: cdist_sym(
        encode(Xte_d, cb, pq_cfg, device=dev), tr_codes, cb.lut,
        device=dev), dev)
    te_codes = encode(Xte_d, cb, pq_cfg, device=dev)
    te_segs = segment(Xte_d, pq_cfg)
    dtt["PQDTW"], _ = _fetch(lambda: cdist_sym_refined(
        te_codes, te_segs, te_codes, te_segs, cb, device=dev), dev)

    w5 = max(1, int(0.05 * D))
    w10 = max(1, int(0.10 * D))
    sax_l = max(2, int(0.2 * length))
    cb_ed, tr_codes_ed, pq_ed_train_s = train(pq_ed_cfg, None if books is None
                                              else books[1])

    def sax_fn(A):
        return sax_mindist_cdist(sax_transform(Xte, sax_l),
                                 sax_transform(A, sax_l), length)

    def pq_ed_fn(codes_b):
        return cdist_sym(encode(Xte_d, cb_ed, pq_ed_cfg, device=dev),
                         codes_b, cb_ed.lut, device=dev)

    te_codes_ed = encode(Xte_d, cb_ed, pq_ed_cfg, device=dev)
    baselines = {
        "ED": lambda A: ed_cdist(Xte_d, A, device=dev),
        "DTW": lambda A: cdtw_cdist(Xte_d, A, None, device=dev),
        "cDTW5": lambda A: cdtw_cdist(Xte_d, A, w5, device=dev),
        "cDTW10": lambda A: cdtw_cdist(Xte_d, A, w10, device=dev),
        "SBD": lambda A: sbd_cdist(Xte_d, A, device=dev),
    }
    for name, fn in baselines.items():
        d[name], secs[name] = _fetch(lambda: fn(Xtr_d), dev)
        dtt[name], _ = _fetch(lambda: fn(Xte_d), dev)
    d["SAX"], secs["SAX"] = _fetch(lambda: sax_fn(Xtr), dev)
    dtt["SAX"], _ = _fetch(lambda: sax_fn(Xte), dev)
    d["PQ_ED"], secs["PQ_ED"] = _fetch(lambda: pq_ed_fn(tr_codes_ed), dev)
    dtt["PQ_ED"], _ = _fetch(lambda: pq_ed_fn(te_codes_ed), dev)

    err = {m: error_rate(yte, ytr[np.argmin(d[m], axis=1)]) for m in MEASURES}
    ri = {m: rand_index(yte, hierarchical_labels(dtt[m], k_classes))
          for m in MEASURES}
    return dict(dataset=dataset, seed=seed, ytr=ytr, yte=yte,
                k_classes=k_classes, d=d, dtt=dtt, err=err, ri=ri,
                seconds=secs, pq_train_s=pq_train_s,
                pq_ed_train_s=pq_ed_train_s, books=(cb, cb_ed),
                codes={"PQDTW": (tr_codes, te_codes),
                       "PQ_ED": (tr_codes_ed, te_codes_ed)})


def _rel_close(a: float, b: float, rel: float) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b))


def _argmin_ties(da: np.ndarray, db: np.ndarray, rel: float):
    """Rows whose argmin differs: ``(row, i, j, da[row, i], da[row, j],
    tie)``, a tie where the two candidates lie within ``rel`` of each other
    in either matrix."""
    ia, ib = np.argmin(da, 1), np.argmin(db, 1)
    out = []
    for r in np.nonzero(ia != ib)[0]:
        i, j = int(ia[r]), int(ib[r])
        tie = (_rel_close(da[r, i], da[r, j], rel)
               or _rel_close(db[r, i], db[r, j], rel))
        out.append((int(r), i, j, float(da[r, i]), float(da[r, j]), tie))
    return out


def _merge_tie(da: np.ndarray, db: np.ndarray, rel: float):
    """The first merge where the complete linkages of ``da`` and ``db``
    part, as ``(step, height_a, height_b, tie)``: a tie where the two
    merge heights lie within ``rel``; ``None`` if they never part."""
    za, zb = linkage(da), linkage(db)
    for t in range(len(za)):
        if not np.array_equal(za[t, :2], zb[t, :2]):
            ha, hb = float(za[t, 2]), float(zb[t, 2])
            return (t, ha, hb, _rel_close(ha, hb, rel))
    return None


def compare_runs(a: dict, b: dict, rel: float = TIE_REL) -> dict:
    """Hold two runs of one (dataset, seed) to equal per-measure errors and
    Rand indices, except where the decision that parts them was between
    two candidates within ``rel``.  Returns ``{"faults": [...], "ties":
    [...]}``; every entry names the measure and the decision."""
    faults, ties = [], []
    for m in MEASURES:
        if a["err"][m] != b["err"][m]:
            rows = _argmin_ties(a["d"][m], b["d"][m], rel)
            # a differing argmin changes the error only through its label
            changed = [r for r in rows
                       if a["ytr"][r[1]] != b["ytr"][r[2]]]
            for r in changed:
                (ties if r[-1] else faults).append(
                    dict(measure=m, kind="1-NN", row=r[0], cand=r[1:3],
                         dist=r[3:5]))
            if not changed:
                faults.append(dict(measure=m, kind="1-NN error",
                                   err=(a["err"][m], b["err"][m])))
        if a["ri"][m] != b["ri"][m]:
            part = _merge_tie(a["dtt"][m], b["dtt"][m], rel)
            if part is not None and part[-1]:
                ties.append(dict(measure=m, kind="merge", step=part[0],
                                 heights=part[1:3]))
            else:
                faults.append(dict(measure=m, kind="Rand index",
                                   ri=(a["ri"][m], b["ri"][m]), part=part))
    return dict(faults=faults, ties=ties)


def ed_close(got, want, A, B, rtol: float = 1e-5,
             atol: float = 1e-4) -> bool:
    """ED matrices of ``A`` x ``B`` as ``|a|^2 + |b|^2 - 2 a.b`` agree: that
    sum rounds relative to ``|a|^2 + |b|^2``, not to the distance, so a
    near pair (a self-pair: about 1e-5 of a norm of 96) differs between
    two summation orders by ulps of the norms, which the square root lifts
    to about 1e-2.  So the squared distances are held within ``rtol`` of
    the norms' sum plus ``atol``."""
    return sq_close(np.asarray(got, np.float64) ** 2,
                    np.asarray(want, np.float64) ** 2, A, B, rtol, atol)


def sq_close(got_sq, want_sq, A, B, rtol: float = 1e-5,
             atol: float = 1e-4) -> bool:
    """Squared ED matrices of ``A`` x ``B`` agree within ``rtol`` of the
    norms' sum plus ``atol`` (:func:`ed_close`)."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    scale = (A ** 2).sum(1)[:, None] + (B ** 2).sum(1)[None, :]
    diff = np.abs(np.asarray(got_sq, np.float64)
                  - np.asarray(want_sq, np.float64))
    return bool(np.all(diff <= rtol * scale + atol))


def run(quick: bool = False, device: _device.DeviceArg = None,
        datasets: Sequence[str] = DATASETS,
        seeds: Optional[Sequence[int]] = None, out_dir: str = OUT_DIR):
    """The whole table over the grid; returns ``(bench, runs, seconds)``
    and writes ``hw_<device>_table1_accuracy.json``."""
    dev = _device.resolve_device(device)
    if dev.type == "cuda":
        from ..kernels import _build
        _build.lib()                 # the kernels' build is not timed
    g = grid(quick)
    seeds = g["seeds"] if seeds is None else tuple(seeds)
    table = load_init()
    b = Bench("table1_accuracy", dev, out_dir)
    t0 = time.perf_counter()
    runs = []
    agg: Dict[str, list] = {}
    for ds in datasets:
        for seed in seeds:
            r = one_run(ds, seed, g["n_per_class"], g["length"], dev, table)
            runs.append(r)
            t_pq = max(r["seconds"]["PQDTW"], 1e-9)
            for m in MEASURES:
                agg.setdefault(m, []).append(
                    (r["err"][m] - r["err"]["PQDTW"],
                     r["ri"][m] - r["ri"]["PQDTW"],
                     r["seconds"][m] / t_pq, r["err"][m], r["ri"][m]))
            agg.setdefault("_pq_train_s", []).append(r["pq_train_s"])
    seconds = time.perf_counter() - t0
    for m in MEASURES:
        vals = np.array(agg[m])
        b.add(measure=m,
              mean_err_diff=float(np.mean(vals[:, 0])),
              std_err_diff=float(np.std(vals[:, 0])),
              mean_ri_diff=float(np.mean(vals[:, 1])),
              speedup_vs_pqdtw=float(np.mean(vals[:, 2])),
              median_speedup_vs_pqdtw=float(np.median(vals[:, 2])),
              mean_err=float(np.mean(vals[:, 3])),
              mean_ri=float(np.mean(vals[:, 4])))
    b.save(headline={"quick": quick, "datasets": list(datasets),
                     "seeds": list(seeds), **{k: g[k] for k in
                                              ("n_per_class", "length")},
                     "seconds": seconds,
                     "pq_train_s": agg["_pq_train_s"]})
    return b, runs, seconds


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the reference's quick grid (12 a class, L = 96)")
    ap.add_argument("--datasets", nargs="+", default=list(DATASETS),
                    choices=DATASETS)
    ap.add_argument("--seeds", nargs="+", type=int, default=None)
    device_args(ap)
    args = ap.parse_args(argv)
    run(args.quick, args.device, args.datasets, args.seeds, args.out)


if __name__ == "__main__":
    main()
