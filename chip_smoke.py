#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, drives
the paper's main path once through the user-facing entry points at a
FordA-scale collection (UCR FordA is 3601 x 500; here 6144 x 512 training
series and 768 queries with the default ``PQConfig``: M=8, K=256, S=74,
window 7), then the search paths beyond 1-NN on the same data:

- ``pruned_nn``: the exact LB-cascade 1-NN (``knn.nn_dtw_pruned``) of 128
  queries at window 51, whose predictions must equal ``nn_dtw_exact``'s;
- ``index_path``: a streaming IVF-PQDTW index (``IndexConfig(PQConfig(),
  n_lists=64, hot_capacity=2560)``) bootstrapped on the 6144 series, all of
  them inserted (2 sealed segments, 1024 rows hot), 5% deleted, the 768
  queries searched (``n_probe=8, topk=10``); the hot part must equal a
  dense scan, the compacted index ``ivf.search_batch`` over the live rows,
  and a snapshot must restore bit for bit.

Then it holds every kernel against its plain PyTorch version on the paths'
own tensors and times both.  ``lb_refine`` is checked twice over: on every
wave of both searches (a second, untimed run of each) its flags and
unrefined outputs are held against the plain bound, and on the first wave
and the first mixed wave (refined and pruned pairs) of each search its
whole output is held against the plain version.

    python3 chip_smoke.py

It takes no arguments: the sizes above are fixed.  If the run ever nears
its time limit, cut ``EXACT_QUERIES`` first, never the PQ geometry.

Each phase prints one JSON line (the whole record also goes to
``chiprun_out/chip_smoke.jsonl``).
Then, before the last line, the kernel table ``{"kernels": [...]}`` and the
card's name and power limit as ``nvidia-smi`` gives them.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the exit code is non-zero and that line is
never printed.  Without a CUDA device the script exits non-zero at once.

``ms`` is the kernel's launch alone (mean of ``REPS`` back-to-back
launches, CUDA events); ``wrapper_ms`` in the phase line is the whole
wrapper call, checks included.  Bounds (``bound_ms``) use the H100 SXM's
published rates: 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per DP cell of the dtw kernel: x - y, the fused
# multiply-add (2), two mins and the +inf clamp
DTW_OPS_PER_CELL = 6
RTOL, ATOL = 1e-5, 1e-4
FLAG_TIE_REL = 1e-5      # lb_refine: a flag may flip this near its threshold
TRAIN_PER_CLASS = 2048    # CBF series per class in the training set (x3)
QUERIES_PER_CLASS = 256   # CBF series per class in the query set (x3)
EXACT_QUERIES = 128       # queries for the exact elastic 1-NN
EXACT_CHECK_QUERIES = 16  # of those, held against the plain version
REPS = 5                  # timed repetitions per kernel
PRUNED_QUERIES = 128      # queries for the LB-cascade 1-NN
SEARCH_WINDOW = 51        # the exact searches' band: round(0.1 * 512)
INDEX_LISTS = 64
HOT_CAPACITY = 2560
N_PROBE, TOPK = 8, 10
DELETE_FRAC = 0.05
# the slice-1 main path's kernels (each must launch there)
MAIN_PATH_KERNELS = ("dtw_band", "dtw_band_cdist", "adc_sym", "adc_lookup",
                     "prealign_encode")
TPU_SITES = {
    "dtw_band": "src/repro/kernels/dtw_band/kernel.py:384",
    "dtw_band_cdist": "src/repro/kernels/dtw_band/kernel.py:411",
    "adc_sym": "src/repro/kernels/pq_adc/kernel.py:118",
    "adc_lookup": "src/repro/kernels/pq_adc/kernel.py:135",
    "prealign_encode": "src/repro/kernels/prealign_encode/kernel.py:133",
    "lb_refine": "src/repro/kernels/lb_cascade/kernel.py:138",
}
SOURCES = {
    "dtw_band": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "dtw_band_cdist": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "adc_sym": "src/repro_torch/kernels/csrc/pq_adc.cu",
    "adc_lookup": "src/repro_torch/kernels/csrc/pq_adc.cu",
    "prealign_encode": "src/repro_torch/kernels/csrc/prealign_encode.cu",
    "lb_refine": "src/repro_torch/kernels/csrc/lb_cascade.cu",
}

_records = []


def emit(record: dict) -> None:
    line = json.dumps(record)
    _records.append(line)
    print(line, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def band_cells(L: int, w: int) -> int:
    """DP cells inside a Sakoe-Chiba band of half-width w (w <= L-1)."""
    return L * (2 * w + 1) - w * (w + 1)


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.lib()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0})

    ctx = main_path(torch, _build)
    waves = {}
    ctx["pruned_launches"] = pruned_nn(torch, _build, ctx, waves)
    ctx["index_launches"] = index_path(torch, _build, ctx, waves)
    small_reference(torch)
    kernels = kernel_phases(torch, ctx)
    kernels.append(lb_refine_phases(torch, ctx, waves))
    measure_sweep(torch)
    emit({"kernels": kernels})

    out = ROOT / "chiprun_out" / "chip_smoke.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(_records) + "\n")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# The main path, through the entry points a user calls
# ---------------------------------------------------------------------------

def main_path(torch, _build) -> dict:
    from repro_torch.core import dispatch, knn, metrics, pq
    from repro_torch.data.timeseries import make_dataset

    X, y = make_dataset("cbf", TRAIN_PER_CLASS, 512, seed=0)
    Q, yq = make_dataset("cbf", QUERIES_PER_CLASS, 512, seed=100)
    dev = torch.device("cuda")
    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    Qd = torch.from_numpy(Q).to(dev)
    cfg = pq.PQConfig()
    cfg_exact = dataclasses.replace(cfg, exact_encode=True)
    D = X.shape[1]
    nq = EXACT_QUERIES
    w_exact = round(0.1 * D)
    seconds = {}

    def run(name, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        return result

    _build.reset_launches()
    dispatch.reset_stats()
    cb = run("fit", lambda: pq.fit(Xd, cfg, torch.Generator().manual_seed(0)))
    codes = run("encode", lambda: pq.encode(Xd, cb, cfg))
    q_codes = run("encode_queries", lambda: pq.encode(Qd, cb, cfg))
    d_sym = run("cdist_sym", lambda: pq.cdist_sym(q_codes, codes, cb.lut))
    pred_sym = run("knn_classify_sym",
                   lambda: knn.knn_classify_sym(codes, yd, Qd, cb, cfg))
    d_asym = run("cdist_asym", lambda: pq.cdist_asym(Qd, codes, cb, cfg))
    pred_asym = run("knn_classify_asym",
                    lambda: knn.knn_classify_asym(codes, yd, Qd, cb, cfg))
    codes_fused = run("encode_exact_fused",
                      lambda: pq.encode(Xd, cb, cfg_exact))
    pred_nn = run("nn_dtw_exact", lambda: knn.nn_dtw_exact(
        Xd, yd, Qd[:nq], window=w_exact))
    launches = dict(_build.LAUNCHES)
    routes = sorted({route for _, route in dispatch.stats})

    M, K, S = cb.centroids.shape
    N, Nq = X.shape[0], Q.shape[0]
    check(tuple(cb.centroids.shape) == (cfg.n_sub, cfg.codebook_size,
                                        cfg.subseq_len(D)), "codebook shape")
    check(tuple(cb.lut.shape) == (M, K, K), "LUT shape")
    for name, t in (("centroids", cb.centroids), ("lut", cb.lut),
                    ("d_sym", d_sym), ("d_asym", d_asym)):
        check(bool(torch.isfinite(t).all()), f"{name} finite")
    check(bool((cb.lut >= 0).all()), "LUT non-negative")
    for name, c, n in (("codes", codes, N), ("q_codes", q_codes, Nq),
                       ("codes_fused", codes_fused, N)):
        check(tuple(c.shape) == (n, M) and c.dtype == torch.int32,
              f"{name} shape/dtype")
        check(int(c.min()) >= 0 and int(c.max()) < K, f"{name} range")
    check(tuple(d_sym.shape) == (Nq, N) and tuple(d_asym.shape) == (Nq, N),
          "distance shapes")
    check(torch.equal(pred_sym, yd[torch.argmin(d_sym, 1)]),
          "symmetric 1-NN = argmin of cdist_sym")
    check(routes == ["cuda"], f"main path routes {routes}")
    check(all(launches[k] > 0 for k in MAIN_PATH_KERNELS),
          f"every kernel launched on the main path: {launches}")
    acc = {
        "sym": 1.0 - metrics.error_rate(yq, pred_sym),
        "asym": 1.0 - metrics.error_rate(yq, pred_asym),
        "exact_dtw": 1.0 - metrics.error_rate(yq[:nq], pred_nn),
    }
    for name, a in acc.items():
        check(a > 0.5, f"{name} 1-NN accuracy {a} above chance")
    fused_equal_lb = float((codes_fused == codes).float().mean())
    emit({"phase": "main_path", "train": list(X.shape),
          "queries": list(Q.shape), "M": M, "K": K, "S": S,
          "window": cfg.window(D), "tail": cfg.tail(D),
          "refine_t": cfg.refine_t(), "exact_queries": nq,
          "exact_window": w_exact, "seconds": seconds,
          "total_s": sum(seconds.values()), "accuracy": acc,
          "lb_codes_equal_exact_codes": fused_equal_lb,
          "launches": launches, "routes": routes,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return dict(cfg=cfg, X=X, Xd=Xd, yd=yd, Qd=Qd, cb=cb, codes=codes,
                q_codes=q_codes, codes_fused=codes_fused, launches=launches,
                D=D, w_exact=w_exact)


# ---------------------------------------------------------------------------
# The search paths beyond 1-NN: exact LB-cascade search and the index
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def checked_waves(torch, lb_search, log: dict):
    """Hook ``filtered_topk``'s ``lb_refine`` while the block runs.  Each
    wave still goes through the kernel once, as without the hook; then its
    pruning side is held against the plain bound (``lb.cascade_bound``):
    every flag equals ``bound < thresh`` apart from counted bound ties
    (within ``FLAG_TIE_REL`` of a finite threshold), a filler pair
    (``thresh = -inf``) never refines, and every unrefined pair returns its
    bound within ``rtol, atol``.  ``log`` gathers the counts over all waves
    and keeps the arguments of the first wave and of the first mixed wave
    (pairs refined and pairs pruned at their threshold; one that also
    carries filler where a wave does)."""
    from repro_torch.core.lb import cascade_bound
    original = lb_search.lb_refine
    totals = log.setdefault("totals", dict.fromkeys(
        ("waves", "pairs", "refined", "pruned", "filler", "flag_ties"), 0))
    worst = log.setdefault("unrefined_max_abs_err", [0.0])

    def hook(A, B, upper, lower, thresh, window, **kw):
        d, f = original(A, B, upper, lower, thresh, window, **kw)
        lb = cascade_bound(B, A, upper, lower)
        filler = thresh == -float("inf")
        flips, _ = _flag_flips(torch, f, lb, thresh, "lb_refine wave")
        check(not bool((f & filler).any()),
              "lb_refine wave: no filler pair refines")
        kept = ~f & ~flips
        if bool(kept.any()):
            max_abs, _, ok = _errors(torch, d[kept], lb[kept])
            check(ok, "lb_refine wave: an unrefined pair returns its bound")
            worst[0] = max(worst[0], max_abs)
        n_ref = int(f.sum())
        n_filler = int(filler.sum())
        n_pruned = int((~f & ~filler).sum())
        for key, v in (("waves", 1), ("pairs", f.numel()), ("refined", n_ref),
                       ("pruned", n_pruned), ("filler", n_filler),
                       ("flag_ties", int(flips.sum()))):
            totals[key] += v
        args = (A, B, upper, lower, thresh, window)
        log.setdefault("first", args)
        if n_ref > 0 and n_pruned > 0:
            log.setdefault("mixed", args)
            if n_filler > 0:
                log.setdefault("mixed_filler", args)
        return d, f

    lb_search.lb_refine = hook
    try:
        yield log
    finally:
        lb_search.lb_refine = original


def _flag_flips(torch, f, lb, thresh, what):
    """The kernel's flags ``f`` against the plain ``lb < thresh``: they may
    differ only at bound ties, where the bound lies within
    ``FLAG_TIE_REL`` (relative) of a finite threshold.  Returns the flips
    and the pairs near their threshold."""
    near = torch.isfinite(thresh) & (
        (lb - thresh).abs() <= FLAG_TIE_REL * thresh.abs())
    flips = f != (lb < thresh)
    check(not bool((flips & ~near).any()),
          f"{what}: flags differ from the plain bound's only at bound ties")
    return flips, near


def _timed(torch, fn):
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - start


def pruned_nn(torch, _build, ctx, waves) -> dict:
    """``knn.nn_dtw_pruned`` on the first queries: predictions equal the
    exact 1-NN's, the top-1 distance equals the exact row minimum."""
    from repro_torch.core import dispatch, knn, lb_search
    Xd, yd = ctx["Xd"], ctx["yd"]
    Qn = ctx["Qd"][:PRUNED_QUERIES].contiguous()
    w = SEARCH_WINDOW
    _build.reset_launches()
    dispatch.reset_stats()
    (pred, pruned), secs = _timed(
        torch, lambda: knn.nn_dtw_pruned(Xd, yd, Qn, window=w))
    launches = dict(_build.LAUNCHES)
    check(launches["lb_refine"] > 0, f"pruned_nn launched lb_refine: "
          f"{launches}")
    check(sorted({r for _, r in dispatch.stats}) == ["cuda"],
          "pruned_nn routes")
    exact = knn.nn_dtw_exact(Xd, yd, Qn, window=w)
    check(torch.equal(pred, exact), "nn_dtw_pruned predictions equal "
          "nn_dtw_exact's")
    # the same search again, untimed, with every wave checked
    with checked_waves(torch, lb_search, waves.setdefault("pruned_nn", {})):
        d, idx, st = lb_search.filtered_topk(Qn, Xd, w, 1, with_stats=True)
    log = waves["pruned_nn"]["totals"]
    check(int(st["n_waves"]) == launches["lb_refine"] == log["waves"],
          "filtered_topk's wave count equals pruned_nn's lb_refine launches")
    n_pairs = float(Qn.shape[0] * Xd.shape[0])
    check(int(st["n_refined"]) == log["refined"]
          and 1.0 - log["refined"] / n_pairs == pruned,
          "the checked waves' refined pairs equal pruned_nn's count")
    d_all = dispatch.elastic_cdist(Qn, Xd, w)
    _, max_rel, ok = _errors(torch, d[:, 0], d_all.min(dim=1).values)
    check(ok, "pruned top-1 distance equals the exact row minimum")
    emit({"phase": "pruned_nn", "queries": list(Qn.shape),
          "train": list(Xd.shape), "window": w, "seconds": secs,
          "pruned": pruned, "n_waves": int(st["n_waves"]),
          "n_refined": int(st["n_refined"]),
          "n_bounded": int(st["n_bounded"]),
          "top1_max_rel_err": max_rel, "launches": launches})
    return launches


def index_path(torch, _build, ctx, waves) -> dict:
    """The streaming IVF-PQDTW index through its lifecycle at full size."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core import dispatch, ivf, pq
    from repro_torch.core.topk import smallest_k
    from repro_torch.index import (IndexConfig, StreamingIndex,
                                   restore_snapshot, save_snapshot)
    from repro_torch.index.streaming import search_impl
    from repro_torch.core import lb_search

    X, Xd, Qd, D = ctx["X"], ctx["Xd"], ctx["Qd"], ctx["D"]
    N, Nq = X.shape[0], Qd.shape[0]
    cfg = IndexConfig(pq.PQConfig(), n_lists=INDEX_LISTS,
                      hot_capacity=HOT_CAPACITY)
    w = cfg.coarse_window(D)
    check(w == SEARCH_WINDOW, f"hot-scan window {w}")
    seconds = {}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    dispatch.reset_stats()
    idx, seconds["bootstrap"] = _timed(torch, lambda: StreamingIndex.bootstrap(
        torch.Generator().manual_seed(0), Xd, cfg))
    ids, seconds["insert"] = _timed(torch, lambda: idx.insert(X))
    check(idx.n_segments == 2 and idx.hot.count == N - 2 * HOT_CAPACITY,
          f"insert: {idx.stats()}")
    rng = np.random.default_rng(1)
    dead = np.sort(rng.choice(ids, int(DELETE_FRAC * N), replace=False))
    hot_dead = int((dead >= 2 * HOT_CAPACITY).sum())
    check(0 < hot_dead < len(dead), "deletes hit hot and sealed rows")
    hit, seconds["delete"] = _timed(torch, lambda: idx.delete(dead))
    check(hit == len(dead), f"delete hit {hit} of {len(dead)}")
    (d, i), seconds["search"] = _timed(torch, lambda: idx.search(
        Qd, n_probe=N_PROBE, topk=TOPK))
    stage_names = ("coarse", "lut", "fine", "hot", "merge")
    before = {s: _stage_sum(obs, s) for s in stage_names}
    counters0 = _lb_counters(obs)
    with obs.override(True):
        (d_on, i_on), seconds["search_obs_on"] = _timed(
            torch, lambda: idx.search(Qd, n_probe=N_PROBE, topk=TOPK))
    launches = dict(_build.LAUNCHES)
    stages = {s: _stage_sum(obs, s) - before[s] for s in stage_names}
    counters = {k: v - counters0[k] for k, v in _lb_counters(obs).items()}
    check(torch.equal(i, i_on) and torch.equal(d, d_on),
          "search identical with obs on and off")
    for k in ("lb_refine", "dtw_band", "dtw_band_cdist"):
        check(launches[k] > 0, f"index path launched {k}: {launches}")
    check(sorted({r for _, r in dispatch.stats}) == ["cuda"],
          "index path routes")
    check(tuple(d.shape) == (Nq, TOPK) and bool(torch.isfinite(d).all()),
          "index search: finite (Nq, topk) distances")
    check(not bool(torch.isin(i, torch.from_numpy(dead).to(i.device)).any()),
          "no deleted id is returned")

    # the hot part alone equals a dense scan over the live hot rows
    # (the hot scan again, untimed, with every wave checked)
    hot = idx._hot_arrays()
    with checked_waves(torch, lb_search, waves.setdefault("hot_scan", {})):
        hd, hi = search_impl(idx.coarse, idx.cb, (), hot, Qd, icfg=cfg,
                             n_probe=N_PROBE, topk=TOPK, dim=D)
    data, hids, live = hot
    dense = dispatch.elastic_cdist(Qd, data, w)
    dense = torch.sqrt(torch.where(live[None, :], dense, float("inf")))
    wd, wi = smallest_k(dense, TOPK)
    wi = torch.where(torch.isfinite(wd), hids[wi], -1)
    _, hot_rel, ok = _errors(torch, hd, wd)
    check(ok and torch.equal(hi, wi.to(hi.dtype)),
          "hot scan equals the dense scan (ids and distances)")

    _, seconds["flush_compact"] = _timed(
        torch, lambda: (idx.flush(), idx.compact()))
    live_ids = idx.live_ids()
    check(idx.n_segments == 1 and len(live_ids) == N - len(dead),
          f"compacted: {idx.stats()}")
    (cd, ci), seconds["search_compacted"] = _timed(
        torch, lambda: idx.search(Qd, n_probe=N_PROBE, topk=TOPK))
    ref, seconds["build_index_ref"] = _timed(torch, lambda: ivf.build_index(
        None, X[live_ids], cfg.pq, n_lists=INDEX_LISTS, coarse=idx.coarse,
        cb=idx.cb))
    rd, ri = ivf.search_batch(ref, Qd, cfg.pq, n_probe=N_PROBE, topk=TOPK)
    lid = torch.from_numpy(live_ids).to(ri.device)
    ri = torch.where(ri >= 0, lid[ri.long().clamp(min=0)].to(ri.dtype), -1)
    _, ivf_rel, ok = _errors(torch, cd, rd)
    check(ok and torch.equal(ci, ri),
          "compacted index equals ivf.search_batch over the live rows")

    snap_dir = ROOT / "build" / "chip_smoke_snapshots"
    shutil.rmtree(snap_dir, ignore_errors=True)
    _, seconds["snapshot_save"] = _timed(
        torch, lambda: save_snapshot(str(snap_dir), idx))
    back, seconds["snapshot_restore"] = _timed(
        torch, lambda: restore_snapshot(str(snap_dir)))
    bd, bi = back.search(Qd, n_probe=N_PROBE, topk=TOPK)
    shutil.rmtree(snap_dir, ignore_errors=True)
    check(torch.equal(bi, ci) and torch.equal(bd, cd),
          "snapshot round-trips bit for bit")

    emit({"phase": "index_path", "train": list(X.shape),
          "queries": list(Qd.shape), "n_lists": INDEX_LISTS,
          "hot_capacity": HOT_CAPACITY, "n_probe": N_PROBE, "topk": TOPK,
          "hot_window": w, "deleted": len(dead), "deleted_hot": hot_dead,
          "seconds": seconds, "stage_seconds_obs_on": stages,
          "lb_counters": counters, "hot_max_rel_err": hot_rel,
          "ivf_max_rel_err": ivf_rel, "memory_cost": idx.memory_cost(),
          "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches


def _stage_sum(obs, stage: str) -> float:
    h = obs.REGISTRY.histogram("stage_seconds", persistent=True,
                               stage=f"index.search.{stage}")
    return h.sum


def _lb_counters(obs) -> dict:
    snap = obs.snapshot()
    return {name: obs.counter_value(snap, f"lb_{name}_total")
            for name in ("candidates_bounded", "candidates_refined",
                         "candidates_pruned", "refine_waves")}


# ---------------------------------------------------------------------------
# Agreement with the port's CPU route on a small input
# ---------------------------------------------------------------------------

def small_reference(torch) -> None:
    """A codebook trained on the CPU, carried to the card: codes and 1-NN
    predictions on the card equal those of the CPU route (which the tests
    hold against the JAX package)."""
    from repro_torch.core import knn, pq
    from repro_torch.data.timeseries import make_dataset
    X, y = make_dataset("cbf", 16, 128, seed=1)
    Q, _ = make_dataset("cbf", 4, 128, seed=2)
    cfg = pq.PQConfig(n_sub=4, codebook_size=8, kmeans_iters=2, dba_iters=1)
    cfg_exact = dataclasses.replace(cfg, exact_encode=True)
    cb_cpu = pq.fit(X, cfg, torch.Generator().manual_seed(1), device="cpu")
    cb_gpu = pq.codebook_from_numpy(pq.codebook_to_numpy(cb_cpu))
    results = {}
    for name, fn in {
        "encode": lambda cb, dev: pq.encode(X, cb, cfg, device=dev),
        "encode_exact_fused": lambda cb, dev: pq.encode(X, cb, cfg_exact,
                                                        device=dev),
        "knn_sym": lambda cb, dev: knn.knn_classify_sym(
            pq.encode(X, cb, cfg, device=dev), y, Q, cb, cfg, device=dev),
        "knn_asym": lambda cb, dev: knn.knn_classify_asym(
            pq.encode(X, cb, cfg, device=dev), y, Q, cb, cfg, device=dev),
        "nn_dtw_exact": lambda cb, dev: knn.nn_dtw_exact(X, y, Q, window=13,
                                                         device=dev),
    }.items():
        want = fn(cb_cpu, "cpu")
        got = fn(cb_gpu, None).cpu()
        results[name] = bool(torch.equal(got, want))
        check(results[name], f"small input: {name} equals the CPU route")
    emit({"phase": "small_reference", "train": list(X.shape),
          "identical": results})


# ---------------------------------------------------------------------------
# Every kernel against its plain version, on the main path's tensors
# ---------------------------------------------------------------------------

def _sync_ms(torch, fn):
    """One call timed with CUDA events (plain versions: host loops)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return result, start.elapsed_time(end)


def _mean_ms(torch, fn, reps):
    """Mean of ``reps`` back-to-back calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _errors(torch, got, want):
    if got.dtype in (torch.int32, torch.int64):
        diff = (got.long() - want.long()).abs()
        return float(diff.max()), 0.0, bool(diff.max() == 0)
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    ok = bool((diff <= ATOL + RTOL * want.abs()).all())
    rel = float((diff / want.abs().clamp_min(1e-30)).max())
    return float(diff.max()), rel, ok


def kernel_phases(torch, ctx) -> list:
    from repro_torch.core import pq
    from repro_torch.core.modwt import linspace01
    from repro_torch.kernels.dtw_band.ops import dtw_band, dtw_band_cdist
    from repro_torch.kernels.dtw_band.ref import (dtw_band_cdist_ref,
                                                  dtw_band_ref)
    from repro_torch.kernels.pq_adc.ops import (adc_lookup, adc_sym_cdist,
                                               launch_adc_lookup,
                                               launch_adc_sym)
    from repro_torch.kernels.pq_adc.ref import (adc_lookup_ref,
                                               adc_sym_cdist_ref)
    from repro_torch.kernels.prealign_encode.ops import prealign_encode
    from repro_torch.kernels.prealign_encode.ref import prealign_encode_ref

    cfg, cb, D = ctx["cfg"], ctx["cb"], ctx["D"]
    Xd, Qd = ctx["Xd"], ctx["Qd"]
    # int32 and in range (checked on the main path), as the launches take
    codes, q_codes = ctx["codes"].contiguous(), ctx["q_codes"].contiguous()
    M, K, S = cb.centroids.shape
    w = cfg.window(D)
    cells = band_cells(S, w)
    segs = pq.segment(Xd, cfg)
    N, Nq = Xd.shape[0], Qd.shape[0]
    rows = []

    def phase(name, shapes, kernel_fn, plain_fn, library_fn, nbytes, ops,
              launch_fn=None, table=True):
        """``launch_fn``: the launch alone, returning its output, where the
        wrapper does more than launch (the ADC range check); ``table=False``: a second shape of a
        kernel already in the table, printed as a phase line only."""
        got = kernel_fn()
        torch.cuda.synchronize()
        want, plain_ms = _sync_ms(torch, plain_fn)
        max_abs, max_rel, ok = _errors(torch, got, want)
        wrapper_ms = _mean_ms(torch, kernel_fn, REPS)
        ms = wrapper_ms
        if launch_fn is not None:
            check(torch.equal(launch_fn(), got),
                  f"{name}: the launch alone equals the wrapper's result")
            ms = _mean_ms(torch, launch_fn, REPS)
        library_ms = (None if library_fn is None
                      else _mean_ms(torch, library_fn, REPS))
        bound_ms, bound_by = bound(nbytes, ops)
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": TPU_SITES[name],
               "launches": ctx["launches"][name], "max_abs_err": max_abs,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}
        emit({"phase": "kernel", **row, "shapes": shapes,
              "wrapper_ms": wrapper_ms, "max_rel_err": max_rel,
              "agrees": ok, "in_table": table,
              "tolerance": ("identical" if got.dtype == torch.int32
                            else {"rtol": RTOL, "atol": ATOL})})
        check(ok, f"{name} {shapes} agrees with its plain version")
        if table:
            rows.append(row)
        return got

    # 1. zipped pairs: the LB-filtered encode's refine batch
    _, _, qs, cs = pq.lb_filter_pairs(segs, cb, cfg.refine_t())
    P = qs.shape[0]
    phase("dtw_band", {"pairs": [P, S], "window": w},
          lambda: dtw_band(qs, cs, w), lambda: dtw_band_ref(qs, cs, w), None,
          (2 * P * S + P) * 4, P * cells * DTW_OPS_PER_CELL)
    del qs, cs

    # 2. all pairs: a DBA k-means assignment (N segments x K centroids)
    A, B = segs[:, 0].contiguous(), cb.centroids[0].contiguous()
    phase("dtw_band_cdist", {"A": [N, S], "B": [K, S], "window": w},
          lambda: dtw_band_cdist(A, B, w),
          lambda: dtw_band_cdist_ref(A, B, w), None,
          (N * S + K * S + N * K) * 4, N * K * cells * DTW_OPS_PER_CELL)
    del A, B

    # 2b. all pairs at the exact 1-NN's geometry (L=512, window 51, where
    # the band rows take a 64-thread block): the first queries of
    # nn_dtw_exact against the whole training set
    Qn, w_nn = Qd[:EXACT_CHECK_QUERIES].contiguous(), ctx["w_exact"]
    nn_cells = band_cells(D, w_nn)
    phase("dtw_band_cdist", {"A": [EXACT_CHECK_QUERIES, D], "B": [N, D],
                             "window": w_nn},
          lambda: dtw_band_cdist(Qn, Xd, w_nn),
          lambda: dtw_band_cdist_ref(Qn, Xd, w_nn), None,
          (EXACT_CHECK_QUERIES * D + N * D + EXACT_CHECK_QUERIES * N) * 4,
          EXACT_CHECK_QUERIES * N * nn_cells * DTW_OPS_PER_CELL, table=False)

    # 3. symmetric ADC: query codes x training codes through the LUT
    lut = cb.lut.contiguous()
    m_idx = torch.arange(M, device=lut.device)[:, None, None]
    qa, tb = q_codes.long().T[:, :, None], codes.long().T[:, None, :]
    sym_out = torch.empty((Nq, N), dtype=torch.float32, device=lut.device)
    phase("adc_sym", {"codes_a": [Nq, M], "codes_b": [N, M],
                      "lut": [M, K, K]},
          lambda: adc_sym_cdist(q_codes, codes, lut),
          lambda: adc_sym_cdist_ref(q_codes, codes, lut),
          lambda: torch.sqrt(lut[m_idx, qa, tb].sum(0).clamp_min(0.0)),
          ((Nq + N) * M + M * K * K + Nq * N) * 4, Nq * N * (M + 2),
          launch_fn=lambda: (launch_adc_sym(q_codes, codes, lut, sym_out),
                             sym_out)[1])

    # 4. asymmetric ADC: every query's (M, K) table x training codes
    luts = pq.query_lut_batch(pq.segment(Qd, cfg), cb, w, False,
                              cfg.measure()).contiguous()
    m_row = torch.arange(M, device=lut.device)[None, :]
    codes_l = codes.long()
    lookup_out = torch.empty((Nq, N), dtype=torch.float32, device=lut.device)
    phase("adc_lookup", {"qlut": [Nq, M, K], "codes": [N, M]},
          lambda: adc_lookup(codes, luts), lambda: adc_lookup_ref(codes, luts),
          lambda: torch.sqrt(luts[:, m_row, codes_l].sum(-1).clamp_min(0.0)),
          (Nq * M * K + N * M + Nq * N) * 4, Nq * N * (M + 2),
          launch_fn=lambda: (launch_adc_lookup(codes, luts, lookup_out),
                             lookup_out)[1])

    # 5. fused MODWT prealign + exact 1-NN encode of the training set
    cents = cb.centroids.contiguous()
    level, tail = cfg.wavelet_level, cfg.tail(D)
    lin = linspace01(S, Xd.device)
    fused = phase(
        "prealign_encode", {"X": [N, D], "centroids": [M, K, S],
                            "window": w},
        lambda: prealign_encode(Xd, cents, level, tail, w),
        lambda: prealign_encode_ref(Xd, cents, level, tail, w, None, lin),
        None, (N * D + M * K * S + N * M + S) * 4,
        N * M * K * cells * DTW_OPS_PER_CELL)
    check(torch.equal(fused, ctx["codes_fused"]),
          "fused codes equal the main path's exact encode")
    return rows


def lb_refine_phases(torch, ctx, waves) -> dict:
    """``lb_refine`` against its plain version on real waves of both
    searches: the first wave of each (the hot scan's is the table's
    record) and the first mixed wave of each, where some pairs refine and
    others are pruned at their threshold (one with filler pairs at
    ``thresh = -inf`` where a wave had them).

    The kernel sums LB_Keogh sequentially and the plain version as a tree,
    so a bound within an ulp of its threshold may flip its flag: flags must
    be identical apart from pairs whose bound lies within ``FLAG_TIE_REL``
    (relative) of a finite threshold, which are counted; distances are
    held to ``rtol=1e-5, atol=1e-4`` where the flags agree."""
    from repro_torch.core.lb import cascade_bound
    from repro_torch.kernels.lb_cascade.ops import (launch_lb_refine,
                                                    lb_refine)
    from repro_torch.kernels.lb_cascade.ref import lb_refine_ref
    launches = (ctx["pruned_launches"]["lb_refine"]
                + ctx["index_launches"]["lb_refine"])
    record = None
    for name in ("hot_scan", "pruned_nn"):
        log = waves[name]
        totals = log["totals"]
        check(totals["pruned"] > 0,
              f"{name}: some wave pruned pairs at their threshold")
        emit({"phase": "lb_refine_waves", "search": name, **totals,
              "unrefined_max_abs_err": log["unrefined_max_abs_err"][0]})
        mixed = log.get("mixed_filler", log.get("mixed"))
        check(mixed is not None, f"{name}: a wave both refined and pruned")
        for which, args in (("first", log["first"]), ("mixed", mixed)):
            table = name == "hot_scan" and which == "first"
            A, B, up, lo, th, w = args
            n, L = A.shape
            d, f = lb_refine(A, B, up, lo, th, w)
            torch.cuda.synchronize()
            (want_d, want_f), plain_ms = _sync_ms(
                torch, lambda: lb_refine_ref(A, B, up, lo, th, w))
            lb = cascade_bound(B, A, up, lo)
            check(torch.equal(want_f, lb < th),
                  "the plain flags are the plain bound's")
            flips, near = _flag_flips(torch, f, lb, th,
                                      f"lb_refine {name} {which}")
            agree = ~flips
            max_abs, max_rel, ok = _errors(torch, d[agree], want_d[agree])
            check(ok, f"lb_refine {name} {which}: distances agree where "
                  "flags agree")
            filler = th == -float("inf")
            n_refined = int(f.sum())
            n_filler = int(filler.sum())
            n_pruned = n - n_refined - n_filler
            if which == "mixed":
                check(0 < n_refined < n and n_pruned > 0,
                      f"lb_refine {name}: the mixed wave refines and prunes")
            d_out = torch.empty_like(d)
            flag = torch.empty(n, dtype=torch.int32, device=A.device)
            ms = _mean_ms(torch, lambda: launch_lb_refine(
                A, B, up, lo, th, w, d_out, flag), REPS)
            check(torch.equal(flag.bool(), f) and torch.equal(d_out, d),
                  f"lb_refine {name} {which}: the launch alone equals the "
                  "wrapper")
            wrapper_ms = _mean_ms(
                torch, lambda: lb_refine(A, B, up, lo, th, w), REPS)
            bound_ms, bound_by = bound(
                n * (16 * L + 12),
                n * 5 * L + n_refined * DTW_OPS_PER_CELL * band_cells(L, w))
            row = {"name": "lb_refine", "route": "cuda",
                   "source": SOURCES["lb_refine"],
                   "replaces": TPU_SITES["lb_refine"], "launches": launches,
                   "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
            emit({"phase": "kernel", **row, "wave": f"{name} {which}",
                  "shapes": {"pairs": [n, L], "window": w},
                  "n_refined": n_refined, "n_pruned": n_pruned,
                  "n_filler": n_filler, "flag_ties": int(flips.sum()),
                  "near_threshold": int(near.sum()),
                  "wrapper_ms": wrapper_ms, "max_rel_err": max_rel,
                  "agrees": ok, "in_table": table,
                  "tolerance": {"rtol": RTOL, "atol": ATOL,
                                "flag_tie_rel": FLAG_TIE_REL}})
            if table:
                record = row
    check(sum(waves[k]["totals"]["filler"] for k in waves) > 0,
          "some wave carried filler pairs (thresh = -inf)")
    return record


def measure_sweep(torch) -> None:
    """Both DP kernels for every measure at the main path's subsequence
    geometry (S=74, w=7) and at the exact-NN geometry (L=512, w=51), plus
    the unbanded L=600 case whose band rows live in device scratch,
    ``adc_sym`` on 1024 x 6144 random codes, and the fused encode under two
    other measures."""
    from repro_torch.kernels.dtw_band.ops import dtw_band, dtw_band_cdist
    from repro_torch.kernels.dtw_band.ref import (dtw_band_cdist_ref,
                                                  dtw_band_ref)
    from repro_torch.kernels.pq_adc.ops import adc_sym_cdist
    from repro_torch.kernels.pq_adc.ref import adc_sym_cdist_ref
    from repro_torch.kernels.prealign_encode.ops import prealign_encode
    from repro_torch.kernels.prealign_encode.ref import prealign_encode_ref

    g = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    cases = []
    for L, window, n_pairs, (na, nb) in ((74, 7, 4096, (64, 64)),
                                         (512, 51, 512, (16, 32)),
                                         (600, None, 64, (8, 8))):
        measures = ("dtw", "wdtw", "erp:g=0.3", "msm:c=0.5") \
            if window is not None else ("dtw",)
        for measure in measures:
            A, B = randn(n_pairs, L), randn(n_pairs, L)
            Ac, Bc = randn(na, L), randn(nb, L)
            for form, got, want in (
                    ("zipped", dtw_band(A, B, window, measure),
                     dtw_band_ref(A, B, window, measure)),
                    ("all_pairs", dtw_band_cdist(Ac, Bc, window, measure),
                     dtw_band_cdist_ref(Ac, Bc, window, measure))):
                max_abs, max_rel, ok = _errors(torch, got, want)
                cases.append({"L": L, "window": window, "measure": measure,
                              "form": form, "max_abs_err": max_abs,
                              "max_rel_err": max_rel, "agrees": ok})
                check(ok, f"dtw_band {form} {measure} L={L} w={window}")
    lut = randn(8, 256, 256).abs()
    ca = torch.randint(0, 256, (1024, 8), generator=g, device="cuda",
                       dtype=torch.int32)
    cb = torch.randint(0, 256, (6144, 8), generator=g, device="cuda",
                       dtype=torch.int32)
    max_abs, max_rel, ok = _errors(torch, adc_sym_cdist(ca, cb, lut),
                                   adc_sym_cdist_ref(ca, cb, lut))
    cases.append({"form": "adc_sym", "codes": [[1024, 8], [6144, 8]],
                  "max_abs_err": max_abs, "max_rel_err": max_rel,
                  "agrees": ok})
    check(ok, "adc_sym 1024 x 6144")
    X = torch.cumsum(randn(128, 512), dim=1)
    cents = randn(8, 32, 74)
    for measure in ("erp:g=0.3", "msm:c=0.5"):
        got = prealign_encode(X, cents, 3, 10, 7, measure)
        want = prealign_encode_ref(X, cents, 3, 10, 7, measure)
        ok = bool(torch.equal(got, want))
        cases.append({"L": 512, "window": 7, "measure": measure,
                      "form": "prealign_encode", "agrees": ok})
        check(ok, f"prealign_encode {measure}")
    emit({"phase": "measure_sweep", "tolerance": {"rtol": RTOL,
                                                  "atol": ATOL},
          "cases": cases})


if __name__ == "__main__":
    sys.exit(main())
