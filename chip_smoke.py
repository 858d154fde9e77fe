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
  and a snapshot must restore bit for bit;
- ``adaptive_path``: the same index state with ``band="adaptive"`` (the
  index path's quantizers, inserts and deletes), the 768 queries searched
  through ``StreamingIndex.search`` so that the hot scan refines inside
  per-pair corridors (width 32 at L=512, w=51); every refined pair is at
  or above its static cost; ``elastic_pairwise(band="adaptive")`` and
  ``certify_adaptive`` (the certified share printed, and how many
  certified pairs equal the static cost)
  on the 7680 pairs of each query and its static top 10; recall@10
  against the static search;
- ``quant_path``: ``pq.cdist_sym`` and ``dispatch.adc_lookup`` of the 768
  query codes / tables against the 6144 training codes with int8 and
  bfloat16 tables, each within 2% of the float32 maximum, with their 1-NN
  accuracy and agreement with float32.

Then it holds every kernel against its plain PyTorch version on the paths'
own tensors and times both.  ``lb_refine`` is checked twice over: on every
wave of both searches (a second, untimed run of each) its flags and
unrefined outputs are held against the plain bound, and on the first wave
and the first mixed wave (refined and pruned pairs) of each search its
whole output is held against the plain version.  ``lb_refine_adaptive``
is held the same way on the adaptive hot scan, its refined distances bit
for bit; ``dtw_band_adaptive`` and the quantised ADC kernels must equal
their plain versions exactly.

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
ADAPTIVE_WIDTH = 32       # tune.adaptive_width(512, 51) at lane 8
WARPED_PAIRS = 512        # time-warped pairs for the certificate's check
QUANT_MAX_REL = 0.02      # quantised ADC: the reference's bound against f32
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
    "dtw_band_adaptive": "src/repro/kernels/dtw_band/kernel.py:384",
    "lb_refine_adaptive": "src/repro/kernels/lb_cascade/kernel.py:138",
    "adc_sym_quant": "src/repro/kernels/pq_adc/kernel.py:151",
    "adc_lookup_quant": "src/repro/kernels/pq_adc/kernel.py:170",
}
SOURCES = {
    "dtw_band": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "dtw_band_cdist": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "adc_sym": "src/repro_torch/kernels/csrc/pq_adc.cu",
    "adc_lookup": "src/repro_torch/kernels/csrc/pq_adc.cu",
    "prealign_encode": "src/repro_torch/kernels/csrc/prealign_encode.cu",
    "lb_refine": "src/repro_torch/kernels/csrc/lb_cascade.cu",
    "dtw_band_adaptive": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "lb_refine_adaptive": "src/repro_torch/kernels/csrc/lb_cascade.cu",
    "adc_sym_quant": "src/repro_torch/kernels/csrc/pq_adc.cu",
    "adc_lookup_quant": "src/repro_torch/kernels/csrc/pq_adc.cu",
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
    ctx["adaptive_launches"] = adaptive_path(torch, _build, ctx, waves)
    ctx["quant_launches"] = quant_path(torch, _build, ctx)
    small_reference(torch)
    kernels = kernel_phases(torch, ctx)
    kernels.append(lb_refine_phases(torch, ctx, waves))
    kernels += adaptive_kernel_phases(torch, ctx, waves)
    kernels += quant_kernel_phases(torch, ctx)
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
    return dict(cfg=cfg, X=X, Xd=Xd, yd=yd, Qd=Qd, yq=yq, cb=cb, codes=codes,
                q_codes=q_codes, codes_fused=codes_fused, launches=launches,
                D=D, w_exact=w_exact)


# ---------------------------------------------------------------------------
# The search paths beyond 1-NN: exact LB-cascade search and the index
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def checked_waves(torch, lb_search, log: dict, extra=None):
    """Hook ``filtered_topk``'s ``lb_refine`` while the block runs.  Each
    wave still goes through the kernel once, as without the hook; then its
    pruning side is held against the plain bound (``lb.cascade_bound``):
    every flag equals ``bound < thresh`` apart from counted bound ties
    (within ``FLAG_TIE_REL`` of a finite threshold), a filler pair
    (``thresh = -inf``) never refines, and every unrefined pair returns its
    bound within ``rtol, atol``.  ``log`` gathers the counts over all waves
    and keeps the arguments of the first wave and of the first mixed wave
    (pairs refined and pairs pruned at their threshold; one that also
    carries filler where a wave does).  ``extra(args, d, f, kw)`` runs
    more checks on each wave."""
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
        if extra is not None:
            extra(args, d, f, kw)
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
    check(np.array_equal(ids, np.arange(N)), "insert ids are row numbers")
    ctx["index_state"] = dict(cfg=cfg, coarse=idx.coarse, cb=idx.cb,
                              two_level=idx.two_level, dead=dead,
                              static_d=d, static_i=i)
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
# The opt-in layer: adaptive corridors and quantised ADC tables
# ---------------------------------------------------------------------------

def _warped_pairs(torch, n, L, drift=3, seed=0):
    """Random walks and their copies under small monotone time warps plus
    noise (the reference's own generator for converging corridors)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    A = np.cumsum(rng.normal(size=(n, L)), axis=1).astype(np.float32)
    B = np.empty_like(A)
    for i in range(n):
        off = np.clip(np.cumsum(rng.integers(-1, 2, size=L)), -drift, drift)
        B[i] = A[i, np.clip(np.arange(L) + off, 0, L - 1)]
    B = (B + rng.normal(scale=0.05, size=B.shape)).astype(np.float32)
    return torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()


def adaptive_path(torch, _build, ctx, waves) -> dict:
    """``IndexConfig(band="adaptive")``: the index of ``index_path`` (its
    quantizers, the same inserts and deletes: 2 sealed segments and the
    hot buffer) searched with the 768 queries, so the hot scan refines
    inside per-pair corridors (``lb_refine_adaptive``); then
    ``elastic_pairwise(band="adaptive")`` and ``certify_adaptive`` on the
    7680 zipped pairs of each query and its static top 10.

    Checks: every adaptive wave's pruning side against the plain bound (as
    for ``lb_refine``); on every refined pair of the hot scan, on the 7680
    pairs and on time-warped pairs, adaptive >= static (``dtw_band`` on the
    same pairs, row 1); on the warped pairs the card's certificates equal
    the plain sweeps'.  Printed: recall@10 against the static search, and
    per pair set the certified share and how many certified pairs equal
    the static cost.  That count is not checked: the certificate (a
    re-sweep one cell wider) is the reference's heuristic, and it flags
    some pairs whose adaptive cost exceeds the static one, in the JAX
    package alike."""
    import numpy as np
    from repro_torch.core import corridor, dispatch, lb_search
    from repro_torch.index import StreamingIndex
    from repro_torch.kernels import tune
    from repro_torch.kernels.dtw_band.ops import dtw_band
    from repro_torch.kernels.dtw_band.ref import dtw_band_adaptive_ref

    X, Xd, Qd, D = ctx["X"], ctx["Xd"], ctx["Qd"], ctx["D"]
    st = ctx["index_state"]
    cfg = dataclasses.replace(st["cfg"], band="adaptive")
    w = cfg.coarse_window(D)
    width = tune.adaptive_width(D, w)
    check(width == ADAPTIVE_WIDTH, f"adaptive width {width} at L={D}, w={w}")
    seconds = {}
    _build.reset_launches()
    dispatch.reset_stats()
    idx = StreamingIndex.from_parts(cfg, st["coarse"], st["cb"], D,
                                    st["two_level"])
    ids, seconds["insert"] = _timed(torch, lambda: idx.insert(X))
    check(np.array_equal(ids, np.arange(len(X))), "insert ids")
    idx.delete(st["dead"])
    (d, i), seconds["search"] = _timed(torch, lambda: idx.search(
        Qd, n_probe=N_PROBE, topk=TOPK))
    si = st["static_i"]
    check(bool((si >= 0).all()), "static top-10 complete")
    qq = Qd.repeat_interleave(TOPK, dim=0).contiguous()
    xx = Xd[si.reshape(-1).long()].contiguous()
    (lo, hi), seconds["build_corridor"] = _timed(
        torch, lambda: corridor.build_corridor(qq, xx, w))
    d_pairs, seconds["elastic_pairwise_adaptive"] = _timed(
        torch, lambda: dispatch.elastic_pairwise(qq, xx, w, band="adaptive"))
    cert, seconds["certify_adaptive"] = _timed(
        torch, lambda: corridor.certify_adaptive(qq, xx, lo, hi, window=w,
                                                 width=width))
    launches = dict(_build.LAUNCHES)
    routes = sorted({r for _, r in dispatch.stats})
    for k in ("dtw_band_adaptive", "lb_refine_adaptive"):
        check(launches[k] > 0, f"adaptive path launched {k}: {launches}")
    check(launches["lb_refine"] == 0, "the adaptive search never ran the "
          "static cascade")
    check(routes == ["cuda"], f"adaptive path routes {routes}")
    check(tuple(d.shape) == (Qd.shape[0], TOPK)
          and bool(torch.isfinite(d).all()), "adaptive search: finite "
          "(Nq, topk) distances")
    check(not bool(torch.isin(i, torch.from_numpy(st["dead"]).to(
        i.device)).any()), "no deleted id is returned")
    recall = float(np.mean([len(set(a) & set(b)) / TOPK for a, b in zip(
        i.tolist(), si.tolist())]))

    # the 7680 pairs: adaptive >= static (row 1), certified share
    static = dtw_band(qq, xx, w)
    check(bool((d_pairs >= static).all()), "adaptive >= static on the "
          "7680 pairs")
    pairs = {"n": int(qq.shape[0]), "certified": int(cert.sum()),
             "certified_equal": int((d_pairs[cert] == static[cert]).sum()),
             "equal": int((d_pairs == static).sum()),
             "median_ratio": float((d_pairs / static).median()),
             "mean_corridor_width": float(corridor.corridor_width(
                 lo, hi).float().mean())}

    # the search again, untimed, with every wave checked
    hot = {"refined": 0, "certified": 0, "certified_equal": 0, "equal": 0}

    def per_wave(args, dw, fw, kw):
        A, B, _, _, _, win = args
        check(kw.get("band") == "adaptive", "the hot scan's band")
        if not bool(fw.any()):
            return
        A, B, dr = A[fw], B[fw], dw[fw]
        static_w = dtw_band(A, B, win)
        check(bool((dr >= static_w).all()), "hot scan: adaptive >= static "
              "on every refined pair")
        c = corridor.certify_adaptive(A, B, *corridor.build_corridor(
            A, B, win), window=win, width=width)
        for key, v in (("refined", int(fw.sum())), ("certified",
                       int(c.sum())), ("certified_equal",
                       int((dr[c] == static_w[c]).sum())),
                       ("equal", int((dr == static_w).sum()))):
            hot[key] += v

    with checked_waves(torch, lb_search, waves.setdefault("adaptive_hot", {}),
                       per_wave):
        d2, i2 = idx.search(Qd, n_probe=N_PROBE, topk=TOPK)
    check(torch.equal(d2, d) and torch.equal(i2, i), "the checked adaptive "
          "search equals the timed one")
    check(waves["adaptive_hot"]["totals"]["waves"]
          == launches["lb_refine_adaptive"], "one lb_refine_adaptive "
          "launch per wave")

    # the certificate on time-warped pairs, the reference tests' data: the
    # card's verdicts are the plain sweeps' (base == one cell wider)
    A, B = _warped_pairs(torch, WARPED_PAIRS, D)
    wl, wh = corridor.build_corridor(A, B, w)
    wa = dispatch.elastic_pairwise(A, B, w, band="adaptive",
                                   corridor=(wl, wh))
    ws = dtw_band(A, B, w)
    wc = corridor.certify_adaptive(A, B, wl, wh, window=w, width=width)
    check(bool((wa >= ws).all()), "warped: adaptive >= static")
    dl, dh = corridor.dilate(wl, wh, D, w)
    plain_wc = (dtw_band_adaptive_ref(A, B, *corridor.clip_to_width(
        wl, wh, width), w, width) == dtw_band_adaptive_ref(
        A, B, dl, dh, w, width + 2))
    check(torch.equal(wc, plain_wc), "warped: the card's certificates are "
          "the plain sweeps'")
    warped = {"n": WARPED_PAIRS, "certified": int(wc.sum()),
              "certified_equal": int((wa[wc] == ws[wc]).sum()),
              "equal": int((wa == ws).sum())}
    emit({"phase": "adaptive_path", "queries": list(Qd.shape),
          "hot_window": w, "width": width, "seconds": seconds,
          "recall_at_10_vs_static": recall, "pairs": pairs,
          "hot_refined": hot, "warped": warped, "launches": launches,
          "routes": routes})
    ctx["adaptive_pairs"] = (qq, xx, lo, hi, w, width)
    return launches


def quant_path(torch, _build, ctx) -> dict:
    """Quantised ADC tables on the main path's codes: ``pq.cdist_sym`` and
    ``dispatch.adc_lookup`` of the 768 queries against the 6144 training
    codes with ``lut_dtype`` int8 and bfloat16, each within the
    reference's bound against float32 (max error under 2% of the float32
    maximum), and the 1-NN predictions they give."""
    from repro_torch.core import dispatch, metrics, pq
    cfg, cb, D = ctx["cfg"], ctx["cb"], ctx["D"]
    q_codes, codes, yd, yq = (ctx["q_codes"], ctx["codes"], ctx["yd"],
                              ctx["yq"])
    luts = pq.query_lut_batch(pq.segment(ctx["Qd"], cfg), cb, cfg.window(D),
                              False, cfg.measure()).contiguous()
    ctx["query_luts"] = luts
    _build.reset_launches()
    dispatch.reset_stats()
    out, seconds = {}, {}
    for dt in ("int8", "bfloat16"):
        out[dt, "sym"], seconds[f"cdist_sym_{dt}"] = _timed(
            torch, lambda: pq.cdist_sym(q_codes, codes, cb.lut, lut_dtype=dt))
        out[dt, "lookup"], seconds[f"adc_lookup_{dt}"] = _timed(
            torch, lambda: dispatch.adc_lookup(codes, luts, lut_dtype=dt))
    launches = dict(_build.LAUNCHES)
    routes = sorted({r for _, r in dispatch.stats})
    check(launches["adc_sym_quant"] == 2 and launches["adc_lookup_quant"] == 2,
          f"quant path launched both quantised kernels: {launches}")
    check(routes == ["cuda"], f"quant path routes {routes}")
    full = {"sym": pq.cdist_sym(q_codes, codes, cb.lut),
            "lookup": dispatch.adc_lookup(codes, luts)}
    pred_f = yd[torch.argmin(full["sym"], 1)]
    result = {}
    for (dt, form), got in out.items():
        ref = full[form]
        rel = float((got - ref).abs().max() / (ref.abs().max() + 1e-6))
        check(tuple(got.shape) == tuple(ref.shape)
              and bool(torch.isfinite(got).all()), f"{dt} {form} shape")
        check(rel < QUANT_MAX_REL, f"{dt} {form}: max error {rel} of the "
              f"float32 maximum (bound {QUANT_MAX_REL})")
        pred = yd[torch.argmin(got, 1)]
        pred_full = yd[torch.argmin(ref, 1)] if form == "lookup" else pred_f
        result[f"{dt}_{form}"] = {
            "max_err_of_f32_max": rel,
            "accuracy": 1.0 - metrics.error_rate(yq, pred),
            "f32_accuracy": 1.0 - metrics.error_rate(yq, pred_full),
            "agreement_with_f32": float((pred == pred_full).float().mean())}
    emit({"phase": "quant_path", "codes": [list(q_codes.shape),
                                           list(codes.shape)],
          "lut": list(cb.lut.shape), "qluts": list(luts.shape),
          "seconds": seconds, "results": result, "launches": launches,
          "routes": routes})
    return launches


def _live_cells(torch, lo, hi) -> int:
    """DP cells a sweep of clipped corridors computes."""
    return int((hi - lo + 1).clamp(min=0).sum())


def adaptive_kernel_phases(torch, ctx, waves) -> list:
    """Rows 7-8 against their plain versions: ``dtw_band_adaptive`` on the
    7680 zipped pairs (timed beside ``dtw_band``, row 1, on the same
    pairs), ``lb_refine_adaptive`` on the adaptive hot scan's first wave
    and first mixed wave.  Both bit-identical where they refine; the
    flags of row 8 as for ``lb_refine`` (flips only at bound ties)."""
    from repro_torch.core import corridor
    from repro_torch.core.lb import cascade_bound
    from repro_torch.kernels.dtw_band.ops import (dtw_band, dtw_band_adaptive,
                                                  launch_dtw_band_adaptive)
    from repro_torch.kernels.dtw_band.ref import dtw_band_adaptive_ref
    from repro_torch.kernels.lb_cascade.ops import (launch_lb_refine_adaptive,
                                                    lb_refine)
    from repro_torch.kernels.lb_cascade.ref import lb_refine_ref
    launches = ctx["adaptive_launches"]
    rows = []
    qq, xx, lo, hi, w, width = ctx["adaptive_pairs"]
    clo, chi = corridor.clip_to_width(lo, hi, width)
    clo, chi = clo.contiguous(), chi.contiguous()
    n, L = qq.shape
    out = torch.empty(n, dtype=torch.float32, device=qq.device)
    static_ms = _mean_ms(torch, lambda: dtw_band(qq, xx, w), REPS)
    kernel_row(
        torch, launches, rows, "dtw_band_adaptive",
        {"pairs": [n, L], "window": w, "width": width,
         "static_dtw_band_ms": static_ms},
        lambda: dtw_band_adaptive(qq, xx, (clo, chi), width, w),
        lambda: dtw_band_adaptive_ref(qq, xx, clo, chi, w, width), None,
        n * (2 * L * 4 + 2 * (2 * L - 1) * 4 + 4),
        _live_cells(torch, clo, chi) * DTW_OPS_PER_CELL,
        launch_fn=lambda: (launch_dtw_band_adaptive(
            qq, xx, clo, chi, width, 0, None, out), out)[1], exact=True)

    log = waves["adaptive_hot"]
    check(log["totals"]["pruned"] > 0, "adaptive hot scan: some wave "
          "pruned pairs at their threshold")
    emit({"phase": "lb_refine_waves", "search": "adaptive_hot",
          **log["totals"],
          "unrefined_max_abs_err": log["unrefined_max_abs_err"][0]})
    mixed = log.get("mixed_filler", log.get("mixed"))
    check(mixed is not None, "adaptive hot scan: a wave both refined and "
          "pruned")
    for which, args in (("first", log["first"]), ("mixed", mixed)):
        A, B, up, lo_e, th, win = args
        n, L = A.shape
        cl, ch = corridor.clip_to_width(*corridor.build_corridor(A, B, win),
                                        width)
        cl, ch = cl.contiguous(), ch.contiguous()
        d, f = lb_refine(A, B, up, lo_e, th, win, corridor=(cl, ch),
                         width=width)
        torch.cuda.synchronize()
        (want_d, want_f), plain_ms = _sync_ms(torch, lambda: lb_refine_ref(
            A, B, up, lo_e, th, win, corridor=(cl, ch), width=width))
        lb = cascade_bound(B, A, up, lo_e)
        flips, near = _flag_flips(torch, f, lb, th,
                                  f"lb_refine_adaptive {which}")
        both = f & want_f
        check(torch.equal(d[both], want_d[both]), f"lb_refine_adaptive "
              f"{which}: refined distances bit-identical")
        agree = ~flips
        max_abs, max_rel, ok = _errors(torch, d[agree], want_d[agree])
        check(ok, f"lb_refine_adaptive {which}: distances agree where "
              "flags agree")
        filler = th == -float("inf")
        n_refined, n_filler = int(f.sum()), int(filler.sum())
        n_pruned = n - n_refined - n_filler
        if which == "mixed":
            check(0 < n_refined < n and n_pruned > 0,
                  "lb_refine_adaptive: the mixed wave refines and prunes")
        d_out = torch.empty_like(d)
        flag = torch.empty(n, dtype=torch.int32, device=A.device)
        ms = _mean_ms(torch, lambda: launch_lb_refine_adaptive(
            A, B, up, lo_e, th, cl, ch, width, d_out, flag), REPS)
        check(torch.equal(flag.bool(), f) and torch.equal(d_out, d),
              f"lb_refine_adaptive {which}: the launch alone equals the "
              "wrapper")
        wrapper_ms = _mean_ms(torch, lambda: lb_refine(
            A, B, up, lo_e, th, win, corridor=(cl, ch), width=width), REPS)
        bound_ms, bound_by = bound(
            n * (16 * L + 12 + 2 * (2 * L - 1) * 4),
            n * 5 * L + _live_cells(torch, cl[f], ch[f]) * DTW_OPS_PER_CELL)
        row = {"name": "lb_refine_adaptive", "route": "cuda",
               "source": SOURCES["lb_refine_adaptive"],
               "replaces": TPU_SITES["lb_refine_adaptive"],
               "launches": launches["lb_refine_adaptive"],
               "max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": None}
        emit({"phase": "kernel", **row, "wave": f"adaptive_hot {which}",
              "shapes": {"pairs": [n, L], "window": win, "width": width},
              "n_refined": n_refined, "n_pruned": n_pruned,
              "n_filler": n_filler, "flag_ties": int(flips.sum()),
              "near_threshold": int(near.sum()), "wrapper_ms": wrapper_ms,
              "max_rel_err": max_rel, "agrees": ok,
              "in_table": which == "first",
              "tolerance": {"refined": "identical", "rtol": RTOL,
                            "atol": ATOL, "flag_tie_rel": FLAG_TIE_REL}})
        if which == "first":
            rows.append(row)
    return rows


def quant_kernel_phases(torch, ctx) -> list:
    """Rows 9-10 against their plain versions (dequantise, then gather) on
    the quant path's tensors, int8 (the table's record) and bfloat16:
    identical outputs.  ``library_ms``: one PyTorch gather-and-sum on the
    dequantised table."""
    from repro_torch.kernels.pq_adc.ops import (
        adc_lookup_quant, adc_sym_cdist_quant, launch_adc_lookup_quant,
        launch_adc_sym_quant, quantize_lut)
    from repro_torch.kernels.pq_adc.ref import (
        adc_lookup_quant_ref, adc_sym_cdist_quant_ref, dequantize)
    launches = ctx["quant_launches"]
    cb, luts = ctx["cb"], ctx["query_luts"]
    q_codes, codes = ctx["q_codes"].contiguous(), ctx["codes"].contiguous()
    (Nq, M), N, K = q_codes.shape, codes.shape[0], cb.lut.shape[1]
    dev = codes.device
    m_idx = torch.arange(M, device=dev)[:, None, None]
    qa, tb = q_codes.long().T[:, :, None], codes.long().T[:, None, :]
    m_row = torch.arange(M, device=dev)[None, :]
    codes_l = codes.long()
    rows = []
    for dt in ("int8", "bfloat16"):
        table = dt == "int8"
        q, sc, zp = quantize_lut(cb.lut, dt)
        scv, zpv = sc.reshape(M).contiguous(), zp.reshape(M).contiguous()
        deq = dequantize(q, sc, zp)
        size = q.element_size()
        sym_out = torch.empty((Nq, N), dtype=torch.float32, device=dev)
        kernel_row(
            torch, launches, rows if table else [], "adc_sym_quant",
            {"codes_a": [Nq, M], "codes_b": [N, M], "lut": [M, K, K],
             "dtype": dt},
            lambda: adc_sym_cdist_quant(q_codes, codes, q, sc, zp),
            lambda: adc_sym_cdist_quant_ref(q_codes, codes, q, sc, zp),
            lambda: torch.sqrt(deq[m_idx, qa, tb].sum(0).clamp_min(0.0)),
            (Nq + N) * M * 4 + M * K * K * size + 2 * M * 4 + Nq * N * 4,
            Nq * N * (3 * M + 2),
            launch_fn=lambda: (launch_adc_sym_quant(
                q_codes, codes, q, scv, zpv, sym_out), sym_out)[1],
            table=table, exact=True)
        qq, qs, qz = quantize_lut(luts.reshape(Nq * M, K), dt)
        qq = qq.reshape(Nq, M, K).contiguous()
        qs, qz = qs.reshape(Nq, M, 1), qz.reshape(Nq, M, 1)
        qsv, qzv = qs.reshape(-1).contiguous(), qz.reshape(-1).contiguous()
        qdeq = dequantize(qq, qs, qz)
        lookup_out = torch.empty((Nq, N), dtype=torch.float32, device=dev)
        kernel_row(
            torch, launches, rows if table else [], "adc_lookup_quant",
            {"qlut": [Nq, M, K], "codes": [N, M], "dtype": dt},
            lambda: adc_lookup_quant(codes, qq, qs, qz),
            lambda: adc_lookup_quant_ref(codes, qq, qs, qz),
            lambda: torch.sqrt(qdeq[:, m_row, codes_l].sum(-1).clamp_min(
                0.0)),
            Nq * M * K * size + 2 * Nq * M * 4 + N * M * 4 + Nq * N * 4,
            Nq * N * (3 * M + 2),
            launch_fn=lambda: (launch_adc_lookup_quant(
                codes, qq, qsv, qzv, lookup_out), lookup_out)[1],
            table=table, exact=True)
    return rows


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


def kernel_row(torch, launches, rows, name, shapes, kernel_fn, plain_fn,
               library_fn, nbytes, ops, launch_fn=None, table=True,
               exact=False):
    """Hold one kernel against its plain version and time both.
    ``launch_fn``: the launch alone, returning its output, where the
    wrapper does more than launch (a range check); ``table=False``: a
    second shape of a kernel already in the table, printed as a phase line
    only; ``exact``: the outputs must be identical (max abs error 0)."""
    got = kernel_fn()
    torch.cuda.synchronize()
    want, plain_ms = _sync_ms(torch, plain_fn)
    max_abs, max_rel, ok = _errors(torch, got, want)
    if exact:
        ok = bool(torch.equal(got, want))
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
           "replaces": TPU_SITES[name], "launches": launches[name],
           "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    emit({"phase": "kernel", **row, "shapes": shapes,
          "wrapper_ms": wrapper_ms, "max_rel_err": max_rel, "agrees": ok,
          "in_table": table,
          "tolerance": ("identical" if exact or got.dtype == torch.int32
                        else {"rtol": RTOL, "atol": ATOL})})
    check(ok, f"{name} {shapes} agrees with its plain version")
    if table:
        rows.append(row)
    return got


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

    def phase(*args, **kw):
        return kernel_row(torch, ctx["launches"], rows, *args, **kw)

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
