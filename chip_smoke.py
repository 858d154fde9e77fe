#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, drives
the paper's main path once through the user-facing entry points at a
FordA-scale collection (UCR FordA is 3601 x 500; here 6144 x 512 training
series and 768 queries with the default ``PQConfig``: M=8, K=256, S=74,
window 7), then holds every kernel against its plain PyTorch version on the
main path's own tensors and times both.

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

import dataclasses
import json
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
TRAIN_PER_CLASS = 2048    # CBF series per class in the training set (x3)
QUERIES_PER_CLASS = 256   # CBF series per class in the query set (x3)
EXACT_QUERIES = 128       # queries for the exact elastic 1-NN
EXACT_CHECK_QUERIES = 16  # of those, held against the plain version
REPS = 5                  # timed repetitions per kernel
TPU_SITES = {
    "dtw_band": "src/repro/kernels/dtw_band/kernel.py:384",
    "dtw_band_cdist": "src/repro/kernels/dtw_band/kernel.py:411",
    "adc_sym": "src/repro/kernels/pq_adc/kernel.py:118",
    "adc_lookup": "src/repro/kernels/pq_adc/kernel.py:135",
    "prealign_encode": "src/repro/kernels/prealign_encode/kernel.py:133",
}
SOURCES = {
    "dtw_band": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "dtw_band_cdist": "src/repro_torch/kernels/csrc/dtw_band.cu",
    "adc_sym": "src/repro_torch/kernels/csrc/pq_adc.cu",
    "adc_lookup": "src/repro_torch/kernels/csrc/pq_adc.cu",
    "prealign_encode": "src/repro_torch/kernels/csrc/prealign_encode.cu",
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
    small_reference(torch)
    kernels = kernel_phases(torch, ctx)
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
    check(all(n > 0 for n in launches.values()),
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
    return dict(cfg=cfg, Xd=Xd, Qd=Qd, cb=cb, codes=codes, q_codes=q_codes,
                codes_fused=codes_fused, launches=launches, D=D,
                w_exact=w_exact)


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
