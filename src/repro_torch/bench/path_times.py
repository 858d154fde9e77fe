"""Wall times of the smoke's two longest host-bound calls, for comparing
trees of this package on one card: ``pq.fit`` at the main path's size
(6144 CBF series, L=512, ``PQConfig()``) and ``StreamingIndex.bootstrap``
at the index path's size (the same series, ``n_lists=64``,
``hot_capacity=2560``), plus the per-call cost of the dispatch and launch
counters (``dispatch._count``, ``_build.count_launch``) on one thread.

``--src DIR`` imports ``repro_torch`` from ``DIR`` instead of this
checkout, so one command can time an older tree with the same script;
run the trees alternately in one call (A, B, B, A) and compare them only
within it:

    python src/repro_torch/bench/path_times.py --src /path/to/tree/src \\
        --label parent [--out results.jsonl]

Each run prints one JSON line: the label, the card's ``nvidia-smi`` name
and power limit, ``fit_s``, ``bootstrap_s``, ``count_ns`` and
``count_launch_ns``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _per_call_ns(fn, n: int) -> float:
    start = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - start) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[2]),
                    help="the directory that holds repro_torch")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None,
                    help="append the JSON line to this file too")
    ap.add_argument("--counts", type=int, default=200_000,
                    help="calls of each counter to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("path_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import dispatch, pq
    from repro_torch.data.timeseries import make_dataset
    from repro_torch.index import IndexConfig, StreamingIndex
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    X, _ = make_dataset("cbf", 2048, 512, seed=0)
    Xd = torch.from_numpy(X).cuda()

    def timed(fn):
        # repro: ignore[RS101] benchmark timing: the clock is read once the card is done
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        # repro: ignore[RS101] benchmark timing: the clock is read once the card is done
        torch.cuda.synchronize()
        return time.perf_counter() - start

    fit_s = timed(lambda: pq.fit(Xd, pq.PQConfig(),
                                 torch.Generator().manual_seed(0)))
    icfg = IndexConfig(pq.PQConfig(), n_lists=64, hot_capacity=2560)
    bootstrap_s = timed(lambda: StreamingIndex.bootstrap(
        torch.Generator().manual_seed(0), Xd, icfg))
    count_ns = _per_call_ns(lambda: dispatch._count("path_times", "cuda"),
                            args.counts)
    launch_ns = _per_call_ns(lambda: _build.count_launch("dtw_band"),
                             args.counts)
    line = json.dumps({"label": args.label, "src": args.src,
                       "nvidia_smi": _smi(), "build_s": build_s,
                       "fit_s": fit_s, "bootstrap_s": bootstrap_s,
                       "count_ns": count_ns, "count_launch_ns": launch_ns})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
