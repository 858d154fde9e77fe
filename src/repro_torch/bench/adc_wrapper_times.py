"""Times of the four ADC wrappers (kernel table rows 3, 4, 9 and 10) at
the main path's shapes, for comparing trees of this package on one card:
768 query codes against 6144 codes, M = 8 sub-series, K = 256 centroids;
the symmetric ops through an (8, 256, 256) table, the lookups through
(768, 8, 256) query tables, the quantised ops through int8 tables.

For each op: ``wrapper_ms``, the wrapper call (in trees where the wrapper
checks the codes' range on every call, that check included;
``chip_smoke.py`` prints it as a kernel record's ``wrapper_ms``);
``launch_ms``, the launch alone into an output made beforehand (the
record's ``ms``); ``check_ms``, the range check alone (``check_codes``,
or ``_check_range`` in older trees), which newer trees run where codes
enter the program, not in the wrapper.
Each is the mean of ``--reps`` back-to-back calls after one warm-up call,
by CUDA events, taken ``--blocks`` times; the line gives every block.

``--src DIR`` imports ``repro_torch`` from ``DIR`` instead of this
checkout, so one command can time an older tree with the same script;
run the trees alternately in one call (A, B, B, A) and compare them only
within it:

    python src/repro_torch/bench/adc_wrapper_times.py --src /path/to/tree/src \\
        --label parent [--out results.jsonl]

Each run prints one JSON line: the label, the card's ``nvidia-smi`` name
and power limit, and the three times of each op.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

NQ, N, M, K = 768, 6144, 8, 256


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _mean_ms(torch, fn, reps: int) -> float:
    fn()
    # repro: ignore[RS101] benchmark timing: the card is idle before the first event
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    # repro: ignore[RS101] benchmark timing: the events are read once the card is done
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[2]),
                    help="the directory that holds repro_torch")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None,
                    help="append the JSON line to this file too")
    ap.add_argument("--reps", type=int, default=100,
                    help="back-to-back calls a block")
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("adc_wrapper_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.pq_adc import ops

    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q_codes = torch.randint(0, K, (NQ, M), generator=gen, device="cuda",
                            dtype=torch.int32)
    codes = torch.randint(0, K, (N, M), generator=gen, device="cuda",
                          dtype=torch.int32)
    lut = torch.rand((M, K, K), generator=gen, device="cuda")
    luts = torch.rand((NQ, M, K), generator=gen, device="cuda")
    q, sc, zp = ops.quantize_lut(lut, "int8")
    scv, zpv = sc.reshape(M).contiguous(), zp.reshape(M).contiguous()
    qq, qs, qz = ops.quantize_lut(luts.reshape(NQ * M, K), "int8")
    qq = qq.reshape(NQ, M, K).contiguous()
    qs, qz = qs.reshape(NQ, M, 1), qz.reshape(NQ, M, 1)
    qsv, qzv = qs.reshape(-1).contiguous(), qz.reshape(-1).contiguous()
    out = torch.empty((NQ, N), dtype=torch.float32, device="cuda")
    check = getattr(ops, "check_codes", None) or ops._check_range
    sym_check = lambda: check(K, codes_a=q_codes, codes_b=codes)
    lookup_check = lambda: check(K, codes=codes)
    cases = {
        "adc_sym": (lambda: ops.adc_sym_cdist(q_codes, codes, lut),
                    lambda: ops.launch_adc_sym(q_codes, codes, lut, out),
                    sym_check),
        "adc_lookup": (lambda: ops.adc_lookup(codes, luts),
                       lambda: ops.launch_adc_lookup(codes, luts, out),
                       lookup_check),
        "adc_sym_quant": (
            lambda: ops.adc_sym_cdist_quant(q_codes, codes, q, sc, zp),
            lambda: ops.launch_adc_sym_quant(q_codes, codes, q, scv, zpv,
                                             out),
            sym_check),
        "adc_lookup_quant": (
            lambda: ops.adc_lookup_quant(codes, qq, qs, qz),
            lambda: ops.launch_adc_lookup_quant(codes, qq, qsv, qzv, out),
            lookup_check),
    }
    times = {}
    for name, fns in cases.items():
        times[name] = {
            key: [_mean_ms(torch, fn, args.reps) for _ in range(args.blocks)]
            for key, fn in zip(("wrapper_ms", "launch_ms", "check_ms"), fns)}
    line = json.dumps({"label": args.label, "src": args.src,
                       "nvidia_smi": _smi(), "reps": args.reps,
                       "shapes": {"Nq": NQ, "N": N, "M": M, "K": K},
                       "times": times})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
