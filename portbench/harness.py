"""One run of one cell: set-up, the measured window, the traced slice, the
check against the reference, and the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (obs on, the profiler over a slice of the window).
Both check the answers: the numbers compared, each with its limit, are
the last lines on standard error and the last key of the result, the
JSON object on the last line of standard output.  Without a CUDA device
(or fewer than the cell asks for), the run exits 2 and prints no result;
if the JAX package or JAX itself is loaded once the window has closed,
it exits 3.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time
from typing import Dict, Optional

from .imports import forbidden_modules
from .manifest import ROOT, load_cell, load_manifest, load_reader
from .trace import Tracer, hand_written_kernels

__all__ = ["main", "run_cell", "process_age_s", "prepare_env"]

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
CACHE_DIR = ROOT / "build" / "portbench"


def process_age_s() -> Optional[float]:
    """Seconds since this process started (the kernel's own record)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def prepare_env() -> None:
    """The program runs with obs and the tuner off, and every compiler
    cache it or PyTorch may write at a fixed path inside the checkout."""
    for var in ("REPRO_OBS", "REPRO_OBS_DUMP", "REPRO_TUNE",
                "REPRO_TUNE_OUT", "REPRO_TUNE_GRID"):
        os.environ.pop(var, None)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


class _Ctx:
    """What a per-layer reader gets (portbench/readers.py)."""

    def __init__(self, cell, entry, slice_, stats):
        self.cell = cell.name
        self.config = entry.config
        self.geo = entry.geo
        self.slice = slice_
        self.stats = stats
        self.hand_written = hand_written_kernels(CSRC)


def _plain(x):
    """JSON numbers as measured; infinities as strings."""
    if isinstance(x, float) and x != x or x in (float("inf"), float("-inf")):
        return str(x)
    return x


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: Optional[dict] = None,
             t_start: Optional[float] = None, fault=None, out=None,
             err=None) -> Dict:
    """Run one cell once; returns the result (also printed).  ``overrides``
    merges into the configuration (the CPU tests' small sizes); ``fault``
    is called with the entry after set-up (the tests' broken timed
    paths)."""
    import torch
    out = out or sys.stdout
    err = err or sys.stderr
    manifest = load_manifest()
    cell = load_cell(workload, manifest)
    config = _merge(cell.config, overrides or {})
    entry_mod = importlib.import_module(
        f"portbench.entries.{cell.traffic['entry']}")
    entry = entry_mod.Cell(config, cell.traffic, int(seed), device)
    slice_s = min(float(cell.workload["trace_slice_s"]), seconds / 3.0)
    on_device = torch.device(device).type == "cuda"
    if on_device:
        torch.cuda.reset_peak_memory_stats()

    t_begin = time.perf_counter()
    entry.setup()
    if trace:
        # the profiler's first session in a process takes seconds to come
        # up: spend it here, on one more warm call, not in the window
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_device else [])
        with profile(activities=acts):
            entry.warm()
    if fault is not None:
        fault(entry)
    if on_device:
        torch.cuda.synchronize()
    t_window = time.perf_counter()
    age = process_age_s() if t_start is not None else None
    setup_s = age if age is not None else t_window - (t_start or t_begin)
    tracer = Tracer(trace, t_window + seconds - slice_s - 0.3, slice_s)
    entry.run_window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if on_device else 0
    e2e = entry.end_to_end()
    stats = entry.reader_stats(tracer)
    attempted, failed = entry.attempted(), entry.failed()
    entry.release()
    gc.collect()
    if on_device:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = entry.check()
    check_s = time.perf_counter() - t_check
    limits = cell.workload["limits"]
    correct = failed == 0 and all(checks[k] <= limits[k] for k in limits)

    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=err)
        raise SystemExit(3)

    metrics = {}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if not trace:
        values = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": _plain(values[m["name"]]),
                                  "unit": m["unit"]}
    else:
        ctx = _Ctx(cell, entry, tracer.result, stats)
        for m in cell.per_layer:
            reader = load_reader(m["name"])
            if reader.MOVES != m["moves"]:
                raise RuntimeError(f"{m['name']}: reader moves "
                                   f"{reader.MOVES}, manifest {m['moves']}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if on_device else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_device else "cpu",
           "count": cell.chips if on_device else 0,
           "memory_peak_bytes": int(peak)}
    if trace and tracer.result is not None:
        dev["busy_s"] = tracer.result.busy_s
        dev["window_s"] = tracer.result.window_s
        result["breakdown"] = {"device_ops": tracer.result.device_ops,
                               "idle_gaps": tracer.result.idle_gaps}
    result["device"] = dev
    result["checks"] = {k: {"value": _plain(checks[k]), "limit": limits[k]}
                        for k in limits}
    if getattr(entry, "error", None):
        print(f"portbench: {entry.error}", file=err)
    print(f"portbench: setup {setup_s:.3f} s, window {seconds} s, "
          f"check {check_s:.3f} s", file=err)
    print(f"portbench: {cell.name} seed {seed} "
          f"{json.dumps({k: _plain(v) for k, v in stats.items() if isinstance(v, (int, float))})}",
          file=err)
    for k in limits:
        print(f"check {k} {checks[k]!r} limit {limits[k]!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = _args(argv)
    prepare_env()
    import torch
    cell = load_cell(args.workload, load_manifest())
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
             t_start=t_start)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
