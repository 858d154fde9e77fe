"""The traced run's profiler slice and its reduction.

``Tracer`` runs ``torch.profiler`` (host and device activities) over a
bounded slice of the window: the profiler starts ``PAD_S`` before the
slice and stops ``PAD_S`` after it, since it drops device records whose
converted timestamps fall outside its own window, and the slice itself
is a host annotation (``portbench.slice``).  The trace is exported to a
temporary file under ``TMPDIR``, read back and deleted.

``Slice`` holds what the readers need: every device activity (kernels,
copies, fills) that started inside the slice, the union of their
intervals (``busy_s``), the slice's length (``window_s``), the device
operations that took most time, and the idle time between device
activities by what the host was doing (the innermost host event that
spans the middle of the gap, on any thread the trace holds, else the
last CUDA runtime call before it).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

__all__ = ["PAD_S", "SLICE_NAME", "Tracer", "Slice", "kernel_base",
           "hand_written_kernels", "reduce_trace"]

PAD_S = 0.05
# the profiler starts this long before the slice: its first start can
# take a second (the device tracer's set-up), and the slice opens no
# sooner than PAD_S after it is up
PREROLL_S = 1.5
SLICE_NAME = "portbench.slice"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function"}
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


class Activity(NamedTuple):
    name: str
    base: str       # the kernel's function name without namespace/template
    cat: str
    ts: float       # microseconds, the trace's clock
    dur: float


class Slice(NamedTuple):
    t0: float
    t1: float
    device: List[Activity]
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def kernels(self, *parts: str) -> List[Activity]:
        """Kernels whose function name contains any of ``parts``."""
        return [a for a in self.device if a.cat == "kernel"
                and any(p in a.base for p in parts)]


def kernel_base(name: str) -> str:
    """``void ns::fn<T, 4>(float const*, ...)`` -> ``fn``."""
    s = name[5:] if name.startswith("void ") else name
    s = s.replace("(anonymous namespace)", "anonymous")
    depth, out = 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip().split("::")[-1]


def hand_written_kernels(csrc: Path) -> frozenset:
    """Names of the ``__global__`` functions in the program's CUDA
    sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)


def _short(name: str) -> str:
    s = name[5:] if name.startswith("void ") else name
    return s[:96]


def _union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _label_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the host event spanning each gap's middle."""
    host = sorted(host, key=lambda e: e[1])
    runtime = [e for e in host if e[3] == "cuda_runtime"]
    out: Dict[str, float] = defaultdict(float)
    active: list = []
    k = r = 0
    last_rt: Optional[str] = None
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        while k < len(host) and host[k][1] <= mid:
            active.append(host[k])
            k += 1
        active = [e for e in active if e[1] + e[2] >= mid]
        while r < len(runtime) and runtime[r][1] + runtime[r][2] <= a:
            last_rt = runtime[r][0]
            r += 1
        if active:
            label = max(active, key=lambda e: e[1])[0]
        else:
            label = f"host after {last_rt}" if last_rt else "host"
        out[label[:96]] += (b - a) * 1e-6
    return out


def reduce_trace(events: List[dict], top: int = 10) -> Optional[Slice]:
    """The slice of a chrome trace's events, or None when it holds no
    slice annotation."""
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("name") == SLICE_NAME
             and e.get("cat", "").lower() == "user_annotation"]
    if not marks:
        return None
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "").lower()
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS and t0 <= ts < t1:
            base = kernel_base(e["name"]) if cat == "kernel" else e["name"]
            device.append(Activity(e["name"], base, cat, ts, dur))
        elif cat in HOST_CATS and e.get("name") != SLICE_NAME \
                and ts < t1 and ts + dur > t0:
            host.append((e["name"], ts, dur, cat))
    busy = _union((a.ts, min(a.ts + a.dur, t1)) for a in device)
    busy_us = sum(b - a for a, b in busy)
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if prev < t1:
        gaps.append((prev, t1))
    per_op: Dict[str, float] = defaultdict(float)
    for a in device:
        per_op[_short(a.name)] += a.dur * 1e-6
    idle = _label_gaps(gaps, host)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return Slice(t0, t1, device, busy_us * 1e-6, (t1 - t0) * 1e-6,
                 [list(kv) for kv in rank(per_op)],
                 [list(kv) for kv in rank(idle)])


class Tracer:
    """Starts and stops the profiler and the slice at planned host times
    (``time.perf_counter``), from whichever thread calls :meth:`tick`."""

    def __init__(self, enabled: bool, slice_start: float, slice_s: float):
        self.enabled = enabled
        self.slice_s = slice_s
        self.plan = [slice_start - PREROLL_S, slice_start,
                     slice_start + slice_s, slice_start + slice_s + PAD_S]
        self.stage = 0
        self.prof = None
        self.mark = None
        self.slice_host: Optional[Tuple[float, float]] = None
        self.prof_host: List[float] = []
        self.result: Optional[Slice] = None

    def tick(self, now: float) -> None:
        if not self.enabled:
            return
        while self.stage < 4 and now >= self.plan[self.stage]:
            self._advance()
            now = time.perf_counter()

    def _advance(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        now = time.perf_counter()
        if self.stage == 0:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.prof_host.append(now)
            up = time.perf_counter() + PAD_S
            if up > self.plan[1]:
                self.plan[1:] = [up, up + self.slice_s,
                                 up + self.slice_s + PAD_S]
        elif self.stage == 1:
            self.mark = record_function(SLICE_NAME)
            self.mark.__enter__()
            self.slice_host = (now, now)
        elif self.stage == 2:
            self.mark.__exit__(None, None, None)
            self.slice_host = (self.slice_host[0], time.perf_counter())
        else:
            self.prof.__exit__(None, None, None)
            self.prof_host.append(time.perf_counter())
            self.result = self._read()
        self.stage += 1

    def finish(self) -> None:
        """Close whatever is still open (a window shorter than planned)."""
        if self.enabled:
            while 0 < self.stage < 4:
                self._advance()

    def _read(self) -> Optional[Slice]:
        fd, path = tempfile.mkstemp(prefix="portbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        return reduce_trace(events)
