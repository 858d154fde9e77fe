"""The program's stage spans in a traced slice, and the device work each
one launched.

The program marks its stages with ``torch.profiler.record_function``
(``repro_torch.obs.span``; with obs off only while a profiler records).
Those marks and the CUDA runtime and driver calls share the profiler's
host clock.  A device activity (kernel, copy, fill) carries the
``correlation`` id of the call that launched it, so it belongs to the
spans that held that call on the same thread.  The attribution never
compares device time with host time, whose conversion drifts by
milliseconds.

:func:`attribute` reduces a chrome trace's events beside
:func:`portbench.trace.reduce_trace` and leaves that reduction as it is.
The functions after it compute the per-layer quantities of the classify
cells from an :class:`Attribution`.

Run as a tool, from the root of a checkout, on a CUDA device:

    PYTHONPATH=src python3 -m portbench.spans --workload <cell> \\
        --seed <n> [--batches 20] [--out <file.json>]

It sets the cell up as a run does, traces ``--batches`` whole batches in
a slice, and prints one JSON object: each span's device ms, launches
and idle time a batch, the cell's per-layer metrics read from the same
trace, the checks of the attribution, and what a span costs on the host
with obs off, under the profiler and with obs on.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from .trace import DEVICE_CATS, SLICE_NAME, Activity, Slice

__all__ = ["LAUNCH_CATS", "ROOT_SPAN", "STAGE_SPANS", "Span", "Launched",
           "Attribution", "attribute", "stage_ms", "lb_filter_roofline",
           "idle_pct_inside"]

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the classify path's spans (src/repro_torch/core/knn.py, core/pq.py)
ROOT_SPAN = "classify.sym"
STAGE_SPANS = ("pq.encode.prealign", "pq.encode.lb_filter",
               "pq.encode.pairs", "pq.encode.refine", "pq.adc",
               "classify.nearest")


class Span(NamedTuple):
    name: str
    ts: float       # microseconds, the trace's host clock
    dur: float
    tid: int


class Launched(NamedTuple):
    activity: Activity
    ts: Optional[float]     # the launching call's start; None if unseen
    dur: Optional[float]    # the launching call's length
    tid: Optional[int]


def _overlap(intervals: Iterable[Tuple[float, float]],
             union: List[Tuple[float, float]]) -> float:
    """Length of ``intervals`` (disjoint) inside the sorted disjoint
    ``union``."""
    starts = [u[0] for u in union]
    total = 0.0
    for a, b in intervals:
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        for ua, ub in union[k:]:
            if ua >= b:
                break
            total += max(0.0, min(b, ub) - max(a, ua))
    return total


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Attribution(NamedTuple):
    slice: Slice
    spans: List[Span]           # program annotations overlapping the slice
    launched: List[Launched]    # every device activity of the slice

    def instances(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def launched_in(self, name: str) -> List[Activity]:
        """Device activities whose launch lies inside an instance of span
        ``name`` on the launching thread."""
        by_tid: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
        for s in self.instances(name):
            by_tid[s.tid].append((s.ts, s.ts + s.dur))
        starts = {t: sorted(v) for t, v in by_tid.items()}
        out = []
        for x in self.launched:
            iv = starts.get(x.tid) if x.ts is not None else None
            if not iv:
                continue
            k = bisect.bisect_right(iv, (x.ts, float("inf"))) - 1
            if k >= 0 and iv[k][0] <= x.ts < iv[k][1]:
                out.append(x.activity)
        return out

    def unattributed(self) -> List[Activity]:
        """Device activities whose launching call is not in the trace."""
        return [x.activity for x in self.launched if x.ts is None]

    def idle_intervals(self) -> List[Tuple[float, float]]:
        """The slice's stretches with no device activity, as
        ``reduce_trace`` forms them."""
        s = self.slice
        busy = _union((a.ts, min(a.ts + a.dur, s.t1)) for a in s.device)
        gaps, prev = [], s.t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if prev < s.t1:
            gaps.append((prev, s.t1))
        return gaps

    def host_idle_intervals(self) -> List[Tuple[float, float]]:
        """The same stretches placed on the host's clock.  A stretch that
        a launched activity ends, ends where its launching call ended: an
        idle device starts what it is given within microseconds, so no
        device time is converted.  A stretch with no such launch (the
        slice's last) keeps the trace's time."""
        s = self.slice
        out, prev = [], s.t0
        for x in sorted(self.launched, key=lambda x: x.activity.ts):
            a = x.activity
            if a.ts > prev:
                if x.ts is None:
                    out.append((prev, a.ts))
                else:
                    end = x.ts + x.dur
                    out.append((end - (a.ts - prev), end))
            prev = max(prev, min(a.ts + a.dur, s.t1))
        if prev < s.t1:
            out.append((prev, s.t1))
        return out

    def idle_inside_s(self, name: str) -> float:
        """Seconds of the slice in which the device is idle while the host
        is inside an instance of span ``name`` (on any thread), from
        :meth:`host_idle_intervals`."""
        held = _union((x.ts, x.ts + x.dur) for x in self.instances(name))
        return _overlap(self.host_idle_intervals(), held) * 1e-6


def attribute(events: List[dict], sl: Slice) -> Attribution:
    """The program's spans and the launch of each of ``sl.device``, for
    the slice ``sl`` that ``reduce_trace(events)`` gave."""
    t0, t1 = sl.t0, sl.t1
    launch: Dict[int, Tuple[float, float, int]] = {}
    spans: List[Span] = []
    corrs: List[Optional[int]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "").lower()
        ts, dur = float(e["ts"]), float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in LAUNCH_CATS and corr is not None:
            launch[int(corr)] = (ts, dur, e.get("tid"))
        elif cat == "user_annotation" and e.get("name") != SLICE_NAME \
                and ts < t1 and ts + dur > t0:
            spans.append(Span(e["name"], ts, dur, e.get("tid")))
        elif cat in DEVICE_CATS and t0 <= ts < t1:
            # the same activities, in the same order, as reduce_trace's
            corrs.append(None if corr is None else int(corr))
    if len(corrs) != len(sl.device):
        raise ValueError(f"{len(corrs)} device activities in the events, "
                         f"{len(sl.device)} in the slice")
    launched = [Launched(a, *launch.get(c, (None, None, None)))
                for a, c in zip(sl.device, corrs)]
    spans.sort(key=lambda s: s.ts)
    return Attribution(sl, spans, launched)


# -- the per-layer quantities --------------------------------------------------

def stage_ms(att: Optional[Attribution], name: str,
             batches: Optional[int]) -> Optional[float]:
    """Device ms a batch launched inside span ``name``; None without the
    span or the batches."""
    if att is None or not batches or not att.instances(name):
        return None
    return sum(a.dur for a in att.launched_in(name)) * 1e-3 / batches


def lb_filter_roofline(att: Optional[Attribution], bound_s: float,
                       batches: Optional[int]) -> Optional[float]:
    """``bound_s`` (a batch's LB filter at the cell's shapes) times the
    batches, over the device time launched in ``pq.encode.lb_filter``, in
    percent."""
    if att is None or not batches:
        return None
    us = sum(a.dur for a in att.launched_in("pq.encode.lb_filter"))
    return 100.0 * bound_s * batches / (us * 1e-6) if us > 0 else None


def idle_pct_inside(att: Optional[Attribution],
                    name: str = ROOT_SPAN) -> Optional[float]:
    """The slice's share in which the device is idle while the host is
    inside span ``name``, in percent."""
    if att is None or att.slice.window_s <= 0 or not att.instances(name):
        return None
    return 100.0 * att.idle_inside_s(name) / att.slice.window_s


# -- the tool --------------------------------------------------------------------

def _by_instance(att: Attribution, name: str) -> List[int]:
    """Kernels launched inside each instance of span ``name`` (which do
    not overlap: the program's spans are not re-entered)."""
    inst = att.instances(name)
    starts = [s.ts for s in inst]
    counts = [0] * len(inst)
    for x in att.launched:
        if x.ts is None or x.activity.cat != "kernel":
            continue
        k = bisect.bisect_right(starts, x.ts) - 1
        if k >= 0 and inst[k].tid == x.tid and x.ts < starts[k] + inst[k].dur:
            counts[k] += 1
    return counts


def span_table(att: Attribution, batches: int, hand_written) -> dict:
    """Each span's device ms (all its launches, and those of no child
    span), kernels, copies, glue ms (kernels not written by hand), idle ms
    (the device idle while the host is inside it, and inside none of its
    children) and top operations, a batch; the kernels each instance
    launched."""
    names = sorted({s.name for s in att.spans})
    held = {n: {id(a) for a in att.launched_in(n)} for n in names}
    children = {n: [c for c in names if c != n and c.startswith(n + ".")]
                for n in names}
    children[ROOT_SPAN] = ["pq.encode", "pq.adc", "classify.nearest"]
    idle = {n: att.idle_inside_s(n) * 1e3 / batches for n in names}
    out = {}
    for n in names:
        acts = [x.activity for x in att.launched if id(x.activity) in held[n]]
        inner = set().union(*(held.get(c, set()) for c in children[n]))
        counts = _by_instance(att, n)
        out[n] = {
            "instances": len(att.instances(n)),
            "device_ms": sum(a.dur for a in acts) * 1e-3 / batches,
            "self_ms": sum(a.dur for a in acts
                           if id(a) not in inner) * 1e-3 / batches,
            "kernels": sum(a.cat == "kernel" for a in acts) / batches,
            "copies": sum(a.cat == "gpu_memcpy" for a in acts) / batches,
            "glue_ms": sum(a.dur for a in acts if a.cat == "kernel"
                           and a.base not in hand_written) * 1e-3 / batches,
            "idle_ms": idle[n],
            "self_idle_ms": idle[n] - sum(idle.get(c, 0.0)
                                          for c in children[n]),
            "kernels_per_instance": sorted(set(counts)),
            "top_ops": _top_ops(acts, batches)}
    return out


def _top_ops(acts: List[Activity], batches: int, top: int = 3) -> list:
    """The activities' names that took most device time: name, ms and
    count a batch."""
    per: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
    for a in acts:
        row = per[a.name[5:] if a.name.startswith("void ") else a.name]
        row[0] += a.dur * 1e-3 / batches
        row[1] += 1.0 / batches
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])[:top]
    return [[name[:80], ms, n] for name, (ms, n) in ranked]


def _checks(att: Attribution, table: dict,
            encode_glue_ms: Optional[float]) -> dict:
    """Whether row 1 and row 3 lie in their spans, the share of kernel
    time inside the root, and the stages' glue against ``encode.glue_ms``
    (the reader's, from the same trace)."""
    kernels = [a for a in att.slice.device if a.cat == "kernel"]
    held = {n: {id(a) for a in att.launched_in(n)}
            for n in (ROOT_SPAN, "pq.encode.refine", "pq.adc")}
    glue = sum(table.get(n, {}).get("glue_ms", 0.0) for n in STAGE_SPANS)
    return {
        "dtw_pairs_in_refine": all(id(a) in held["pq.encode.refine"] for a
                                   in att.slice.kernels("dtw_band_pairs")),
        "adc_in_pq_adc": all(id(a) in held["pq.adc"] for a
                             in att.slice.kernels("adc_rows_kernel")),
        "root_kernel_share": sum(a.dur for a in kernels
                                 if id(a) in held[ROOT_SPAN])
        / max(sum(a.dur for a in kernels), 1e-9),
        "stage_glue_ms": glue,
        "stage_glue_over_encode_glue": (glue / encode_glue_ms
                                        if encode_glue_ms else None),
        "unattributed": len(att.unattributed()),
        "device_activities": len(att.launched)}


def _lags(att: Attribution) -> Optional[Dict[str, float]]:
    """Kernel start (the trace's converted time) less the end of its
    launching call, in us: the least is the conversion's offset plus the
    launch latency, since some kernels start on an idle device."""
    lag = sorted(x.activity.ts - x.ts - x.dur for x in att.launched
                 if x.ts is not None and x.activity.cat == "kernel")
    if not lag:
        return None
    return {"min": lag[0], "p10": lag[len(lag) // 10],
            "p50": lag[len(lag) // 2]}


def _batch_s(entry, n: int) -> float:
    import time
    t = time.perf_counter()
    for i in range(n):
        entry.launch(i % entry.pool_sets).cpu()
    return (time.perf_counter() - t) / n


def _span_cost_us(n: int) -> float:
    import time
    from repro_torch import obs
    t = time.perf_counter()
    for _ in range(n):
        with obs.span("portbench.cost"):
            pass
    return (time.perf_counter() - t) / n * 1e6


def measure(workload: str, seed: int, batches: int, *,
            device: str = "cuda", overrides: Optional[dict] = None) -> dict:
    """Set the cell up, then time batches with obs off, under the profiler
    and with obs on, trace ``batches`` of them in a slice, and reduce.
    ``device`` and ``overrides`` (merged into the configuration) are the
    CPU tests' tiny runs."""
    import importlib
    import json
    import os
    import tempfile
    import time
    import types

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs

    from . import roofline
    from .harness import CSRC, _merge, prepare_env
    from .manifest import load_cell, load_manifest, load_reader
    from .trace import PAD_S, hand_written_kernels, reduce_trace

    prepare_env()
    cell = load_cell(workload, load_manifest())
    entry = importlib.import_module(
        f"portbench.entries.{cell.traffic['entry']}").Cell(
            _merge(cell.config, overrides or {}), cell.traffic, seed, device)
    entry.setup()
    on_device = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_device else [])
    with profile(activities=acts):
        entry.warm()
    if on_device:
        torch.cuda.synchronize()
    res = {"workload": workload, "seed": seed, "batches": batches,
           "device": torch.cuda.get_device_name(0) if on_device else "cpu",
           "torch": torch.__version__}
    res["span_cost_us"] = {"obs_off": _span_cost_us(200000)}
    with profile(activities=acts):
        res["span_cost_us"]["profiler"] = _span_cost_us(20000)
    with obs.override(True):
        res["span_cost_us"]["obs_on"] = _span_cost_us(100000)
    res["batch_ms"] = {"obs_off": _batch_s(entry, batches) * 1e3}
    with obs.override(True):
        res["batch_ms"]["obs_on"] = _batch_s(entry, batches) * 1e3

    with profile(activities=acts) as prof:
        t = time.perf_counter()
        while time.perf_counter() - t < 1.0:     # the tracer comes up
            entry.launch(0).cpu()
        time.sleep(PAD_S)
        with record_function(SLICE_NAME):
            res["batch_ms"]["profiler"] = _batch_s(entry, batches) * 1e3
        time.sleep(PAD_S)
    fd, path = tempfile.mkstemp(prefix="portbench-spans-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    sl = reduce_trace(events)
    att = attribute(events, sl)
    hand = hand_written_kernels(CSRC)
    g = entry.geo
    ctx = types.SimpleNamespace(
        cell=workload, config=entry.config, geo=g, slice=sl,
        hand_written=hand,
        stats={"slice_batches": batches, "n_test": entry.n_test,
               "n_train": entry.n_train})
    metrics = {m["name"]: load_reader(m["name"]).read(ctx)
               for m in cell.per_layer if m["source"] == "device_trace"}
    bound = roofline.lb_filter(entry.n_test, g.M, g.K, g.S).bound_s()
    metrics.update({
        "encode.prealign_ms": stage_ms(att, "pq.encode.prealign", batches),
        "encode.lb_filter_ms": stage_ms(att, "pq.encode.lb_filter", batches),
        "encode.pairs_ms": stage_ms(att, "pq.encode.pairs", batches),
        "classify.nearest_ms": stage_ms(att, "classify.nearest", batches),
        "lb_filter_roofline": lb_filter_roofline(att, bound, batches),
        "device.idle_pct.program": idle_pct_inside(att)})
    table = span_table(att, batches, hand)
    res.update(
        metrics=metrics, spans=table,
        lb_filter_bound_ms=bound * 1e3,
        checks=_checks(att, table, metrics.get("encode.glue_ms")),
        idle_outside_root_ms=(sl.window_s - sl.busy_s
                              - att.idle_inside_s(ROOT_SPAN)) * 1e3 / batches,
        idle_root_converted_pct=100.0 * _overlap(
            att.idle_intervals(),
            _union((x.ts, x.ts + x.dur) for x in att.instances(ROOT_SPAN)))
        * 1e-6 / sl.window_s,
        launch_to_start_us=_lags(att),
        breakdown={"device_ops": sl.device_ops, "idle_gaps": sl.idle_gaps,
                   "busy_s": sl.busy_s, "window_s": sl.window_s})
    return res


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    res = measure(args.workload, args.seed, args.batches)
    text = json.dumps(res, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
