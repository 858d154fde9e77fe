"""The span attribution (``portbench/spans.py``) on a hand-made chrome
trace with correlation ids and program annotations: a device activity
belongs to the spans that held its launching call on the same thread,
whatever its device timestamp; a launch seen only as a driver call is
matched; one with no launch event is unattributed.  The per-layer
quantities against hand counts, and the program's spans in a real CPU
trace of a tiny classify cell."""

import pytest

from portbench.spans import (ROOT_SPAN, attribute, idle_pct_inside,
                             lb_filter_roofline, span_table, stage_ms)
from portbench.trace import SLICE_NAME, reduce_trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, 1, tid, corr)


def _kernel(name, ts, dur, corr):
    return _x("kernel", f"void {name}<4>(float const*)", ts, dur, 7, corr)


EVENTS = [
    _x("user_annotation", SLICE_NAME, 100.0, 100.0),
    _x("user_annotation", "classify.sym", 101, 89),
    _x("user_annotation", "pq.encode", 101, 49),
    _x("user_annotation", "pq.encode.lb_filter", 102, 18),
    _x("user_annotation", "pq.encode.refine", 121, 28),
    _x("user_annotation", "pq.adc", 150, 10),
    _x("user_annotation", "classify.nearest", 160, 29),
    # inside lb_filter, run inside it
    _launch(103, 1), _kernel("reduce_kernel", 105, 10, 1),
    # launched inside lb_filter, run after it ended (the clock-offset case)
    _launch(118, 2), _kernel("elementwise_kernel", 125, 5, 2),
    # a launch seen only as a driver call
    _x("cuda_driver", "cuLaunchKernel", 122, 1, 1, 3),
    _kernel("dtw_band_pairs_reg_kernel", 130, 15, 3),
    _launch(151, 4), _kernel("adc_rows_kernel", 152, 4, 4),
    _launch(161, 5), _kernel("reduce_kernel", 165, 5, 5),
    # no launch event in the trace
    _kernel("elementwise_kernel", 175, 5, 6),
    # launched from another thread while lb_filter was open on thread 1
    _launch(104, 7, tid=2), _kernel("elementwise_kernel", 180, 2, 7),
    _x("cuda_runtime", "cudaMemcpyAsync", 185, 4, 1, 8),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 186, 2, 7, 8),
    # outside the slice
    _launch(199, 9), _kernel("late_kernel", 205, 5, 9),
]


@pytest.fixture
def att():
    return attribute(EVENTS, reduce_trace(EVENTS))


def _bases(acts):
    return sorted(a.base for a in acts)


def test_launch_inside_the_span_attributes_the_kernel(att):
    got = att.launched_in("pq.encode.lb_filter")
    assert _bases(got) == ["elementwise_kernel", "reduce_kernel"]
    # the second one ran on the device after the span had closed
    late = next(a for a in got if a.base == "elementwise_kernel")
    assert late.ts > 102 + 18


def test_driver_launch_is_matched(att):
    assert _bases(att.launched_in("pq.encode.refine")) == [
        "dtw_band_pairs_reg_kernel"]


def test_no_launch_event_is_unattributed(att):
    assert [(a.base, a.ts) for a in att.unattributed()] == [
        ("elementwise_kernel", 175.0)]
    assert all(a.ts != 175.0 for a in att.launched_in(ROOT_SPAN))


def test_another_threads_launch_is_not_the_spans(att):
    assert all(a.ts != 180.0 for a in att.launched_in(ROOT_SPAN))
    assert all(a.ts != 180.0 for a in att.launched_in("pq.encode"))


def test_spans_and_activities_of_the_slice(att):
    assert [s.name for s in att.spans] == [
        "classify.sym", "pq.encode", "pq.encode.lb_filter",
        "pq.encode.refine", "pq.adc", "classify.nearest"]
    # the slice's own activities, the late kernel left out
    assert [x.activity for x in att.launched] == att.slice.device
    assert _bases(att.launched_in(ROOT_SPAN)) == [
        "Memcpy DtoH (Device -> Pageable)", "adc_rows_kernel",
        "dtw_band_pairs_reg_kernel", "elementwise_kernel", "reduce_kernel",
        "reduce_kernel"]


def test_reduce_trace_fields_unchanged_by_the_annotations():
    """The reduction's device activities, busy time and top operations
    are those of the trace without the program's annotations."""
    bare = [e for e in EVENTS if e["cat"] != "user_annotation"
            or e["name"] == SLICE_NAME]
    a, b = reduce_trace(EVENTS), reduce_trace(bare)
    assert (a.t0, a.t1, a.device, a.busy_s, a.window_s, a.device_ops) == (
        b.t0, b.t1, b.device, b.busy_s, b.window_s, b.device_ops)
    # an idle gap no host op spans is named by the span that holds it
    assert dict(a.idle_gaps)["classify.nearest"] > 0
    assert "classify.nearest" not in dict(b.idle_gaps)


@pytest.mark.parametrize("batches", [1, 2])
def test_stage_ms_by_hand(att, batches):
    want = {"pq.encode.lb_filter": 15, "pq.encode.refine": 15,
            "pq.adc": 4, "classify.nearest": 7, "pq.encode": 30,
            ROOT_SPAN: 41}
    for name, us in want.items():
        assert stage_ms(att, name, batches) == pytest.approx(
            us * 1e-3 / batches), name
    assert stage_ms(att, "pq.encode.prealign", batches) is None
    assert stage_ms(att, "pq.encode.lb_filter", 0) is None


def test_lb_filter_roofline_by_hand(att):
    # 3 us of bound a batch, 2 batches, over 15 us launched in the span
    assert lb_filter_roofline(att, 3e-6, 2) == pytest.approx(40.0)
    assert lb_filter_roofline(att, 3e-6, None) is None


def test_idle_stretches_end_at_their_launches(att):
    # the converted stretches: busy 105-115, 125-145, 152-156, 165-170,
    # 175-182, 186-188
    assert att.idle_intervals() == [(100.0, 105.0), (115.0, 125.0),
                                    (145.0, 152.0), (156.0, 165.0),
                                    (170.0, 175.0), (182.0, 186.0),
                                    (188.0, 200.0)]
    # on the host's clock each ends where the call that launched the
    # activity ending it ended; the one with no launch event, and the
    # slice's last, keep the trace's time
    assert att.host_idle_intervals() == [(99.0, 104.0), (109.0, 119.0),
                                         (145.0, 152.0), (153.0, 162.0),
                                         (170.0, 175.0), (185.0, 189.0),
                                         (188.0, 200.0)]


def test_idle_on_the_host_clock_ignores_the_device_offset(att):
    """Device timestamps converted 2 us early: the stretches that a
    launch ends (all but the first, the slice's last and the one the
    unlaunched kernel ends) are the same on the host's clock."""
    moved = [dict(e, ts=e["ts"] - 2) if e["cat"] in ("kernel", "gpu_memcpy")
             else e for e in EVENTS]
    other = attribute(moved, reduce_trace(moved))
    launched = (1, 2, 3, 5)
    for k in launched:
        assert other.host_idle_intervals()[k] == att.host_idle_intervals()[k]
        assert other.idle_intervals()[k] != att.idle_intervals()[k]


def test_idle_inside_the_root_by_hand(att):
    # the root is open 101-190: 3 + 10 + 7 + 9 + 5 + 4 + 2 = 40 us of 100
    assert att.idle_inside_s(ROOT_SPAN) == pytest.approx(40e-6)
    assert idle_pct_inside(att) == pytest.approx(40.0)
    # pq.adc is open 150-160: 2 + 7
    assert att.idle_inside_s("pq.adc") == pytest.approx(9e-6)


def test_span_table_by_hand(att):
    t = span_table(att, 1, frozenset({"dtw_band_pairs_reg_kernel",
                                      "adc_rows_kernel"}))
    root = t[ROOT_SPAN]
    assert root["device_ms"] == pytest.approx(41e-3)
    assert root["self_ms"] == pytest.approx(0.0)
    assert root["kernels"] == 5 and root["copies"] == 1
    assert root["glue_ms"] == pytest.approx(20e-3)
    assert t["pq.encode"]["self_ms"] == pytest.approx(0.0)
    assert t["pq.encode.lb_filter"]["kernels_per_instance"] == [2]
    # classify.nearest is open 160-189: 2 + 5 + 4 + 1
    assert t["classify.nearest"]["idle_ms"] == pytest.approx(12e-3)
    # idle in no child: the root's 40 less 18 + 9 + 12 (189-190), and
    # pq.encode's 18 less its stages' 12 + 4 (101-102, 149-150)
    assert root["self_idle_ms"] == pytest.approx(1e-3)
    assert t["pq.encode"]["self_idle_ms"] == pytest.approx(2e-3)


def test_without_program_spans_nothing_is_read():
    bare = [e for e in EVENTS if e["cat"] != "user_annotation"
            or e["name"] == SLICE_NAME]
    att = attribute(bare, reduce_trace(bare))
    assert att.spans == []
    assert stage_ms(att, "pq.encode.lb_filter", 1) is None
    assert idle_pct_inside(att) is None
    assert lb_filter_roofline(att, 3e-6, 1) is None


def test_a_slice_of_other_events_is_refused(att):
    with pytest.raises(ValueError):
        attribute(EVENTS[:-8], att.slice)


def test_program_spans_in_a_cpu_trace():
    """A tiny classify cell's batches under the CPU profiler: every batch
    shows the eight spans, each on the thread that ran the batch."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.entries.classify import Cell
    from portbench.harness import _merge
    from portbench.manifest import load_cell, load_manifest

    from .conftest import BIG_SEED, TINY

    c = load_cell("starlight-classify", load_manifest())
    entry = Cell(_merge(c.config, TINY), c.traffic, BIG_SEED, "cpu")
    entry.setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(SLICE_NAME):
            for p in range(3):
                entry.launch(p)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    att = attribute(events, reduce_trace(events))
    names = ("classify.sym", "pq.encode", "pq.encode.prealign",
             "pq.encode.lb_filter", "pq.encode.pairs", "pq.encode.refine",
             "pq.adc", "classify.nearest")
    for name in names:
        assert len(att.instances(name)) == 3, name
    assert len({s.tid for s in att.spans}) == 1
    assert stage_ms(att, "pq.encode.lb_filter", 3) == 0.0


def test_the_tool_on_a_tiny_cpu_cell():
    """``measure`` end to end on the CPU: the eight spans in every batch,
    the per-layer quantities present, nothing on a device."""
    from portbench.spans import measure

    from .conftest import BIG_SEED, TINY

    r = measure("electric-classify", BIG_SEED, 3, device="cpu",
                overrides=TINY)
    assert r["device"] == "cpu" and r["batches"] == 3
    assert {n: r["spans"][n]["instances"] for n in r["spans"]} == {
        n: 3 for n in ("classify.sym", "pq.encode", "pq.encode.prealign",
                       "pq.encode.lb_filter", "pq.encode.pairs",
                       "pq.encode.refine", "pq.adc", "classify.nearest")}
    assert r["metrics"]["encode.lb_filter_ms"] == 0.0
    assert 0 < r["metrics"]["device.idle_pct.program"] <= 100.0
    assert r["checks"]["device_activities"] == 0
    assert set(r["batch_ms"]) == {"obs_off", "obs_on", "profiler"}
