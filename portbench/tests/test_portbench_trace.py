"""The trace reduction on a hand-made chrome trace: the slice, the busy
union, idle gaps by host activity, the top device operations, and kernel
names."""

import pytest

from portbench.manifest import ROOT
from portbench.trace import (SLICE_NAME, Tracer, hand_written_kernels,
                             kernel_base, reduce_trace)


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    _x("user_annotation", SLICE_NAME, 100.0, 100.0),
    _x("kernel", "void dtw_band_pairs_reg_kernel<16>(float const*)", 90, 20),
    _x("kernel", "void dtw_band_pairs_reg_kernel<16>(float const*)", 110, 20),
    _x("kernel", "void at::native::reduce_kernel<512, 1>(int)", 120, 20),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 150, 10),
    _x("kernel", "late_kernel", 205, 10),
    _x("cpu_op", "aten::sort", 139, 12),
    _x("cuda_runtime", "cudaMemcpyAsync", 160, 30),
    _x("cpu_op", "aten::item", 158, 35),
]


def test_slice_reduction():
    s = reduce_trace(EVENTS)
    assert (s.t0, s.t1) == (100.0, 200.0)
    # device activity starting inside the slice: 110-140 and 150-160
    assert [a.base for a in s.device] == [
        "dtw_band_pairs_reg_kernel", "reduce_kernel", "Memcpy DtoH"
        " (Device -> Pageable)"]
    assert s.busy_s == pytest.approx(40e-6)
    assert s.window_s == pytest.approx(100e-6)
    assert s.device_ops[0] == [
        "dtw_band_pairs_reg_kernel<16>(float const*)", pytest.approx(20e-6)]
    gaps = dict(s.idle_gaps)
    # 100-110: nothing on the host -> "host"; 140-150: aten::sort spans
    # its middle; 160-200: the copy call nested in aten::item
    assert gaps == {"host": pytest.approx(10e-6),
                    "aten::sort": pytest.approx(10e-6),
                    "cudaMemcpyAsync": pytest.approx(40e-6)}
    assert len(s.kernels("dtw_band_pairs")) == 1


def test_no_slice_no_reading():
    assert reduce_trace(EVENTS[1:]) is None


@pytest.mark.parametrize("name,base", [
    ("void dtw_band_pairs_reg_kernel<16>(float const*, int)",
     "dtw_band_pairs_reg_kernel"),
    ("void adc_rows_kernel<float, 16, 8, false>(int const*)",
     "adc_rows_kernel"),
    ("void at::native::(anonymous namespace)::f<(anonymous namespace)::"
     "T>(at::Tensor)", "f")])
def test_kernel_base(name, base):
    assert kernel_base(name) == base


def test_hand_written_kernels_of_the_port():
    names = hand_written_kernels(ROOT / "src" / "repro_torch" / "kernels"
                                 / "csrc")
    assert {"dtw_band_pairs_reg_kernel", "dtw_band_cdist_reg_kernel",
            "adc_rows_kernel", "lb_refine_warp_kernel",
            "pq_attn_kernel"} <= names
    assert "reduce_kernel" not in names


def test_tracer_off_does_nothing():
    t = Tracer(False, 0.0, 1.0)
    t.tick(10.0)
    t.finish()
    assert t.result is None and t.prof_host == []


def test_slice_counts_every_batch_inside_it():
    """The profiler on the CPU over a short window of stub batches: the
    batches counted inside the slice are exactly those launched while the
    slice annotation was open, the first one included."""
    import time

    import torch

    from portbench.entries.classify import Cell
    from portbench.harness import _merge
    from portbench.manifest import load_cell, load_manifest

    from .conftest import BIG_SEED, TINY

    c = load_cell("electric-classify", load_manifest())
    entry = Cell(_merge(c.config, TINY), c.traffic, BIG_SEED, "cpu")
    t0 = time.perf_counter()
    tracer = Tracer(True, t0 + 1.7, 0.5)
    inside = []

    def launch(p):
        inside.append(tracer.stage == 2)
        time.sleep(0.02)
        return torch.zeros(1)

    entry.launch = launch
    entry.run_window(2.8, tracer)
    stats = entry.reader_stats(tracer)
    assert tracer.result is not None
    assert sum(inside) >= 10
    assert stats["slice_batches"] == sum(inside)
