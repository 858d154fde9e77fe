"""The ``lb_filter_roofline`` reader on hand-made slices: a hand count of
the LB filter's bound over the kernel's device time, and nothing on a
slice whose program has no such kernel."""

import types

import pytest

from portbench.manifest import load_reader
from portbench.reference.geometry import PQGeometry
from portbench.trace import SLICE_NAME, reduce_trace

KERNEL = ("void (anonymous namespace)::lb_filter_topk_kernel<8, 8, 2>("
          "float const*, float const*, float const*, float const*, "
          "long long*, float*, int, int, int, int, int, int)")


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1}


def _ctx(events, batches):
    geo = PQGeometry(D=40, M=2, K=4, tail=1, S=5, window=1, refine_t=1,
                     level=1)
    return types.SimpleNamespace(
        cell="x", config={}, geo=geo, slice=reduce_trace(events),
        stats={"slice_batches": batches, "n_test": 10, "n_train": 3},
        hand_written=frozenset({"lb_filter_topk_kernel"}))


def test_lb_filter_roofline_by_hand():
    # 10 series x 2 subspaces x 4 centroids: 5 points x 5 ops + 6 (Kim and
    # the max) a bound = 2480 ops; in: 10 x 2 segments of 5 floats, the
    # centroids and both envelopes (3 x 2 x 4 x 5 floats); out: the
    # 10 x 2 x 4 bounds: (100 + 120 + 80) x 4 = 1200 bytes, so bytes
    # bound it.  Two batches, two launches of 0.003 and 0.001 us.
    events = [_x("user_annotation", SLICE_NAME, 100.0, 100.0),
              _x("kernel", KERNEL, 110.0, 0.003),
              _x("kernel", "void at::native::reduce_kernel<512, 1>(int)",
                 120.0, 5.0),
              _x("kernel", KERNEL, 150.0, 0.001)]
    bound_s = 2 * max(2480 / 67e12, 1200 / 3.35e12)
    got = load_reader("lb_filter_roofline").read(_ctx(events, 2))
    assert got == pytest.approx(100.0 * bound_s / 0.004e-6)


def test_lb_filter_roofline_silent_without_the_kernel():
    # the parent: the filter's bounds in PyTorch's own kernels
    events = [_x("user_annotation", SLICE_NAME, 100.0, 100.0),
              _x("kernel", "void at::native::reduce_kernel<512, 1>(int)",
                 120.0, 5.0),
              _x("kernel", "void at::native::elementwise_kernel<128, 2>()",
                 130.0, 5.0)]
    reader = load_reader("lb_filter_roofline")
    assert reader.read(_ctx(events, 2)) is None
    assert reader.read(_ctx(events[:1], 0)) is None
