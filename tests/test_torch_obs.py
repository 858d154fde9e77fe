"""The port's observability layer (``repro_torch.obs``) against the JAX
package's: the same metric writes give identical JSON and Prometheus
exports; a disabled span never synchronises the card; the index's stage
spans and pruning counters keep the reference's names; the dispatch
ledger mirrors into ``dispatch_total`` per call.  Also the port's own
contract: with obs off a span is the shared no-op, or under a recording
``torch.profiler`` an annotation alone, and the classify path's eight
stage spans reach the profiler's trace without changing its answers."""

import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import obs as tobs
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import dispatch as tdispatch
from repro_torch.core import knn as tknn
from repro_torch.core import pq as tpq
from repro_torch.core.pq import PQConfig
from repro_torch.index import IndexConfig, StreamingIndex
from repro_torch.obs import spans as tspans


@pytest.fixture(autouse=True)
def _obs_off():
    prev = tobs.enabled()
    tobs.disable()
    yield
    if prev:
        tobs.enable()
    else:
        tobs.disable()


def _writes(obs_mod, reg):
    """One fixed sequence of metric writes into ``reg``."""
    reg.counter("doc_requests_total", route="a").inc(3)
    reg.counter("doc_requests_total", route="b").inc()
    reg.counter("lb_candidates_pruned_total", persistent=True).inc(41)
    reg.gauge("hot_occupancy", persistent=True).set(0.375)
    reg.gauge("doc_inf").set(float("inf"))
    h = reg.histogram("stage_seconds", persistent=True,
                      stage="index.search.hot")
    for v in np.random.default_rng(0).exponential(0.01, 57):
        h.record(float(v))
    q = reg.histogram("lb_pruning_rate",
                      buckets=tuple(i / 10 for i in range(1, 11)))
    for v in (0.05, 0.5, 0.95, 1.0):
        q.record(v)


def test_exports_identical_to_reference():
    jreg, treg = jobs.Registry(), tobs.Registry()
    _writes(jobs, jreg)
    _writes(tobs, treg)
    with jobs.override(False), tobs.override(False):
        want_json = jobs.to_json(jreg, include_samples=True)
        got_json = tobs.to_json(treg, include_samples=True)
    assert json.loads(got_json) == json.loads(want_json)
    assert tobs.to_prometheus(treg) == jobs.to_prometheus(jreg)
    snap = json.loads(got_json)
    assert tobs.render(snap) == jobs.render(snap)
    assert tobs.stage_rows(snap) == jobs.stage_rows(snap)
    assert tobs.PROM_PREFIX == jobs.PROM_PREFIX == "repro_"


def test_percentiles_match_reference():
    samples = np.random.default_rng(3).exponential(0.01, 101).tolist()
    for p in (0.0, 50.0, 95.0, 99.0, 100.0):
        assert tobs.percentile(samples, p) == jobs.percentile(samples, p)


def test_disabled_span_never_synchronises(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("device sync while obs is disabled")

    monkeypatch.setattr(tspans, "_block", forbidden)
    monkeypatch.setattr(tspans, "_cuda_tensors", lambda x: True)
    with tobs.span("index.search") as sp:
        assert sp.fence("x") == "x"
    assert tobs.fence(torch.zeros(2)) is not None
    assert tobs.current_spans() == ()


def test_enabled_fence_synchronises_only_card_tensors(monkeypatch):
    calls = []
    monkeypatch.setattr(tspans, "_block", lambda: calls.append(1))
    with tobs.override(True):
        with tobs.span("index.search.fine") as sp:
            sp.fence((torch.zeros(2), [torch.ones(1)]))
            assert tobs.current_spans() == ("index.search.fine",)
        assert calls == []                        # CPU tensors: no sync
        monkeypatch.setattr(tspans, "_cuda_tensors", lambda x: True)
        tobs.fence({"d": torch.zeros(1)})
        assert calls == [1]
    h = tobs.REGISTRY.histogram("stage_seconds", persistent=True,
                                stage="index.search.fine")
    assert h.count >= 1


def test_index_search_spans_and_counters_on_off():
    rng = np.random.default_rng(0)
    X = np.cumsum(rng.standard_normal((40, 32)), 1).astype(np.float32)
    cfg = IndexConfig(PQConfig(n_sub=2, codebook_size=4, use_prealign=False,
                               kmeans_iters=1, dba_iters=1),
                      n_lists=2, hot_capacity=16, coarse_iters=1)
    idx = StreamingIndex.bootstrap(torch.Generator().manual_seed(0), X, cfg,
                                   device="cpu")
    idx.insert(X[:28])                            # 1 sealed + 12 hot
    off = idx.search(X[:5], n_probe=2, topk=3)
    before = tobs.counter_value(tobs.snapshot(),
                                "lb_candidates_bounded_total")
    with tobs.override(True):
        on = idx.search(X[:5], n_probe=2, topk=3)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    snap = tobs.snapshot()
    assert tobs.missing_stages(snap, [
        "index.search", "index.search.coarse", "index.search.lut",
        "index.search.fine", "index.search.hot",
        "index.search.merge"]) == []
    bounded = tobs.counter_value(snap, "lb_candidates_bounded_total")
    assert bounded - before == 5 * 12
    assert tobs.counter_value(snap, "lb_refine_waves_total") >= 1
    assert 0 <= tobs.REGISTRY.gauge("hot_occupancy",
                                    persistent=True).value <= 1


def test_dispatch_mirror_counts_calls():
    def count():
        return tobs.counter_value(tobs.snapshot(), "dispatch_total",
                                  op="elastic_cdist", backend="torch",
                                  kind="call", measure="dtw")

    before = count()
    for _ in range(2):
        tdispatch.elastic_cdist(torch.zeros(2, 8), torch.ones(3, 8), 2)
    assert count() - before == 2


# ---------------------------------------------------------------------------
# spans with obs off: the shared no-op, or the annotation under a profiler
# ---------------------------------------------------------------------------

CLASSIFY_SPANS = ("classify.sym", "pq.encode", "pq.encode.prealign",
                  "pq.encode.lb_filter", "pq.encode.pairs",
                  "pq.encode.refine", "pq.adc", "classify.nearest")
ENCODE_STAGES = CLASSIFY_SPANS[2:6]


def _forbid_sync(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("device sync while obs is disabled")

    monkeypatch.setattr(tspans, "_block", forbidden)
    monkeypatch.setattr(tspans, "_cuda_tensors", lambda x: True)


def _stage_count(name):
    snap = tobs.snapshot()
    return sum(h["count"] for h in snap["histograms"]
               if h["name"] == "stage_seconds"
               and h["labels"].get("stage") == name)


def _annotations(prof):
    """``name -> [(start_us, end_us, thread)]`` of the profiler's events."""
    out = {}
    for e in prof.events():
        out.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end, e.thread))
    return out


def test_disabled_span_without_profiler_is_the_shared_null_span():
    assert tspans.span("pq.encode") is tspans._NULL_SPAN
    assert tobs.span("classify.sym") is tspans._NULL_SPAN


def test_disabled_span_under_profiler_annotates_only(monkeypatch):
    _forbid_sync(monkeypatch)
    before = _stage_count("obs.test.annotated")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = tobs.span("obs.test.annotated")
        assert sp is not tspans._NULL_SPAN
        with sp:
            assert sp.fence(torch.zeros(2)) is not None
            assert tobs.current_spans() == ()
            torch.ones(3).sum()
    assert "obs.test.annotated" in _annotations(prof)
    assert _stage_count("obs.test.annotated") == before
    # the profiler closed: the shared no-op again
    assert tobs.span("obs.test.annotated") is tspans._NULL_SPAN


def _tiny_classify_inputs():
    g = torch.Generator().manual_seed(0)
    train = torch.cumsum(torch.randn(24, 64, generator=g), 1)
    Q = torch.cumsum(torch.randn(10, 64, generator=g), 1)
    cfg = PQConfig(n_sub=4, codebook_size=8, refine_frac=0.25)
    assert not cfg.full_scan_encode() and cfg.refine_t() == 2
    segs = tpq.segment(train, cfg)
    rows = torch.stack([torch.randperm(24, generator=g)[:8]
                        for _ in range(4)])
    cents = torch.stack([segs[rows[m], m] for m in range(4)]).contiguous()
    cb = tpq.codebook_from_centroids(cents, cfg, 64)
    codes = tpq.encode(train, cb, cfg, device="cpu")
    return codes, torch.arange(24), Q, cb, cfg


def test_classify_spans_reach_the_profiler_with_obs_off(monkeypatch):
    """``knn_classify_sym`` with obs off, with and without a profiler and
    with every device sync forbidden: under the profiler all eight spans
    show, ``classify.sym`` enclosing the rest and ``pq.encode`` its four
    stages; the labels are the same either way, and no stage sample is
    recorded."""
    codes, labels, Q, cb, cfg = _tiny_classify_inputs()
    _forbid_sync(monkeypatch)
    before = {n: _stage_count(n) for n in CLASSIFY_SPANS}
    plain = tknn.knn_classify_sym(codes, labels, Q, cb, cfg, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = tknn.knn_classify_sym(codes, labels, Q, cb, cfg,
                                       device="cpu")
    assert torch.equal(plain, traced)
    assert {n: _stage_count(n) for n in CLASSIFY_SPANS} == before
    ann = _annotations(prof)
    for name in CLASSIFY_SPANS:
        assert len(ann.get(name, ())) == 1, name

    def inside(child, parent):
        (a, b, t), = ann[child]
        (pa, pb, pt), = ann[parent]
        return t == pt and pa <= a and b <= pb

    for name in CLASSIFY_SPANS[1:]:
        assert inside(name, "classify.sym"), name
    for name in ENCODE_STAGES:
        assert inside(name, "pq.encode"), name
    for name in ("pq.adc", "classify.nearest"):
        assert not inside(name, "pq.encode"), name
