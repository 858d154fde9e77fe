"""The port's launch tuner (``repro_torch.kernels.tune``) on the CPU.

The reference's four tuner cases (``tests/test_adaptive.py``) on the
port, the graph-capture guard in place of the trace guard; then the
``auto`` mode's rules, which hold on the card: a candidate is admitted
only where its output equals the default's bit for bit, the winner is
memoized and persisted (through a temp file) under ``REPRO_TUNE_OUT``
and never under the reference's ``experiments/tune/``, a pinned table
read back gives the same launch parameters, a stored winner that the
call's own geometry cannot take is never launched, and nothing is
measured for CPU tensors.  The card's CUDA-event timer is replaced by a fake clock and
the kernels' wrappers are driven up to the launch with the device test
and the library replaced (as ``test_torch_kernel_forms.py`` does), so the
tuned parameters each wrapper hands its kernel are seen without a card.
"""

import hashlib
import json
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build, tune
from repro_torch.kernels.dtw_band import ops as dtw_ops
from repro_torch.kernels.lb_cascade import ops as lb_ops
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.prealign_encode import ops as pe_ops

REPO = Path(__file__).resolve().parents[1]
REFERENCE_TABLE = REPO / "experiments" / "tune" / "tuning.json"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in (tune.ENV, tune.GRID_ENV, tune.OUT_ENV):
        monkeypatch.delenv(var, raising=False)
    tune.reset()
    yield
    tune.reset()


class _Clock:
    """Stands in for the card's CUDA-event timer: ``ms(params)`` per
    candidate; counts the calls."""

    def __init__(self, ms):
        self.ms, self.calls = ms, []

    def __call__(self, runner, params):
        self.calls.append(dict(params))
        out = runner(params)
        return self.ms(params), out


def _on_fake_card(monkeypatch, clock):
    monkeypatch.setattr(tune, "_can_measure", lambda device: True)
    monkeypatch.setattr(tune, "_time", clock)
    monkeypatch.setattr(_build, "lib", lambda: _Lib())


class _Lib:
    """Stands in for the kernel library: records which entry ran."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append((name, args))
            return 0
        return entry


# -- the reference's four cases ---------------------------------------------

def test_tune_off_returns_defaults(monkeypatch):
    monkeypatch.setenv(tune.ENV, "off")
    assert tune.tuned("dtw_band", "bucket", length=128, window=12,
                      default=7) == 7


def test_tune_pinned_table_is_deterministic(tmp_path, monkeypatch):
    key = tune.table_key("dtw_band", length=128, window=12, measure="dtw",
                         backend="cuda")
    path = tmp_path / "pinned.json"
    path.write_text(json.dumps({key: {"bucket": 32}}))
    monkeypatch.setenv(tune.ENV, str(path))
    for _ in range(3):
        assert tune.tuned("dtw_band", "bucket", length=128, window=12,
                          measure="dtw", default=16) == 32
    # a geometry the table does not pin falls back to the default
    assert tune.tuned("dtw_band", "bucket", length=4096, window=400,
                      measure="dtw", default=16) == 16


def test_tune_auto_benchmarks_and_memoizes(tmp_path, monkeypatch):
    monkeypatch.setenv(tune.ENV, "auto")
    monkeypatch.setenv(tune.GRID_ENV, "minimal")
    monkeypatch.setenv(tune.OUT_ENV, str(tmp_path))
    clock = _Clock(lambda p: 1.0)
    _on_fake_card(monkeypatch, clock)
    ran = []

    def runner(params):
        ran.append(params)
        return (torch.zeros(4),)

    got = tune.tuned("dtw_band", "bucket", length=32, window=3,
                     measure="dtw", default=8, runner=runner,
                     device=torch.device("cpu"))
    assert got == 8                      # minimal grid = (default,)
    assert clock.calls == [{"bucket": 8}]
    saved = json.loads((tmp_path / "tuning.json").read_text())
    key = tune.table_key("dtw_band", length=32, window=3, measure="dtw",
                         backend="cuda")
    assert saved == {key: {"bucket": 8}}
    # the second call hits the memo: nothing measured again
    assert tune.tuned("dtw_band", "bucket", length=32, window=3,
                      measure="dtw", default=8, runner=runner) == 8
    assert len(clock.calls) == 1
    assert not list(tmp_path.glob(".tuning.*"))   # the temp file is gone


def test_tuned_measures_nothing_during_graph_capture(tmp_path, monkeypatch):
    """The TPU's "never mid-trace": while the current stream captures a
    CUDA graph the lookup returns the default and measures nothing."""
    monkeypatch.setenv(tune.ENV, "auto")
    monkeypatch.setenv(tune.OUT_ENV, str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    ran = []
    got = tune.tuned("dtw_band", "bucket", length=64, window=6, default=8,
                     runner=lambda p: ran.append(p),
                     device=torch.device("cuda"))
    assert got == 8 and ran == []
    assert not (tmp_path / "tuning.json").exists()


# -- the auto mode's rules ----------------------------------------------------

def test_tuned_measures_nothing_for_cpu_tensors(tmp_path, monkeypatch):
    monkeypatch.setenv(tune.ENV, "auto")
    monkeypatch.setenv(tune.OUT_ENV, str(tmp_path))
    ran = []
    for dev in (None, torch.device("cpu")):
        assert tune.tuned("adc_sym", "ta", length=256, default=16,
                          runner=lambda p: ran.append(p), device=dev) == 16
    assert ran == [] and not (tmp_path / "tuning.json").exists()
    assert tune.REPORT == [] and tune.LAUNCHES == {}


def test_auto_admits_only_bit_equal_candidates(tmp_path, monkeypatch):
    """The fastest candidate differs from the default in one bit and is
    left out; one that raises is reported and left out; the fastest of
    the rest wins, is persisted, and the report keeps every line."""
    monkeypatch.setenv(tune.ENV, "auto")
    monkeypatch.setenv(tune.OUT_ENV, str(tmp_path))
    clock = _Clock(lambda p: {32: 1.0, 16: 3.0, 8: 2.0}[p["ta"]])
    _on_fake_card(monkeypatch, clock)
    monkeypatch.setitem(tune.GRIDS, "adc_sym", {"ta": (8, 16, 32, 64)})

    def runner(params):
        if params["ta"] == 64:
            raise ValueError("does not fit in shared memory")
        out = torch.ones(8)
        if params["ta"] == 32:
            out[3] = torch.nextafter(out[3], torch.tensor(2.0))
        return (out,)

    got = tune.tuned("adc_sym", "ta", length=256, measure="f32",
                     default=16, runner=runner, device=torch.device("cpu"))
    assert got == 8
    (line,) = tune.REPORT
    by_ta = {c["params"]["ta"]: c for c in line["candidates"]}
    assert line["candidates"][0]["params"] == {"ta": 16}   # default first
    assert "differs" in by_ta[32]["error"]
    assert "ValueError" in by_ta[64]["error"] and "ms" not in by_ta[64]
    assert line["winner"] == {"ta": 8} and line["winner_ms"] == 2.0
    key = tune.table_key("adc_sym", length=256, window=None, measure="f32",
                         backend="cuda")
    assert json.loads((tmp_path / "tuning.json").read_text()) == {
        key: {"ta": 8}}


def test_a_default_that_fails_raises(tmp_path, monkeypatch):
    """No fallback: the default candidate raising is the call's error."""
    monkeypatch.setenv(tune.ENV, "auto")
    monkeypatch.setenv(tune.OUT_ENV, str(tmp_path))
    _on_fake_card(monkeypatch, _Clock(lambda p: 1.0))

    def runner(params):
        raise RuntimeError("kernel launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        tune.tuned("lb_refine", "warps", length=512, window=51, default=4,
                   runner=runner, device=torch.device("cpu"))


def test_measurements_count_apart(tmp_path, monkeypatch):
    """A launch inside the tuner's measurement counts in tune.LAUNCHES,
    not in the kernels' counters."""
    monkeypatch.setenv(tune.ENV, "auto")
    monkeypatch.setenv(tune.OUT_ENV, str(tmp_path))
    _on_fake_card(monkeypatch, _Clock(lambda p: 1.0))
    monkeypatch.setitem(_build.LAUNCHES, "lb_refine", 0)

    def runner(params):
        _build.count_launch("lb_refine")
        return (torch.zeros(2),)

    tune.tuned("lb_refine", "warps", length=512, window=51, default=4,
               runner=runner, device=torch.device("cpu"))
    n = len(tune.GRIDS["lb_refine"]["warps"])
    assert tune.LAUNCHES == {"lb_refine": n}   # the fake clock runs once
    assert _build.LAUNCHES["lb_refine"] == 0


def _sha(path: Path):
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else None


def test_writes_never_touch_the_reference_table(tmp_path, monkeypatch):
    assert tune.DEFAULT_OUT.parts[-2:] == ("build", "tune")
    assert tune.DEFAULT_OUT.resolve() != REFERENCE_TABLE.parent.resolve()
    before = _sha(REFERENCE_TABLE)
    monkeypatch.setenv(tune.ENV, "auto")
    monkeypatch.setenv(tune.OUT_ENV, str(tmp_path))
    _on_fake_card(monkeypatch, _Clock(lambda p: float(p["warps"] + 1)))
    tune.tuned("lb_refine", "warps", length=512, window=51, default=4,
               runner=lambda p: (torch.zeros(2),),
               device=torch.device("cpu"))
    assert _sha(REFERENCE_TABLE) == before
    assert [p.name for p in tmp_path.iterdir()] == ["tuning.json"]


# -- the wrappers hand the tuned parameters to their kernels ----------------

def _fake_launch(monkeypatch, module, lib):
    monkeypatch.setattr(module._build, "kernel_device",
                        lambda *t, **kw: torch.device("cpu"))
    monkeypatch.setattr(module._build, "lib", lambda: lib)
    monkeypatch.setattr(module._build, "stream", lambda dev: 0)
    monkeypatch.setattr(tune, "_can_measure", lambda device: True)


def _row_calls(lib, entry):
    """The entry's calls, their data pointers masked (not launch
    parameters)."""
    return [tuple("ptr" if isinstance(a, int) and a > 1 << 32 else a
                  for a in args) for name, args in lib.called
            if name == entry]


def test_auto_then_pinned_gives_the_same_launches(tmp_path, monkeypatch):
    """Rows 1-6 in ``auto`` mode on a fake card whose clock favours a
    non-default candidate of every op: each wrapper's own launch takes
    the winner; the table read back pinned gives the same launches."""
    L, w = 74, 7
    A = torch.zeros(5, L)
    defaults = {"dtw_band": {"bucket": 16, "warps": 4},
                "dtw_band_cdist": {"bucket": 16}, "lb_refine": {"warps": 4},
                "prealign_encode": {"bucket": 8}, "adc_sym": {"ta": 16},
                "adc_lookup": {"ta": 16}}

    def ms(p):     # the default is the slowest, the other forms (a
        # parameter 0) next; the first other candidate of the form wins
        if p in defaults.values():
            return 10.0
        return 5.0 if 0 in p.values() else 1.0

    runs = {}
    for mode in ("auto", "pinned"):
        monkeypatch.setenv(tune.ENV, "auto" if mode == "auto"
                           else str(tmp_path / "tuning.json"))
        monkeypatch.setenv(tune.OUT_ENV, str(tmp_path))
        tune.reset()
        lib = _Lib()
        for module in (dtw_ops, lb_ops, pe_ops, adc_ops):
            _fake_launch(monkeypatch, module, lib)
        monkeypatch.setattr(tune, "_time", _Clock(ms))
        # the fake library writes no output: fresh outputs start at zero
        monkeypatch.setattr(torch, "empty_like", torch.zeros_like)
        monkeypatch.setattr(adc_ops, "_check_range", lambda K, **c: None)
        dtw_ops.dtw_band(A, A, w)
        dtw_ops.dtw_band_cdist(A, A[:3], w)
        lb_ops.lb_refine(A, A, A, A, torch.zeros(5), w)
        pe_ops.prealign_encode(torch.zeros(2, 16), torch.zeros(2, 4, 10),
                               level=1, tail=2, window=1)
        codes = torch.zeros((768, 8), dtype=torch.int32)
        adc_ops.adc_sym_cdist(codes, codes, torch.zeros(8, 256, 256))
        adc_ops.adc_lookup(codes, torch.zeros(768, 8, 256))
        # the wrapper's own launch is the last call of its entry
        runs[mode] = {e: _row_calls(lib, e)[-1] for e in (
            "pq_dtw_band", "pq_dtw_band_cdist_reg", "pq_lb_refine_warp",
            "pq_prealign_encode", "pq_adc_sym_rows", "pq_adc_lookup_rows")}
        if mode == "auto":
            table = json.loads((tmp_path / "tuning.json").read_text())
    assert {k.split("|")[0] for k in table} == {
        "dtw_band", "dtw_band_cdist", "lb_refine", "prealign_encode",
        "adc_sym", "adc_lookup"}
    assert runs["auto"] == runs["pinned"]
    launched = runs["auto"]
    win = {k.split("|")[0]: v for k, v in table.items()}
    for op, default in defaults.items():
        assert win[op] != default, op
    assert launched["pq_dtw_band"][10] == win["dtw_band"]["bucket"]
    assert launched["pq_dtw_band_cdist_reg"][10] == win[
        "dtw_band_cdist"]["bucket"]
    assert launched["pq_prealign_encode"][15] == win[
        "prealign_encode"]["bucket"]
    assert launched["pq_adc_sym_rows"][11] == win["adc_sym"]["ta"]
    assert launched["pq_adc_lookup_rows"][10] == win["adc_lookup"]["ta"]
    assert launched["pq_lb_refine_warp"][10] == win["lb_refine"]["warps"]


def _adc_call(M):
    codes = torch.zeros((768, M), dtype=torch.int32)
    adc_ops.adc_sym_cdist(codes, codes, torch.zeros(M, 256, 256))


def _lb_call(L):
    A = torch.zeros(5, L)
    lb_ops.lb_refine(A, A, A, A, torch.zeros(5), 7)


# (entry, argument slot of the tuned parameter, call, first and second
# geometry under one key, the tuned value won at the first that the
# second cannot take, the second's default)
_ONE_KEY_TWO_GEOMETRIES = {
    "adc_sym": ("pq_adc_sym_rows", 11, _adc_call, 8, 16, 16, 8),
    "lb_refine": ("pq_lb_refine_warp", 10, _lb_call, 5000, 8000, 4, 3),
}


@pytest.mark.parametrize("op", sorted(_ONE_KEY_TWO_GEOMETRIES))
def test_an_entry_that_does_not_fit_is_never_launched(op, tmp_path,
                                                      monkeypatch):
    """A key buckets the geometry: a winner found at one geometry (ADC's
    tile at M = 8, lb_refine's warps at L = 5000) may not fit another
    under the same key (M = 16, L = 8000).  ``auto`` measures the key
    again there and launches what fits; a pinned table holding that
    winner gives the selector's default."""
    entry, slot, call, first, second, won, default = \
        _ONE_KEY_TWO_GEOMETRIES[op]
    monkeypatch.setenv(tune.ENV, "auto")
    monkeypatch.setenv(tune.OUT_ENV, str(tmp_path))
    lib = _Lib()
    for module in (lb_ops, adc_ops):
        _fake_launch(monkeypatch, module, lib)
    param = next(iter(tune.GRIDS[op]))
    clock = _Clock(lambda p: 1.0 if p[param] == won else 2.0)
    monkeypatch.setattr(tune, "_time", clock)
    monkeypatch.setattr(torch, "empty_like", torch.zeros_like)
    monkeypatch.setattr(adc_ops, "_check_range", lambda K, **c: None)

    call(first)
    assert _row_calls(lib, entry)[-1][slot] == won
    (key,) = json.loads((tmp_path / "tuning.json").read_text())
    call(second)                         # raised before the check
    assert _row_calls(lib, entry)[-1][slot] == default
    second_report = tune.REPORT[-1]
    assert second_report["key"] == key and len(tune.REPORT) == 2
    assert "ValueError" in {c["params"][param]: c.get("error") for c in
                            second_report["candidates"]}[won]
    table = json.loads((tmp_path / "tuning.json").read_text())
    assert table == {key: {param: default}}

    # pinned: the table's entry does not fit, so the default is launched
    pinned = tmp_path / "pinned.json"
    pinned.write_text(json.dumps({key: {param: won}}))
    monkeypatch.setenv(tune.ENV, str(pinned))
    tune.reset()
    call(second)
    assert _row_calls(lib, entry)[-1][slot] == default
    call(first)
    assert _row_calls(lib, entry)[-1][slot] == won
