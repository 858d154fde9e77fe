"""repro_torch.analysis: fixture trees in the port's idioms seed one
violation per carried rule (bad) with clean equivalents (good); the
suppression / baseline mechanics; the CLI exit codes; the routing gate's
single-format contract and its checks on a snapshot of the CPU route; the
live port tree clean against its baseline; and parity with the
reference's analysis (every trace root with a port counterpart is a hot
root, the serving core's writer sets are the reference's)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import analyze as reference_analyze
from repro.serve_index.server import IndexServer as RefServer
from repro_torch.analysis import RULES, analyze
from repro_torch.analysis import (check_routing, check_sanitizers,
                                  check_static)
from repro_torch.analysis.callgraph import HOT_ROOTS
from repro_torch.analysis.engine import BASELINE
from repro_torch.analysis.findings import write_baseline
from repro_torch.obs import export as obs_export
from repro_torch.obs import registry as obs_registry
from repro_torch.serve_index.server import IndexServer

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "fixtures" / "analysis_torch"
CARRIED = {"RS001", "RS002", "RS101", "RS102", "RS104", "RS201", "RS202",
           "RS203", "RS204", "RS205", "RS301", "RS302", "RS303"}


def _rules(report):
    return {f.rule for f in report.findings}


def _by_rule(report, rule):
    return [f for f in report.findings if f.rule == rule]


def test_catalog_is_the_carried_rules():
    # RS103 (jit static_argnames) has no counterpart in eager PyTorch
    assert set(RULES) == CARRIED


# -- RS1xx: hot-path safety --------------------------------------------------

def test_rs1_bad_tree_flags_each_rule():
    r = analyze(FIXTURES / "rs1_bad")
    assert _rules(r) == {"RS101", "RS102", "RS104"}
    rs101 = _by_rule(r, "RS101")
    # float() and np.asarray over tensors in the hot helper, .item()
    # anywhere, and the stream sync in the kernel library's host code
    assert sorted(f.scope.rsplit(".", 1)[-1] for f in rs101) == \
        ["helper", "helper", "report", "scan"]
    assert {f.path.suffix for f in rs101} == {".py", ".cu"}
    # .cpu().numpy() in the function no hot root reaches: not flagged
    assert not any("offline" in f.scope for f in r.findings)
    (f102,) = _by_rule(r, "RS102")
    assert f102.scope.endswith("filtered_topk")
    (f104,) = _by_rule(r, "RS104")
    assert "_CACHE" in f104.message


def test_rs1_good_tree_is_clean():
    r = analyze(FIXTURES / "rs1_good")
    assert r.clean, [f.render(FIXTURES) for f in r.findings]


# -- RS2xx: dispatch invariants ----------------------------------------------

def test_rs2_bad_tree_flags_each_rule():
    r = analyze(FIXTURES / "rs2_bad")
    assert _rules(r) == {"RS201", "RS202", "RS203", "RS204", "RS205"}
    f201 = {f.path.parts[-2]: f for f in _by_rule(r, "RS201")}
    assert set(f201) == {"badk", "nolib"}
    assert "ref.py" in f201["badk"].message
    assert "csrc" in f201["nolib"].message      # pq_nolib is defined nowhere
    (f202,) = _by_rule(r, "RS202")
    assert f202.path.parts[-3:] == ("kernels", "badk", "ops.py")
    # both orphan _count sites flag independently: the base op and its
    # mode twin
    f203 = _by_rule(r, "RS203")
    assert {m for f in f203 for m in ("orphan_op", "orphan_op_adaptive")
            if f"{m}'" in f.message} == {"orphan_op", "orphan_op_adaptive"}
    (f204,) = _by_rule(r, "RS204")
    assert "run_badk" in f204.message
    (f205,) = _by_rule(r, "RS205")
    assert f205.path.name == "check_routing.py"


def test_rs2_good_tree_is_clean():
    r = analyze(FIXTURES / "rs2_good")
    assert r.clean, [f.render(FIXTURES) for f in r.findings]


# -- RS3xx: serving concurrency ----------------------------------------------

def test_rs3_bad_tree_flags_each_rule():
    r = analyze(FIXTURES / "rs3_bad")
    assert _rules(r) == {"RS301", "RS302", "RS303"}
    (f301,) = _by_rule(r, "RS301")
    assert "_view" in f301.message and f301.scope.endswith("search")
    (f302,) = _by_rule(r, "RS302")
    assert "view.version" in f302.message
    assert len(_by_rule(r, "RS303")) == 2  # acquire + release


def test_rs3_good_tree_is_clean():
    r = analyze(FIXTURES / "rs3_good")
    assert r.clean, [f.render(FIXTURES) for f in r.findings]


def test_every_carried_rule_fires_on_a_bad_tree():
    fired = set()
    for case in ("rs1_bad", "rs2_bad", "rs3_bad", "meta_bad"):
        fired |= _rules(analyze(FIXTURES / case))
    assert fired == CARRIED


# -- suppression + baseline mechanics ----------------------------------------

def test_suppression_hygiene_meta_rules():
    r = analyze(FIXTURES / "meta_bad")
    # the reasonless ignores (in Python and after // in a CUDA source)
    # suppress RS101 but raise RS001; the ignore that matches nothing
    # raises RS002
    assert _rules(r) == {"RS001", "RS002"}
    assert sorted(f.path.suffix for f in _by_rule(r, "RS001")) == \
        [".cu", ".py"]


def test_reasoned_suppression_silences():
    r = analyze(FIXTURES / "meta_good")
    assert r.clean, [f.render(FIXTURES) for f in r.findings]


def test_baseline_freezes_then_ratchets(tmp_path):
    bad = FIXTURES / "rs1_bad"
    baseline = tmp_path / "baseline.json"
    write_baseline(baseline, analyze(bad).findings, bad)

    # frozen but unjustified: still a failure (the growth gate)
    r = analyze(bad, baseline_path=baseline)
    assert not r.findings and r.unjustified_baseline and not r.clean

    data = json.loads(baseline.read_text())
    for entry in data["findings"].values():
        entry["justification"] = "frozen pre-existing debt"
    baseline.write_text(json.dumps(data))
    assert analyze(bad, baseline_path=baseline).clean

    # debt paid (the good tree): every entry is stale and must go
    r = analyze(FIXTURES / "rs1_good", baseline_path=baseline)
    assert not r.findings and r.stale_baseline and not r.clean


# -- CLI + live tree ---------------------------------------------------------

def _run(module, *args):
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.analysis.{module}", *args],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))


def _main(module, capsys, *args):
    """``module.main(args)`` in-process: (exit code, stdout)."""
    rc = module.main(list(args))
    return rc, capsys.readouterr().out


def test_cli_runs_as_a_module():
    rules = _run("check_static", "--list-rules")
    assert rules.returncode == 0 and "RS204" in rules.stdout
    assert "RS103" not in rules.stdout


def test_cli_exit_codes(tmp_path, capsys):
    rc, out = _main(check_static, capsys, "--root",
                    str(FIXTURES / "rs1_bad"))
    assert rc == 1 and "RS101" in out
    rc, out = _main(check_static, capsys, "--root",
                    str(FIXTURES / "rs1_good"))
    assert rc == 0 and "OK" in out
    assert _main(check_static, capsys, "--root", str(tmp_path))[0] == 2
    with pytest.raises(SystemExit) as usage:
        check_static.main(["--no-such-flag"])
    assert usage.value.code == 2
    frozen = tmp_path / "frozen.json"
    rc, _ = _main(check_static, capsys, "--root", str(FIXTURES / "rs1_bad"),
                  "--baseline", str(frozen), "--write-baseline")
    assert rc == 0 and frozen.exists()
    rc, out = _main(check_static, capsys, "--root",
                    str(FIXTURES / "rs1_bad"), "--baseline", str(frozen))
    assert rc == 1 and "justification" in out


def test_live_tree_is_clean():
    r = analyze(REPO, baseline_path=REPO / BASELINE)
    assert r.clean, (
        [f.render(REPO) for f in r.findings],
        r.stale_baseline, r.unjustified_baseline)
    # the held item's findings are frozen, not silenced: H2's wave flag
    # (the ADC range check's read-back is gone: codes are checked where
    # they enter the program)
    baseline = json.loads((REPO / BASELINE).read_text())["findings"]
    held = {"src/repro_torch/core/lb_search.py": "ROADMAP H2"}
    assert {e["path"] for e in baseline.values()} == set(held)
    assert all(held[e["path"]] in e["justification"]
               for e in baseline.values())


def test_live_tree_graph_sanity():
    r = analyze(REPO)
    g = r.graph
    # every declared hot root exists: a renamed function must not
    # silently drop a root
    assert sorted(set(HOT_ROOTS) - set(g.functions)) == []
    assert len(HOT_ROOTS) == len(set(HOT_ROOTS)) == len(g.hot_roots())
    # the analysis reads the port only, never itself
    assert not any(m.startswith(("repro.", "repro_torch.analysis"))
                   for m in g.modules)
    launchers = {q.rsplit(".", 1)[0] for q in g.cuda_launchers()}
    for pkg in ("dtw_band", "lb_cascade", "pq_adc", "pq_attn",
                "prealign_encode"):
        assert f"repro_torch.kernels.{pkg}.ops" in launchers
    hot = g.hot_reachable()
    assert "repro_torch.kernels.dtw_band.ops._launch_pairs" in hot
    assert "repro_torch.core.dispatch._count" in hot


def test_hot_roots_cover_the_reference_trace_roots():
    ref = reference_analyze(REPO).graph
    port = analyze(REPO).graph
    counterparts = {"repro_torch" + q[len("repro"):]
                    for q in ref.trace_roots()}
    present = {q for q in counterparts if q in port.functions}
    assert len(present) >= 38
    assert sorted(present - port.hot_roots()) == []


def test_writer_sets_equal_the_reference():
    assert IndexServer._WRITER_ONLY == RefServer._WRITER_ONLY
    assert IndexServer._WRITER_METHODS == RefServer._WRITER_METHODS
    for name in IndexServer._WRITER_METHODS:
        assert callable(getattr(IndexServer, name))


# -- the routing gate --------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_snapshot():
    """A snapshot of one CPU dispatch of every op (and of each measured
    op under a non-DTW measure), in a registry of its own."""
    reg = obs_registry.Registry()
    saved = obs_registry.REGISTRY
    obs_registry.REGISTRY = reg
    try:
        for _, thunk in check_sanitizers.device_ops("cpu"):
            thunk()
    finally:
        obs_registry.REGISTRY = saved
    return obs_export.snapshot(reg)


def test_sanitizer_ops_cover_the_routing_gate():
    names = [n for n, _ in check_sanitizers.device_ops("cpu")]
    assert len(names) == len(set(names))
    assert set(check_routing.EXPECTED_OPS) <= set(names)
    assert {f"{op}[" for op in check_routing.MEASURED_OPS} == \
        {n.split("[")[0] + "[" for n in names if "[" in n}
    # a known read names an op the gate runs, at a function that exists
    assert set(check_sanitizers.KNOWN_READS) <= set(names)
    for path, func in set(check_sanitizers.KNOWN_READS.values()):
        src = (REPO / "src" / "repro_torch" / path).read_text()
        assert f"def {func}(" in src


_CHECK = "/w/src/repro_torch/kernels/pq_adc/ops.py:275 in check_codes: "
# a table of the form KNOWN_READS takes: the ADC range check as it was
# listed, before its read moved to where codes enter the program
_READS = {op: ("kernels/pq_adc/ops.py", "check_codes")
          for op in ("adc_cdist", "adc_lookup_quant")}


@pytest.mark.parametrize("name,culprit,want", [
    ("adc_cdist", f"RuntimeError: {_CHECK}x.tolist()", True),
    ("adc_lookup_quant", f"RuntimeError: {_CHECK}x.tolist()", True),
    # the same op waiting anywhere else is a new trip
    ("adc_cdist", "RuntimeError: /w/src/repro_torch/kernels/pq_adc/"
     "ops.py:300 in adc_sym_cdist: x.item()", False),
    ("adc_cdist", "RuntimeError: /w/src/repro_torch/core/pq.py:260 in "
     "check_codes: x.tolist()", False),
    # an op outside the table, even at the known call
    ("prealign_encode", f"RuntimeError: {_CHECK}x.tolist()", False),
    ("adc_cdist", None, False),
])
def test_known_reads_match_only_their_call(name, culprit, want):
    assert check_sanitizers.known(name, culprit, _READS) is want
    # no read is left in the live table: every op that trips is new
    assert not check_sanitizers.known(name, culprit)


def test_routing_gate_passes_on_the_cpu_route(cpu_snapshot):
    rc, lines = check_routing.check(cpu_snapshot, "torch", stages=False)
    assert rc == 0, lines
    rc, lines = check_routing.check(cpu_snapshot, "cuda", stages=False)
    assert rc == 1 and "never dispatched" in lines[-1]


def _without(snap, keep):
    out = dict(snap)
    out["counters"] = [c for c in snap["counters"] if keep(c)]
    return out


def test_routing_gate_flags_a_missing_op(cpu_snapshot):
    snap = _without(cpu_snapshot,
                    lambda c: c["labels"].get("op") != "two_level_coarse")
    rc, lines = check_routing.check(snap, "torch", stages=False)
    assert rc == 1 and "two_level_coarse" in lines[-1]


def test_routing_gate_flags_no_non_dtw_measure(cpu_snapshot):
    snap = _without(cpu_snapshot,
                    lambda c: c["labels"].get("measure") in (None, "dtw"))
    rc, lines = check_routing.check(snap, "torch", stages=False)
    assert rc == 1 and "non-DTW" in lines[-1]
    for op in check_routing.MEASURED_OPS:
        assert op in lines[-1]


def _with_stages(snap, stages):
    out = dict(snap, obs_enabled=True)
    out["histograms"] = [
        {"name": "stage_seconds", "labels": {"stage": s}, "count": 1}
        for s in stages]
    return out


def test_routing_gate_checks_stages(cpu_snapshot):
    stages = check_routing.EXPECTED_STAGES
    rc, lines = check_routing.check(_with_stages(cpu_snapshot, stages),
                                    "torch")
    assert rc == 0 and "stages recorded spans" in lines[-1]
    rc, lines = check_routing.check(
        _with_stages(cpu_snapshot, stages[1:]), "torch")
    assert rc == 1 and stages[0] in lines[-1]
    # obs off: the stage gate is skipped unless asked for
    rc, lines = check_routing.check(cpu_snapshot, "torch")
    assert rc == 0 and lines[-1].startswith("note")
    rc, lines = check_routing.check(cpu_snapshot, "torch", stages=True)
    assert rc == 1 and "zero samples" in lines[-1]


def test_routing_gate_rejects_a_flat_dict(tmp_path):
    flat = tmp_path / "flat.json"
    flat.write_text(json.dumps({"elastic_pairwise:cuda": 3}))
    res = _run("check_routing", str(flat))
    assert res.returncode == 2 and "flat routing dict" in res.stdout


def test_routing_gate_accepts_a_snapshot_file(tmp_path, cpu_snapshot,
                                              capsys):
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps(cpu_snapshot))
    assert _main(check_routing, capsys, str(snap), "torch")[0] == 0
    rc, out = _main(check_routing, capsys, str(snap))  # default: cuda
    assert rc == 1 and "never dispatched" in out
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"counters": []}))
    assert _main(check_routing, capsys, str(empty), "torch")[0] == 1
    assert _main(check_routing, capsys)[0] == 2          # usage
