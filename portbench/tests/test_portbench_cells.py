"""A tiny run of every cell on the CPU (the plain route), untraced and
traced: the last line is the result object, the compared numbers come
last on standard error and in the result, and a sound program is
correct.  Also: the command refuses to run without a card, and in a
directory that holds only the benchmark."""

import io
import json
import shutil
import subprocess
import sys

import pytest

from portbench.harness import run_cell
from portbench.manifest import ROOT, load_manifest

from .conftest import BIG_SEED, TINY

CELLS = [w["name"] for w in load_manifest()["workloads"]]


def _run(cell, trace, seconds=1.0, seed=BIG_SEED, **kw):
    out, err = io.StringIO(), io.StringIO()
    result = run_cell(cell, seed, seconds, trace, device="cpu",
                      overrides=TINY, out=out, err=err, **kw)
    return result, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_the_result_line(cell, trace):
    result, out, err = _run(cell, trace)
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert {"metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["memory_peak_bytes"] == 0
    manifest = load_manifest()
    if not trace:
        want = {m["name"] for m in manifest["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == want
        assert line["metrics"]["setup_s"]["value"] > 0
    else:
        allowed = {m["name"] for m in manifest["per_layer"]
                   if cell in m.get("workloads", [])}
        assert set(line["metrics"]) <= allowed
        assert "busy_s" in dev and "window_s" in dev
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in line["metrics"].values():
        assert isinstance(m["value"], (int, float)) and m["unit"]
    last = err.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), last):
        assert text == f"check {name} {c['value']!r} limit {c['limit']!r}"


def test_same_seed_same_inputs():
    import torch
    from portbench.entries.classify import Cell
    from portbench.manifest import load_cell
    from portbench.harness import _merge
    c = load_cell("starlight-classify", load_manifest())
    cfg = _merge(c.config, TINY)
    a, b = (Cell(cfg, c.traffic, BIG_SEED, "cpu") for _ in range(2))
    a.make_inputs()
    b.make_inputs()
    assert torch.equal(a.train, b.train) and torch.equal(a.rows, b.rows)
    assert all(torch.equal(x, y) for x, y in zip(a.tests, b.tests))
    other = Cell(cfg, c.traffic, BIG_SEED + 1, "cpu")
    other.make_inputs()
    assert not torch.equal(a.train, other.train)


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "electric-classify", "--seed", str(BIG_SEED), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    proc = _cli(ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    """Only BENCHMARK.json and portbench/: the program is missing, so the
    run fails before any result, on the CPU route too."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.harness import run_cell\n"
            "run_cell('electric-classify', 1, 0.5, False, device='cpu')\n"
            % str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "repro_torch" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    """The command itself on a card, a short window: correct, and the
    result names the card."""
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(BIG_SEED), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, proc.stderr[-3000:]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
