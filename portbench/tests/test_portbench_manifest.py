"""BENCHMARK.json and the files it names: the required keys, names and
units, and discovery of every configuration, traffic mix, cell and reader
by its name."""

import json

import pytest

from portbench.manifest import (BENCH_DIR, NAME_RE, ROOT, UNIT_RE,
                                check_manifest, load_cell, load_manifest,
                                load_reader)

MANIFEST = load_manifest()
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_manifest_is_sound():
    assert set(MANIFEST) == TOP_KEYS
    assert check_manifest(MANIFEST) == []
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entry_keys(section):
    for entry in MANIFEST[section]:
        extra = set(entry) - ENTRY_KEYS[section] - {"workloads"}
        assert not extra and ENTRY_KEYS[section] <= set(entry), entry


def test_command_and_paths():
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_end_to_end_metrics():
    names = {m["name"] for m in MANIFEST["end_to_end"]}
    assert names == {"classify_series_per_s", "setup_s"}
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name,ok", [
    ("starlight-classify", True), ("encode.glue_ms", True), ("_x", True),
    ("a b", False), ("a/b", False), ("a,b", False), ("-a", False),
    ("x" * 65, False), ("µs", False)])
def test_name_rule(name, ok):
    assert bool(NAME_RE.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("series/s", True), ("%", True), ("ms", True), ("queries/s", True),
    ("count", True), ("tokens per s", False), ("µs", False),
    ("x" * 17, False)])
def test_unit_rule(unit, ok):
    assert bool(UNIT_RE.match(unit)) is ok


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cells_found_by_name(cell):
    c = load_cell(cell, MANIFEST)
    assert c.chips == 1
    assert c.traffic["entry"] == "classify"
    assert set(c.workload["limits"]) and c.workload["trace_slice_s"] > 0
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_readers_found_by_name(metric):
    entry = next(m for m in MANIFEST["per_layer"] if m["name"] == metric)
    reader = load_reader(metric)
    assert reader.MOVES == entry["moves"]

    class Empty:
        cell, config, geo, slice, stats, hand_written = (
            "x", {}, None, None, {}, frozenset())

    assert reader.read(Empty()) is None


@pytest.mark.parametrize("config", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config_files(config):
    with open(ROOT / config["file"]) as f:
        body = json.load(f)
    assert body["name"] == config["name"]
    assert body["precision"] == "float32"
    assert body["assumed"] and body["guarantees"]
    assert config["file"].startswith("portbench/")


def test_every_traffic_and_workload_file_is_used():
    traffic = {w["traffic"] for w in MANIFEST["workloads"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert {p.stem for p in (BENCH_DIR / "traffic").glob("*.json")} == traffic
    assert {p.stem for p in (BENCH_DIR / "workloads").glob("*.json")} == cells
    readers = {p.stem for p in (BENCH_DIR / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in MANIFEST["per_layer"]}
