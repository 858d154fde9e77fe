"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

* ``portbench/configs/<config>.json``: the deployment (dataset shape,
  quantizer and index settings, precision, guarantees, assumptions);
* ``portbench/traffic/<traffic>.json``: the mix, read by the general
  generator of the entry it names (``entry``);
* ``portbench/workloads/<cell>.json``: the cell's limits for the numbers
  that decide ``correct`` and its traced slice;
* ``portbench/metrics/<metric>.py``: a per-layer reader, ``read(ctx)``,
  with ``MOVES`` the end-to-end metric it should move.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple

__all__ = ["ROOT", "BENCH_DIR", "Cell", "load_manifest", "load_cell",
           "load_reader", "check_manifest", "NAME_RE", "UNIT_RE"]

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Cell(NamedTuple):
    name: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    workload: dict        # the cell's own file
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, manifest: dict, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its files and the metrics it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    workload = _json(BENCH_DIR / "workloads" / f"{name}.json")
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if _reports(m, name, names)]
    return Cell(name, config, traffic, workload, int(w["chips"]), e2e,
                per_layer)


def load_reader(metric: str) -> ModuleType:
    """``portbench/metrics/<metric>.py`` as a module."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_manifest(manifest: dict, root: Path = ROOT) -> List[str]:
    """Faults in the manifest's names, units and files (empty when sound)."""
    faults = []
    names: Dict[str, set] = {"configs": set(), "workloads": set(),
                             "metrics": set()}

    def name_ok(kind, value):
        if not isinstance(value, str) or not NAME_RE.match(value):
            faults.append(f"{kind} name {value!r}")

    for c in manifest["configs"]:
        name_ok("config", c["name"])
        names["configs"].add(c["name"])
        if not (root / c["file"]).is_file():
            faults.append(f"config file {c['file']} missing")
        for key in c["reduced"]:
            name_ok("reduced key", key)
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        for kind in ("name", "config", "traffic"):
            name_ok(f"workload {kind}", w[kind])
        names["workloads"].add(w["name"])
        if w["config"] not in names["configs"]:
            faults.append(f"workload {w['name']} names config {w['config']}")
        for path in (BENCH_DIR / "traffic" / f"{w['traffic']}.json",
                     BENCH_DIR / "workloads" / f"{w['name']}.json"):
            if not path.is_file():
                faults.append(f"{path.relative_to(root)} missing")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        name_ok("metric", m["name"])
        if m["name"] in names["metrics"]:
            faults.append(f"metric {m['name']} twice")
        names["metrics"].add(m["name"])
        if not UNIT_RE.match(m["unit"]):
            faults.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            faults.append(f"better {m['better']!r} of {m['name']}")
        for cell in m.get("workloads", []):
            if cell not in names["workloads"]:
                faults.append(f"{m['name']} lists unknown cell {cell}")
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            faults.append(f"{m['name']} moves unknown {m['moves']}")
        if not (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file():
            faults.append(f"reader of {m['name']} missing")
    return faults
