"""RS2xx — dispatch invariants (the counterpart of
:mod:`repro.analysis.rules_dispatch`).

The static complement of the dynamic routing gate
(:mod:`.check_routing`): the dynamic gate proves a run went through the
kernels, these rules prove the wiring cannot silently decay between runs.

* **RS201** kernel triple incomplete: every package under
  ``src/repro_torch/kernels/<name>/`` ships ``ops.py`` (the wrappers),
  ``ref.py`` (the plain version the CPU route runs and the tests compare
  against), and its ``ops.py`` calls an entry point of the kernel library
  that some ``kernels/csrc/*.cu`` defines (the port's counterpart of the
  reference's ``kernel.py``).
* **RS202** kernel package not imported by ``core/dispatch.py`` — an
  unrouted kernel bypasses the routing ledger.
* **RS203** dispatch op (a ``_count("<op>", ...)`` site in
  ``core/dispatch.py``) missing from ``EXPECTED_OPS`` in the port's
  routing gate (``analysis/check_routing.py``) — the dynamic gate would
  never notice the op falling off the kernel route.
* **RS204** ``torch.vmap`` / ``torch.func.vmap`` over a function that
  can reach a CUDA launch (a call of ``kernels._build.lib``): the kernels
  take their batch as a grid axis, and a launch through ctypes has no
  batching rule.
* **RS205** the routing gate consumes exactly one dump format: every
  ``ledger = ...`` binding goes through ``ledger_from_snapshot`` (no
  flat-dict fallback branches).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional, Set

from .callgraph import CallGraph, dotted_parts
from .findings import Finding

__all__ = ["run"]

# the port's routing gate, relative to the tree's root
ROUTING_GATE = Path("src/repro_torch/analysis/check_routing.py")

_PAIR = ("ops.py", "ref.py")
_CU_SUFFIXES = (".cu", ".cuh")


def _first_line(path: Path) -> str:
    try:
        return path.read_text(encoding="utf-8").splitlines()[0]
    except (OSError, IndexError):
        return ""


def run(graph: CallGraph, root: Path) -> List[Finding]:
    out: List[Finding] = []
    pkg_root = root / "src" / "repro_torch"
    kernels_dir = pkg_root / "kernels"
    csrc = kernels_dir / "csrc"
    dispatch_path = pkg_root / "core" / "dispatch.py"
    routing_path = root / ROUTING_GATE
    dispatch_src = (dispatch_path.read_text(encoding="utf-8")
                    if dispatch_path.exists() else "")
    entries = defined_entries(csrc)

    if kernels_dir.is_dir():
        for pkg in sorted(p for p in kernels_dir.iterdir() if p.is_dir()):
            if pkg.name in ("__pycache__", "csrc"):
                continue
            out.extend(_rs201(pkg, entries))
            out.extend(_rs202(pkg, dispatch_src))

    if dispatch_path.exists() and routing_path.exists():
        out.extend(_rs203(dispatch_path, routing_path))
    if routing_path.exists():
        out.extend(_rs205(routing_path))

    out.extend(_rs204(graph))
    return out


def _anchor(pkg: Path) -> Path:
    """The file a kernel-package finding (and its suppression) lives in."""
    for name in ("ops.py", "ref.py", "__init__.py"):
        if (pkg / name).exists():
            return pkg / name
    return pkg / "ops.py"


def defined_entries(csrc: Path) -> Set[str]:
    """Names of the functions the ``csrc`` sources define at the start of
    a line (``int pq_dtw_band(...`` inside ``extern "C"``)."""
    found: Set[str] = set()
    if not csrc.is_dir():
        return found
    head = re.compile(
        r"^[A-Za-z_][\w \t\*&:<>]*?[\s\*&]([A-Za-z_]\w*)\s*\(", re.M)
    for path in sorted(csrc.iterdir()):
        if path.suffix in _CU_SUFFIXES:
            found.update(head.findall(path.read_text(encoding="utf-8")))
    return found


def _is_lib_call(node: ast.AST, lib_names: Set[str]) -> bool:
    """``_build.lib()`` / ``lib()`` / a local bound from either."""
    if isinstance(node, ast.Name):
        return node.id in lib_names
    if isinstance(node, ast.Call):
        parts = dotted_parts(node.func)
        return parts is not None and parts[-1] == "lib"
    return False


def library_calls(ops_path: Path) -> Set[str]:
    """The kernel-library entry points ``ops.py`` calls:
    ``_build.lib().<entry>(...)`` or ``<name>.<entry>(...)`` with
    ``<name>`` bound from ``_build.lib()``."""
    tree = ast.parse(ops_path.read_text(encoding="utf-8"))
    lib_names: Set[str] = set()
    for n in ast.walk(tree):
        if not isinstance(n, ast.Assign):
            continue
        pairs = []
        for t in n.targets:
            if isinstance(t, ast.Name):
                pairs.append((t, n.value))
            elif (isinstance(t, ast.Tuple) and isinstance(n.value, ast.Tuple)
                  and len(t.elts) == len(n.value.elts)):
                pairs.extend(zip(t.elts, n.value.elts))
        for t, v in pairs:
            if isinstance(t, ast.Name) and _is_lib_call(v, set()):
                lib_names.add(t.id)
    return {n.func.attr for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and _is_lib_call(n.func.value, lib_names)}


def _rs201(pkg: Path, entries: Set[str]) -> List[Finding]:
    present = [n for n in _PAIR if (pkg / n).exists()]
    if not present:
        return []                    # not a kernel package
    missing = [n for n in _PAIR if n not in present]
    if not missing and library_calls(pkg / "ops.py") & entries:
        return []
    if not missing:
        missing = ["a kernels/csrc/*.cu entry point its ops.py calls"]
    anchor = _anchor(pkg)
    return [Finding(
        rule="RS201", path=anchor, lineno=1, scope=f"kernels.{pkg.name}",
        message=f"kernel package {pkg.name!r} is missing "
                f"{', '.join(missing)}; every kernel ships ops.py, ref.py "
                f"and a CUDA source its ops.py launches",
        source_line=_first_line(anchor))]


def _rs202(pkg: Path, dispatch_src: str) -> List[Finding]:
    if not (pkg / "ops.py").exists():
        return []
    if f"kernels.{pkg.name}." in dispatch_src:
        return []
    anchor = _anchor(pkg)
    return [Finding(
        rule="RS202", path=anchor, lineno=1, scope=f"kernels.{pkg.name}",
        message=f"kernel package {pkg.name!r} is not imported by "
                f"core/dispatch.py; unrouted kernels bypass the routing "
                f"ledger",
        source_line=_first_line(anchor))]


def _string_set(tree: ast.Module, name: str) -> Optional[Set[str]]:
    for stmt in tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                return {n.value for n in ast.walk(stmt)
                        if isinstance(n, ast.Constant)
                        and isinstance(n.value, str)}
    return None


def _rs203(dispatch_path: Path, routing_path: Path) -> List[Finding]:
    dispatch_tree = ast.parse(dispatch_path.read_text(encoding="utf-8"))
    routing_tree = ast.parse(routing_path.read_text(encoding="utf-8"))
    expected = _string_set(routing_tree, "EXPECTED_OPS")
    if expected is None:
        return [Finding(
            rule="RS203", path=routing_path, lineno=1, scope="<module>",
            message=f"{ROUTING_GATE} has no EXPECTED_OPS set; the routing "
                    f"gate cannot assert op coverage",
            source_line=_first_line(routing_path))]
    src_lines = dispatch_path.read_text(encoding="utf-8").splitlines()
    out = []
    for n in ast.walk(dispatch_tree):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "_count" and n.args
                and isinstance(n.args[0], ast.Constant)
                and isinstance(n.args[0].value, str)):
            op = n.args[0].value
            if op not in expected:
                out.append(Finding(
                    rule="RS203", path=dispatch_path, lineno=n.lineno,
                    scope="core.dispatch",
                    message=f"dispatch op {op!r} is not gated by "
                            f"EXPECTED_OPS in {ROUTING_GATE}",
                    source_line=src_lines[n.lineno - 1]
                    if n.lineno <= len(src_lines) else ""))
    return out


def _rs204(graph: CallGraph) -> List[Finding]:
    reaches = graph.reaches_cuda()
    out = []
    for site in graph.vmap_sites:
        if site.target is not None and site.target in reaches:
            lines = site.module.source.splitlines()
            out.append(Finding(
                rule="RS204", path=site.module.path, lineno=site.lineno,
                scope=site.caller,
                message=f"torch.vmap over {site.target} which can reach a "
                        f"CUDA launch; the kernels take batch dims as grid "
                        f"axes, and a ctypes launch has no batching rule",
                source_line=lines[site.lineno - 1]
                if site.lineno <= len(lines) else ""))
    return out


def _rs205(routing_path: Path) -> List[Finding]:
    tree = ast.parse(routing_path.read_text(encoding="utf-8"))
    lines = routing_path.read_text(encoding="utf-8").splitlines()
    out = []
    for n in ast.walk(tree):
        if not isinstance(n, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "ledger"
                   for t in n.targets):
            continue
        ok = (isinstance(n.value, ast.Call)
              and isinstance(n.value.func, ast.Name)
              and n.value.func.id == "ledger_from_snapshot")
        if not ok:
            out.append(Finding(
                rule="RS205", path=routing_path, lineno=n.lineno,
                scope="check_routing",
                message="the routing gate must consume exactly one dump "
                        "format: bind `ledger` only via "
                        "ledger_from_snapshot(...) (no flat-dict fallback)",
                source_line=lines[n.lineno - 1]
                if n.lineno <= len(lines) else ""))
    return out
