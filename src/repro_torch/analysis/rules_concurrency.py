"""RS3xx — serving-layer concurrency discipline (a copy of
:mod:`repro.analysis.rules_concurrency`).

The ``serve_index`` threading model: one writer thread owns all
mutable index state and publishes immutable frozen ``IndexView``
snapshots by atomic rebind; readers only ever touch a captured view;
all lock/condition use goes through ``with`` blocks.

* **RS301** a field named in a class's ``_WRITER_ONLY`` set is assigned
  outside ``__init__`` / the methods named in ``_WRITER_METHODS`` —
  i.e. off the writer thread.
* **RS302** attribute assignment on a published view object (a local
  bound from ``*.capture(...)`` or read from ``.view``/``._view``) —
  views are immutable after publish; build a new one instead.
* **RS303** bare ``.acquire()``/``.release()`` on a lock-like object in
  ``repro_torch.serve_index`` — pairing by hand leaks on exceptions; use
  ``with``.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .callgraph import CallGraph, FunctionInfo, ModuleInfo
from .findings import Finding

__all__ = ["run"]

_VIEW_ATTRS = frozenset({"view", "_view"})
_LOCK_MODULE_PREFIX = "repro_torch.serve_index"


def _line(mod: ModuleInfo, lineno: int) -> str:
    lines = mod.source.splitlines()
    return lines[lineno - 1] if 0 < lineno <= len(lines) else ""


def run(graph: CallGraph) -> List[Finding]:
    out: List[Finding] = []
    for mod in graph.modules.values():
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(_rs301(mod, node))
    for info in graph.functions.values():
        out.extend(_rs302(info))
        if info.module.qualname.startswith(_LOCK_MODULE_PREFIX):
            out.extend(_rs303(info))
    return out


# -- RS301 -------------------------------------------------------------------

def _class_name_set(cls: ast.ClassDef, attr: str) -> Set[str]:
    for stmt in cls.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == attr):
            return {n.value for n in ast.walk(stmt.value)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)}
    return set()


def _rs301(mod: ModuleInfo, cls: ast.ClassDef) -> List[Finding]:
    writer_only = _class_name_set(cls, "_WRITER_ONLY")
    if not writer_only:
        return []
    writer_methods = _class_name_set(cls, "_WRITER_METHODS") | {"__init__"}
    out = []
    for stmt in cls.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if stmt.name in writer_methods:
            continue
        for n in ast.walk(stmt):
            targets = []
            if isinstance(n, ast.Assign):
                targets = n.targets
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and t.attr in writer_only):
                    out.append(Finding(
                        rule="RS301", path=mod.path, lineno=n.lineno,
                        scope=f"{mod.qualname}.{cls.name}.{stmt.name}",
                        message=f"writer-only field self.{t.attr} "
                                f"assigned outside the writer methods "
                                f"({', '.join(sorted(writer_methods))})",
                        source_line=_line(mod, n.lineno)))
    return out


# -- RS302 -------------------------------------------------------------------

def _view_locals(info: FunctionInfo) -> Set[str]:
    """Local names bound from ``*.capture(...)`` or ``.view``/``._view``."""
    names: Set[str] = set()
    for n in ast.walk(info.node):
        if not isinstance(n, ast.Assign) or len(n.targets) != 1:
            continue
        t = n.targets[0]
        if not isinstance(t, ast.Name):
            continue
        v = n.value
        if (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
                and v.func.attr == "capture"):
            names.add(t.id)
        elif isinstance(v, ast.Attribute) and v.attr in _VIEW_ATTRS:
            names.add(t.id)
    return names


def _rs302(info: FunctionInfo) -> List[Finding]:
    # the view module itself may build instances however it likes
    if info.module.qualname.endswith(".view"):
        return []
    views = _view_locals(info)
    if not views:
        return []
    out = []
    for n in ast.walk(info.node):
        hit = None
        if isinstance(n, (ast.Assign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in views):
                    hit = f"{t.value.id}.{t.attr} = ..."
        elif (isinstance(n, ast.Call)
              and isinstance(n.func, ast.Attribute)
              and n.func.attr == "__setattr__"
              and n.args and isinstance(n.args[0], ast.Name)
              and n.args[0].id in views):
            hit = f"object.__setattr__({n.args[0].id}, ...)"
        if hit is not None:
            out.append(Finding(
                rule="RS302", path=info.module.path, lineno=n.lineno,
                scope=info.qualname,
                message=f"{hit} mutates a published IndexView; views are "
                        f"immutable after publish — capture a new one",
                source_line=_line(info.module, n.lineno)))
    return out


# -- RS303 -------------------------------------------------------------------

def _rs303(info: FunctionInfo) -> List[Finding]:
    out = []
    for n in ast.walk(info.node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("acquire", "release")):
            out.append(Finding(
                rule="RS303", path=info.module.path, lineno=n.lineno,
                scope=info.qualname,
                message=f"bare .{n.func.attr}() pairs the lock by hand "
                        f"and leaks on exceptions; use `with`",
                source_line=_line(info.module, n.lineno)))
    return out
