"""RS1xx — hot-path safety, in PyTorch terms (the counterpart of
:mod:`repro.analysis.rules_trace`).

The invariant these rules freeze: the obs-off hot path reads nothing back
from the card, and anything that must block does so through
``repro_torch.obs.fence`` (obs-gated) instead of a raw device sync.

* **RS101** host sync: ``.item()`` and ``torch.cuda.synchronize()`` (or a
  stream's / event's ``.synchronize()``) anywhere in ``src/repro_torch``
  (these *always* synchronise), plus the host reads ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.nonzero()`` / ``torch.nonzero``,
  ``int()`` / ``float()`` / ``bool()`` over a tensor expression and
  ``np.asarray`` / ``np.array`` over a tensor expression inside
  hot-reachable functions (on a CUDA tensor each one waits for the card
  and copies back).  The host wrappers in ``kernels/csrc/*.cu`` are read
  too, for ``cudaDeviceSynchronize``, ``cudaStreamSynchronize`` and a
  synchronous ``cudaMemcpy``: a sync inside the kernel library is
  invisible to PyTorch's sync debug mode, which the dynamic gate
  (:mod:`.check_sanitizers`) uses.
* **RS102** data-dependent Python branch (``if``/``while`` testing a
  tensor expression) in a hot-reachable function: an implicit
  ``bool(tensor)``, a device read each time the test runs.
* **RS104** mutation of module-level state from a hot-reachable
  function: a captured replay (a CUDA graph) skips it, and concurrent
  callers race on it.

RS103 (invalid or mutable ``static_argnames`` of a jit wrapper) has no
counterpart: eager PyTorch has no jit cache keys, so the port's catalog
leaves it out.

``repro_torch.obs`` modules are exempt from RS101: they implement the
fence.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional, Set

from .callgraph import CallGraph, FunctionInfo, dotted_parts
from .findings import Finding

__all__ = ["run", "run_csrc"]

# always a sync, with no arguments (a tensor's .item(); a stream's or an
# event's .synchronize())
_SYNC_ATTRS = frozenset({"item", "synchronize"})
_SYNC_FUNCS = frozenset({"torch.cuda.synchronize"})
# host reads: a sync on a CUDA tensor, free on a CPU one
_READ_ATTRS = frozenset({"tolist", "cpu", "numpy", "nonzero"})
_READ_FUNCS = frozenset({"torch.nonzero"})
_HOST_CONVERTERS = frozenset({
    "numpy.asarray", "numpy.array", "np.asarray", "np.array",
})
_CASTS = frozenset({"int", "float", "bool"})

# torch helpers that return Python values / static metadata — safe in an
# ``if`` test and in a cast
_STATIC_TORCH = frozenset({
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.finfo", "torch.iinfo", "torch.device", "torch.dtype",
    "torch.Size", "torch.get_default_dtype", "torch.promote_types",
    "torch.result_type", "torch.can_cast", "torch.is_grad_enabled",
    "torch.is_inference_mode_enabled", "torch.numel",
})
_STATIC_TORCH_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.profiler.", "torch.library.",
    "torch.distributed.", "torch.utils.", "torch.jit.", "torch.compiler.",
    "torch._C.", "torch.ops.",
)

# tensor methods whose value is a tensor: a cast or a branch over one
# reads the card
_TENSOR_METHODS = frozenset({
    "sum", "min", "max", "mean", "any", "all", "argmin", "argmax",
    "amin", "amax", "abs", "norm", "count_nonzero", "isfinite", "isnan",
    "eq", "ne", "lt", "le", "gt", "ge", "ravel", "reshape", "float",
    "long", "int", "to", "prod", "std", "var",
})

_CSRC_SYNC = re.compile(
    r"\b(cudaDeviceSynchronize|cudaStreamSynchronize|cudaMemcpy)\s*\(")


def _line(info: FunctionInfo, lineno: int) -> str:
    lines = info.module.source.splitlines()
    return lines[lineno - 1] if 0 < lineno <= len(lines) else ""


def _resolve(info: FunctionInfo, node: ast.AST) -> Optional[str]:
    parts = dotted_parts(node)
    if parts is None:
        return None
    imports = info.module.imports
    if parts[0] in imports:
        return ".".join([imports[parts[0]]] + parts[1:])
    return ".".join(parts)


def _scope_nodes(info: FunctionInfo):
    """The scope's own statements, excluding nested function bodies."""
    todo = list(ast.iter_child_nodes(info.node))
    while todo:
        n = todo.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        todo.extend(ast.iter_child_nodes(n))


def _is_tensor_fn(qual: str) -> bool:
    return (qual.startswith("torch.") and qual not in _STATIC_TORCH
            and not qual.startswith(_STATIC_TORCH_PREFIXES))


def _is_tensor_expr(expr: ast.AST, info: FunctionInfo) -> bool:
    """Heuristic: the expression's value is (or contains) a tensor — a
    ``torch.`` call or a tensor-method call like ``.min()`` / ``.any()``."""
    for n in ast.walk(expr):
        if not isinstance(n, ast.Call):
            continue
        qual = _resolve(info, n.func)
        if qual is not None and _is_tensor_fn(qual):
            return True
        if (isinstance(n.func, ast.Attribute)
                and n.func.attr in _TENSOR_METHODS
                and not _is_module(n.func.value, info)
                and not _is_shape_access(n.func.value)):
            return True
    return False


def _is_module(node: ast.AST, info: FunctionInfo) -> bool:
    """``np.max(...)``, ``math.floor(...)``: a function of an imported
    module, not a tensor method (``torch.`` functions are judged by
    name above)."""
    parts = dotted_parts(node)
    return parts is not None and parts[0] in info.module.imports


def _is_shape_access(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in ("shape", "ndim",
                                                       "dtype", "device"):
            return True
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in ("size", "dim", "numel")):
            return True
    return False


def run(graph: CallGraph) -> List[Finding]:
    out: List[Finding] = []
    reachable = graph.hot_reachable()
    mutable_globals = _module_mutable_globals(graph)
    for qual, info in graph.functions.items():
        if info.module.qualname.startswith("repro_torch.obs"):
            continue
        hot = qual in reachable
        out.extend(_rs101(info, hot))
        if hot:
            out.extend(_rs102(info))
            out.extend(_rs104(info, mutable_globals))
    return out


# -- RS101 -------------------------------------------------------------------

def _rs101(info: FunctionInfo, hot: bool) -> List[Finding]:
    out = []
    for n in _scope_nodes(info):
        if not isinstance(n, ast.Call):
            continue
        qual = _resolve(info, n.func)
        attr = n.func.attr if isinstance(n.func, ast.Attribute) else None
        hit = None
        if qual in _SYNC_FUNCS:
            hit = f"{qual}() is an unconditional host sync"
        elif attr in _SYNC_ATTRS and not n.args and not n.keywords:
            hit = f".{attr}() is an unconditional host sync"
        elif hot and (qual in _READ_FUNCS
                      or (attr in _READ_ATTRS and not n.args)):
            hit = (f"{qual}() reads the tensor back" if qual in _READ_FUNCS
                   else f".{attr}() reads the tensor back")
        elif (hot and qual in _HOST_CONVERTERS and n.args
              and _is_tensor_expr(n.args[0], info)):
            hit = f"{qual} over a tensor expression reads it back"
        elif (hot and isinstance(n.func, ast.Name)
              and n.func.id in _CASTS and len(n.args) == 1
              and _is_tensor_expr(n.args[0], info)):
            hit = (f"{n.func.id}() over a tensor expression forces a "
                   f"host sync")
        if hit is not None:
            where = "on a hot path" if hot else "outside obs.fence"
            out.append(Finding(
                rule="RS101", path=info.module.path, lineno=n.lineno,
                scope=info.qualname,
                message=f"{hit} {where}; route through obs.fence or "
                        f"suppress with a reason",
                source_line=_line(info, n.lineno)))
    return out


def run_csrc(csrc: Path) -> List[Finding]:
    """RS101 over the kernel library's host code (``csrc/*.cu``,
    ``*.cuh``): a device-wide or stream sync, or a synchronous copy."""
    out: List[Finding] = []
    if not csrc.is_dir():
        return out
    for path in sorted(csrc.iterdir()):
        if path.suffix not in (".cu", ".cuh"):
            continue
        for i, line in enumerate(
                path.read_text(encoding="utf-8").splitlines(), start=1):
            code = line.split("//", 1)[0]
            m = _CSRC_SYNC.search(code)
            if m is None:
                continue
            out.append(Finding(
                rule="RS101", path=path, lineno=i,
                scope=f"csrc.{path.stem}",
                message=f"{m.group(1)} blocks the host inside the kernel "
                        f"library, where PyTorch's sync debug mode cannot "
                        f"see it; launch on the caller's stream and let "
                        f"the caller decide when to wait",
                source_line=line))
    return out


# -- RS102 -------------------------------------------------------------------

def _rs102(info: FunctionInfo) -> List[Finding]:
    out = []
    for n in _scope_nodes(info):
        if not isinstance(n, (ast.If, ast.While)):
            continue
        if _is_tensor_expr(n.test, info):
            kind = "if" if isinstance(n, ast.If) else "while"
            out.append(Finding(
                rule="RS102", path=info.module.path, lineno=n.lineno,
                scope=info.qualname,
                message=f"data-dependent `{kind}` on a tensor expression "
                        f"in a hot function reads the card each time; use "
                        f"torch.where or decide from host-side state",
                source_line=_line(info, n.lineno)))
    return out


# -- RS104 -------------------------------------------------------------------

def _module_mutable_globals(graph: CallGraph) -> Set[str]:
    """``module.name`` for every module-level list/dict/set binding."""
    out: Set[str] = set()
    for mod in graph.modules.values():
        for stmt in mod.tree.body:
            value, targets = None, []
            if isinstance(stmt, ast.Assign):
                value, targets = stmt.value, stmt.targets
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                value, targets = stmt.value, [stmt.target]
            if isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                                  ast.DictComp, ast.SetComp)):
                for t in targets:
                    if isinstance(t, ast.Name):
                        out.add(f"{mod.qualname}.{t.id}")
    return out


def _rs104(info: FunctionInfo, mutable_globals: Set[str]) -> List[Finding]:
    out = []
    mod = info.module.qualname

    def _is_mutable_global(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            q = f"{mod}.{node.id}"
            if q in mutable_globals and node.id not in info.params:
                return node.id
        return None

    for n in _scope_nodes(info):
        name = None
        if isinstance(n, ast.Global):
            name = ", ".join(n.names)
        elif isinstance(n, ast.AugAssign):
            name = _is_mutable_global(n.target)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Subscript):
                    name = _is_mutable_global(t.value)
        elif isinstance(n, ast.Call):
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr in ("append", "extend", "update",
                                        "add", "pop", "clear", "remove",
                                        "setdefault")):
                name = _is_mutable_global(n.func.value)
        if name is not None:
            out.append(Finding(
                rule="RS104", path=info.module.path, lineno=n.lineno,
                scope=info.qualname,
                message=f"mutation of module-level state ({name}) in a "
                        f"hot function: a captured replay skips it and "
                        f"concurrent callers race on it",
                source_line=_line(info, n.lineno)))
    return out
