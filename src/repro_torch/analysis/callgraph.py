"""AST module index + best-effort call graph over ``src/repro_torch``
(the counterpart of :mod:`repro.analysis.callgraph`).

The static rules (:mod:`.rules_trace`, ``rules_dispatch``,
``rules_concurrency``) need three global facts no single-file linter can
compute:

* which functions are *hot roots*.  The reference finds its trace roots
  from ``jax.jit`` and the tracing transforms; eager PyTorch has none, so
  the port declares them: :data:`HOT_ROOTS`, the port counterparts (same
  module path and qualname) of the reference's trace roots, then the
  functions that run inline what the reference traces as a nested body or
  lambda, each with its reason;
* which functions are *hot-reachable* — called (directly, through a
  locally defined helper, or referenced as a function argument) from a
  hot root, so a host sync inside them lands on a hot path;
* which functions can *launch a CUDA kernel* — reach a call of
  :func:`repro_torch.kernels._build.lib` through the same edges — so a
  ``torch.vmap`` over one can be flagged.

Resolution is intentionally best-effort and *overapproximating*: a name
that cannot be resolved contributes no edge (no false reachability), a
function reference passed anywhere contributes an edge whether or not it
is ultimately invoked (reachability never under-reports on the hot
paths, which is the failure mode that matters for a gate).  Method calls
through ``self`` resolve within the class; calls through arbitrary
objects do not resolve and are dropped.  The modules are parsed, never
imported.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["FunctionInfo", "ModuleInfo", "CallGraph", "build_graph",
           "dotted_parts", "HOT_ROOTS", "CUDA_LAUNCH", "VMAP"]

# The port counterparts of the reference's trace roots (every one whose
# module path and qualname exist in repro_torch; tests hold this list
# against repro.analysis), then the port functions that run inline what
# the reference traces as a nested body, step or lambda (the reason after
# each names it).
HOT_ROOTS: Tuple[str, ...] = (
    "repro_torch.core.baselines.ed_cdist",
    "repro_torch.core.baselines.sbd_cdist",
    "repro_torch.core.corridor.build_corridor",
    "repro_torch.core.corridor.certify_adaptive",
    "repro_torch.core.dba.dba",
    "repro_torch.core.dba.dba_update",
    "repro_torch.core.dtw.dtw_batch",
    "repro_torch.core.dtw.dtw_cdist",
    "repro_torch.core.kmeans._dba_assigned_update",
    "repro_torch.core.lb.keogh_envelope",
    "repro_torch.core.lb_search.filtered_topk",
    "repro_torch.core.modwt.fixed_segments",
    "repro_torch.core.modwt.modwt_scale",
    "repro_torch.core.modwt.prealign",
    "repro_torch.core.pq._encode_segs",
    "repro_torch.core.pq.cdist_sym_refined",
    "repro_torch.core.pq.query_lut",
    "repro_torch.core.pq.query_lut_batch",
    "repro_torch.index.streaming._merge_topk",
    "repro_torch.index.streaming._scan_hot",
    "repro_torch.kernels.dtw_band.ops.dtw_band",
    "repro_torch.kernels.dtw_band.ops.dtw_band_cdist",
    "repro_torch.kernels.lb_cascade.ops.lb_refine",
    "repro_torch.kernels.pq_adc.ops.adc_lookup",
    "repro_torch.kernels.pq_adc.ops.adc_lookup_quant",
    "repro_torch.kernels.pq_adc.ops.adc_sym_cdist",
    "repro_torch.kernels.pq_adc.ops.adc_sym_cdist_quant",
    "repro_torch.kernels.pq_adc.ops.quantize_lut",
    "repro_torch.kernels.pq_adc.ref.adc_lookup_quant_ref",
    "repro_torch.kernels.pq_adc.ref.adc_lookup_ref",
    "repro_torch.kernels.pq_adc.ref.adc_sym_cdist_quant_ref",
    "repro_torch.kernels.pq_adc.ref.adc_sym_cdist_ref",
    "repro_torch.kernels.pq_attn.ops.pq_attn_decode",
    "repro_torch.kernels.prealign_encode.ops.prealign_encode",
    "repro_torch.kernels.prealign_encode.ref.prealign_encode_ref",
    "repro_torch.models.encdec.encode_frames.body",
    "repro_torch.models.encdec.forward_encdec.body",
    "repro_torch.serve.pqkv.encode_kv",
    # the reference traces alignment_path.step under lax.scan
    "repro_torch.core.dba.alignment_path",
    # ... _diag_sweep.step under lax.scan
    "repro_torch.core.dtw._diag_sweep",
    # ... a jitted lambda over search_batch's ranking
    "repro_torch.core.ivf.search_batch",
    # ... euclidean_kmeans.step under lax.while_loop
    "repro_torch.core.kmeans.euclidean_kmeans",
    # ... a jitted lambda of nn_dtw_pruned_host over filtered_topk
    "repro_torch.core.knn.nn_dtw_pruned",
    # ... vmapped lambdas / snap_one of these three
    "repro_torch.core.modwt.extract_segments",
    "repro_torch.core.modwt.segment_points",
    "repro_torch.core.modwt.snap_splits",
    # ... _adc_gather and a jitted lambda of cdist_asym
    "repro_torch.core.pq.adc_gather",
    "repro_torch.core.pq.cdist_asym",
    # ... the per_device bodies under shard_map
    "repro_torch.index.planner._search_list_sharded",
    "repro_torch.index.planner._search_query_sharded",
    # ... _rank_segment, whose sealed-block ranking this is
    "repro_torch.index.streaming._rank_blocks",
    # ... lb_refine_jax and _select, the jnp route of the cascade
    "repro_torch.kernels.lb_cascade.ref.lb_refine_ref",
    # ... a jitted lambda in attention
    "repro_torch.models.layers.attention",
    # ... forward.group_body.inner under lax.scan
    "repro_torch.models.lm.forward",
    # ... ssd_forward.step under lax.scan
    "repro_torch.models.ssm.ssd_forward",
    # ... the decoder, ssm and hybrid step bodies and the jitted serve_step
    "repro_torch.serve.decode.serve_step",
    # ... _serve_encdec.body and prefill_cache_encdec.per_layer
    "repro_torch.serve.decode._serve_encdec",
    "repro_torch.serve.decode.prefill_cache_encdec",
    # ... prefill.body under lax.scan
    "repro_torch.serve.prefill.prefill",
    # ... pq_attention_decode.body and the jitted pq_serve_step
    "repro_torch.serve.pqkv.pq_attention_decode",
    "repro_torch.serve.pqkv.pq_serve_step",
    # ... the jitted train_step (its acc body)
    "repro_torch.train.step.make_train_step.train_step",
    # ... make_train_step.loss_fn and its chunk_sums, here in
    # make_loss_and_grads
    "repro_torch.train.step.make_loss_and_grads.loss_fn",
    "repro_torch.train.step.make_loss_and_grads.chunk_sums",
)

# the kernel library: every CUDA launch of the port goes through a call
# of this function (``_build.lib().pq_<entry>(...)``)
CUDA_LAUNCH = frozenset({"repro_torch.kernels._build.lib"})
_LAUNCH_MODULE = "repro_torch.kernels._build"

VMAP = frozenset({"torch.vmap", "torch.func.vmap", "functorch.vmap"})


@dataclasses.dataclass
class FunctionInfo:
    """One function-like scope: def, method, nested def, or lambda."""

    qualname: str                      # repro_torch.core.pq.encode / ...
    module: "ModuleInfo"
    node: ast.AST                      # FunctionDef | AsyncFunctionDef | Lambda
    lineno: int
    class_qual: Optional[str] = None   # enclosing class qualname, if a method
    parent: Optional[str] = None       # enclosing function qualname
    is_hot_root: bool = False
    calls: Set[str] = dataclasses.field(default_factory=set)
    refs: Set[str] = dataclasses.field(default_factory=set)

    @property
    def params(self) -> Set[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return set(names)


@dataclasses.dataclass
class ModuleInfo:
    qualname: str                      # repro_torch.index.streaming
    path: Path
    tree: ast.Module
    source: str
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class VmapSite:
    """One ``torch.vmap(fn)`` call: who vmapped what, and where."""

    caller: str                        # enclosing scope qualname
    target: Optional[str]              # resolved fn qualname (None: unknown)
    module: ModuleInfo
    lineno: int


class CallGraph:
    """The module/function index plus derived reachability sets."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.vmap_sites: List[VmapSite] = []
        # (function qual, local name) -> lambda qualname for
        # ``fn = lambda ...`` aliases
        self._local_alias: Dict[Tuple[str, str], str] = {}

    # -- reachability --------------------------------------------------------

    def edges(self, qual: str) -> Set[str]:
        fn = self.functions.get(qual)
        if fn is None:
            return set()
        return {c for c in fn.calls | fn.refs if c in self.functions}

    def reachable_from(self, roots) -> Set[str]:
        seen, todo = set(), [r for r in roots if r in self.functions]
        while todo:
            q = todo.pop()
            if q in seen:
                continue
            seen.add(q)
            todo.extend(self.edges(q) - seen)
        return seen

    def hot_roots(self) -> Set[str]:
        return {q for q, f in self.functions.items() if f.is_hot_root}

    def hot_reachable(self) -> Set[str]:
        return self.reachable_from(self.hot_roots())

    def cuda_launchers(self) -> Set[str]:
        return {q for q, f in self.functions.items()
                if f.calls & CUDA_LAUNCH
                and f.module.qualname != _LAUNCH_MODULE}

    def reaches_cuda(self) -> Set[str]:
        """Every function from which a kernel launch is reachable."""
        out = set(self.cuda_launchers())
        # iterate to fixpoint over the (small) function set
        changed = True
        while changed:
            changed = False
            for q in self.functions:
                if q in out:
                    continue
                if self.edges(q) & out:
                    out.add(q)
                    changed = True
        return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def dotted_parts(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None for anything richer."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _module_qualname(path: Path, src_root: Path) -> str:
    rel = path.relative_to(src_root).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _resolve_imports(mod_qual: str, tree: ast.Module,
                     is_package: bool) -> Dict[str, str]:
    pkg_parts = mod_qual.split(".") if is_package else mod_qual.split(".")[:-1]
    imports: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imports[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[:len(pkg_parts) - node.level + 1]
                prefix = ".".join(base + ([node.module] if node.module
                                          else []))
            else:
                prefix = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                target = f"{prefix}.{a.name}" if prefix else a.name
                imports[a.asname or a.name] = target
    return imports


class _Indexer(ast.NodeVisitor):
    """Pass 1: register every function-like scope."""

    def __init__(self, graph: CallGraph, module: ModuleInfo):
        self.g = graph
        self.m = module
        self.scope: List[str] = [module.qualname]
        self.class_stack: List[str] = []
        self.fn_stack: List[str] = []

    def _register(self, node, name: str) -> FunctionInfo:
        qual = f"{self.scope[-1]}.{name}"
        info = FunctionInfo(
            qualname=qual, module=self.m, node=node, lineno=node.lineno,
            class_qual=self.class_stack[-1] if self.class_stack else None,
            parent=self.fn_stack[-1] if self.fn_stack else None)
        self.g.functions[qual] = info
        if self.fn_stack:
            # containment edge: a nested scope is treated as reachable
            # from its parent (overapproximation, see module docstring)
            self.g.functions[self.fn_stack[-1]].refs.add(qual)
        return info

    def visit_ClassDef(self, node: ast.ClassDef):
        qual = f"{self.scope[-1]}.{node.name}"
        self.scope.append(qual)
        self.class_stack.append(qual)
        self.generic_visit(node)
        self.class_stack.pop()
        self.scope.pop()

    def _visit_function(self, node):
        info = self._register(node, node.name)
        self.scope.append(info.qualname)
        self.fn_stack.append(info.qualname)
        self.generic_visit(node)
        self.fn_stack.pop()
        self.scope.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_Lambda(self, node: ast.Lambda):
        info = self._register(node, f"<lambda@{node.lineno}>")
        self.scope.append(info.qualname)
        self.fn_stack.append(info.qualname)
        self.generic_visit(node)
        self.fn_stack.pop()
        self.scope.pop()

    def visit_Assign(self, node: ast.Assign):
        # ``fn = lambda ...``: remember the local alias so
        # ``torch.vmap(fn)`` can resolve through it
        if (self.fn_stack and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            name = node.targets[0].id
            if isinstance(node.value, ast.Lambda):
                lam = f"{self.scope[-1]}.<lambda@{node.value.lineno}>"
                self.g._local_alias[(self.fn_stack[-1], name)] = lam
        self.generic_visit(node)


def _resolve_external(parts: List[str], imports: Dict[str, str]
                      ) -> Optional[str]:
    if parts and parts[0] in imports:
        return ".".join([imports[parts[0]]] + parts[1:])
    return None


class _Resolver(ast.NodeVisitor):
    """Pass 2: resolve calls/references inside one function scope."""

    def __init__(self, graph: CallGraph, info: FunctionInfo):
        self.g = graph
        self.info = info

    def resolve(self, node: ast.AST) -> Optional[str]:
        parts = dotted_parts(node)
        if parts is None:
            if isinstance(node, ast.Lambda):
                return f"{self.info.qualname}.<lambda@{node.lineno}>"
            return None
        m = self.info.module
        head = parts[0]
        if head == "self" and self.info.class_qual and len(parts) > 1:
            return f"{self.info.class_qual}.{parts[1]}"
        # local lambda aliases, innermost scope first
        scope: Optional[str] = self.info.qualname
        while scope is not None:
            alias = self.g._local_alias.get((scope, head))
            if alias is not None:
                return alias
            cand = f"{scope}.{head}"
            if cand in self.g.functions:
                return ".".join([cand] + parts[1:]) if len(parts) > 1 \
                    else cand
            scope = self.g.functions[scope].parent \
                if scope in self.g.functions else None
        mod_cand = f"{m.qualname}.{head}"
        if mod_cand in self.g.functions:
            return ".".join([mod_cand] + parts[1:]) if len(parts) > 1 \
                else mod_cand
        if len(parts) > 1 and mod_cand in {f.class_qual for f in
                                           self.g.functions.values()
                                           if f.class_qual}:
            return f"{mod_cand}.{parts[1]}"
        ext = _resolve_external(parts, m.imports)
        if ext is not None:
            return ext
        return ".".join(parts)

    def _body_nodes(self):
        """Walk the scope's own statements, not nested function bodies."""
        todo = list(ast.iter_child_nodes(self.info.node))
        while todo:
            n = todo.pop()
            yield n
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            todo.extend(ast.iter_child_nodes(n))

    def run(self) -> None:
        for n in self._body_nodes():
            if isinstance(n, ast.Call):
                self._handle_call(n)

    def _handle_call(self, node: ast.Call) -> None:
        qual = self.resolve(node.func)
        if qual is not None:
            self.info.calls.add(qual)
        # function references handed as arguments (vmap, callbacks, ...)
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            r = self.resolve(arg)
            if r is not None and r in self.g.functions:
                self.info.refs.add(r)
        if qual in VMAP and node.args:
            target = self.resolve(node.args[0])
            self.g.vmap_sites.append(VmapSite(
                caller=self.info.qualname,
                target=target if target in self.g.functions else None,
                module=self.info.module, lineno=node.lineno))


def build_graph(py_files, src_root: Path) -> CallGraph:
    """Index ``py_files`` (under ``src_root``, e.g. ``<repo>/src``) into a
    :class:`CallGraph` with calls resolved and :data:`HOT_ROOTS` (those
    that exist) marked hot."""
    g = CallGraph()
    for path in py_files:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
        qual = _module_qualname(path, src_root)
        mod = ModuleInfo(qualname=qual, path=path, tree=tree, source=source)
        mod.imports = _resolve_imports(qual, tree,
                                       path.name == "__init__.py")
        g.modules[qual] = mod
        _Indexer(g, mod).visit(tree)
    for info in list(g.functions.values()):
        _Resolver(g, info).run()
    for q in HOT_ROOTS:
        if q in g.functions:
            g.functions[q].is_hot_root = True
    return g
