"""Partitioning rules: parameters / optimizer state / caches / batches ->
specs (counterpart of :mod:`repro.sharding.partition`).

Scheme (single-pod mesh ``(data, model)``, multi-pod ``(pod, data,
model)``):

  * TP over ``model``: attention heads and ffn columns (column-parallel),
    output rows (row-parallel), vocab, experts (EP), SSM heads.
  * FSDP over ``data`` (+ ``pod``): the non-TP dimension of every large
    matrix is sharded too, so parameter and optimizer memory scales with
    the whole device count (ZeRO-3: :func:`gather_fsdp` gathers a block's
    weights over those axes where the block uses them, never the batch).
  * DP over ``data`` (+ ``pod``): the batch dimension of activations; the
    sequence axis of KV caches is TP-sharded (decode attention becomes a
    ``model``-axis reduction: :mod:`repro_torch.serve.pqkv`).

Rules are *name -> trailing-dims spec*; leading (stack) axes are padded
with ``None``.  Any dim its axis does not divide falls back to
replication for that dim (batch 1 long-context decode, for one).

A spec is a plain tuple with one entry per dim: ``None``, a mesh axis
name, or a tuple of names; it equals the reference's ``PartitionSpec``
entry for entry (``()`` is the reference's ``P()``: replicated).
:func:`placements` turns it into ``torch.distributed.tensor``
placements, one per mesh dim, and :func:`distribute` lays a whole tree
out as ``DTensor`` s.  The rules read only a mesh's axis names and sizes,
so they take a :class:`~repro_torch.launch.mesh.MeshDesc` or a
``DeviceMesh``.

Leaves are named by the last field name or dict key of their path
(list and tuple indices skipped), as the reference's ``_last_name``.

>>> from repro_torch.launch.mesh import make_production_mesh
>>> mesh = make_production_mesh()
>>> param_specs({"wq": torch.empty(2048, 2048, device="meta"),
...              "bq": torch.empty(100, device="meta")}, mesh)
{'bq': (None,), 'wq': ('data', 'model')}
>>> placements(("data", "model"), mesh)
[Shard(dim=0), Shard(dim=1)]
>>> placements((("pod", "data"), None), make_production_mesh(multi_pod=True))
[Shard(dim=0), Shard(dim=0), Replicate()]
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

from .._tree import tree_map, tree_map_with_path
from ..launch.mesh import mesh_sizes

__all__ = ["param_specs", "cache_specs", "batch_specs", "placements",
           "distribute", "fsdp_axes", "dp_axes", "dp_size",
           "activation_sharding", "constrain_batch", "constrain_dims",
           "current_act_axes", "current_model_size", "gather_fsdp",
           "is_dtensor", "full", "local_shape", "local_bytes",
           "in_planned_redistribute", "planned_redistribute", "forced_label",
           "forced_gather",
           "redistribute_tree", "model_axis",
           "replicate_model", "batch_like", "model_all_reduce",
           "gather_vocab", "pick_last", "shard_threads"]

# ---------------------------------------------------------------------------
# Activation-sharding context.
#
# DTensor's strategy choice alone does not keep activations batch-sharded
# through the layers: at the token gather, the embedding's FSDP axis (d
# over 'data') meets the batch over 'data', and a product may replicate
# the batch, multiplying per-device compute by the DP degree (the dry
# run's per-device count shows it).  Model code therefore calls
# ``constrain_batch(x)`` on (B, ...) activations; on a plain tensor or
# outside the context it is the identity, so tests and one-card runs are
# unaffected.
# ---------------------------------------------------------------------------

class _Context:
    """The activation context, process-wide: autograd runs the backward
    pass of a non-CPU tensor (and a remat body's recomputation in it) on
    a thread of its own, where a ``contextvars`` value set by the caller
    would not be seen (the reference sets it while tracing, on one
    thread)."""
    act_axes: Optional[Tuple[str, ...]] = None
    model_size: int = 1
    planned: int = 0
    forced: Optional[str] = None     # what the port gathers, and why


_CTX = _Context()


@contextlib.contextmanager
def activation_sharding(axes: Optional[Tuple[str, ...]],
                        model_size: int = 1):
    """Enable the batch-dim activation constraints inside the block.

    ``model_size`` exposes the TP degree to model code that needs it."""
    saved = _CTX.act_axes, _CTX.model_size
    _CTX.act_axes = tuple(axes) if axes else None
    _CTX.model_size = model_size
    try:
        yield
    finally:
        _CTX.act_axes, _CTX.model_size = saved


def forced_label() -> Optional[str]:
    """The name of the gather the port is inserting right now
    (:func:`replicate_model` with ``planned=False``), else ``None``."""
    return _CTX.forced


def in_planned_redistribute() -> bool:
    """True inside a redistribution the partition asks for
    (:func:`constrain_batch`, :func:`constrain_dims`, :func:`gather_fsdp`);
    a gather outside one is DTensor's own choice (the cost pass lists
    those as forced)."""
    return _CTX.planned > 0


@contextlib.contextmanager
def planned_redistribute():
    """Collectives issued inside the block are ones the layout calls for
    (not listed as forced by the cost pass)."""
    _CTX.planned += 1
    try:
        yield
    finally:
        _CTX.planned -= 1


def _counted(fn, *args):
    """``fn(*args)`` inside a planned redistribution."""
    with planned_redistribute():
        return fn(*args)


class _Constrain(torch.autograd.Function):
    """A layout constraint on a value and on its gradient, as JAX's
    ``with_sharding_constraint`` is (its transpose constrains the
    cotangent the same way).  Without it ``DTensor`` hands gradients back
    as partial sums over ``model`` where the forward pass reduced them,
    and the backward products then gather activations instead."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        if list(x.placements) == list(want):
            return x.view_as(x)
        return _counted(x.redistribute, mesh, want)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != list(ctx.want):
            g = _counted(g.redistribute, ctx.mesh, ctx.want)
        return g, None, None


def _planned(x, mesh, want):
    """``x`` laid out as ``want`` inside a planned redistribution; its
    backward takes the gradient back to ``x``'s layout (a gather's
    gradient is reduce-scattered)."""
    return _counted(x.redistribute, mesh, want)


def current_act_axes() -> Optional[Tuple[str, ...]]:
    return _CTX.act_axes


def current_model_size() -> int:
    return _CTX.model_size


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _redistribute(x, entries):
    """``x`` (a DTensor) laid out as the per-dim ``entries``; a dim its
    axes do not divide stays replicated."""
    mesh = x.device_mesh
    sizes = mesh_sizes(mesh)
    out = []
    for dim, e in zip(x.shape, entries):
        if e is not None and dim % _axis_size(sizes, e):
            e = None
        out.append(e)
    return _Constrain.apply(x, mesh, placements(tuple(out), mesh))


def constrain_batch(x):
    """Pin dim 0 of an activation to the DP axes and replicate the rest
    (the identity on a plain tensor, outside the context, or when the
    batch does not divide the DP degree)."""
    axes = _CTX.act_axes
    if axes is None or not is_dtensor(x) or x.ndim < 1:
        return x
    return _redistribute(x, (axes,) + (None,) * (x.ndim - 1))


def constrain_dims(x, dims):
    """Pin named dims of an activation: ``dims`` maps axis index -> "dp"
    (the DP axes) or a mesh axis name; every other dim is replicated.
    The identity on a plain tensor or outside the context."""
    axes = _CTX.act_axes
    if axes is None or not is_dtensor(x):
        return x
    entries = [None] * x.ndim
    for i, a in dims.items():
        entries[i] = axes if a == "dp" else a
    return _redistribute(x, tuple(entries))


def gather_fsdp(tree):
    """A block's parameters gathered over the FSDP axes where the block
    uses them (ZeRO-3): each DTensor leaf keeps its ``model`` placement
    and is replicated over ``data`` (and ``pod``).  Its backward
    reduce-scatters the gradient back.  The identity on plain tensors and
    outside the activation context."""
    if _CTX.act_axes is None:
        return tree

    def one(x):
        if not is_dtensor(x):
            return x
        from torch.distributed.tensor import Replicate
        names = x.device_mesh.mesh_dim_names
        want = [Replicate() if n != "model" else p
                for n, p in zip(names, x.placements)]
        if want == list(x.placements):
            return x
        return _planned(x, x.device_mesh, want)
    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# Helpers for code that runs on local shards (``local_map``).
# ---------------------------------------------------------------------------

def model_axis(mesh) -> Tuple[int, int, Optional[int]]:
    """``(size, this rank's coordinate, mesh dim)`` of the ``model`` axis
    of a ``DeviceMesh``; ``(1, 0, None)`` where it has none."""
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        return 1, 0, None
    dim = names.index("model")
    return mesh.size(dim), mesh.get_coordinate()[dim], dim


@contextlib.contextmanager
def forced_gather(label: str):
    """Collectives issued inside the block are the port's own gathers
    (listed as forced under ``label`` by the cost pass)."""
    saved, _CTX.forced = _CTX.forced, label
    try:
        yield
    finally:
        _CTX.forced = saved


def replicate_model(x, planned: bool = True, label: str = "replicate"):
    """A DTensor with its ``model`` mesh dim replicated (the others as
    they are).  ``planned=False`` marks a gather the port has to insert
    where the reference's layout would not need it (the cost pass lists
    those as forced, under ``label``)."""
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    want = [Replicate() if n == "model" else p
            for n, p in zip(names, x.placements)]
    if want == list(x.placements):
        return x
    if planned:
        return _planned(x, x.device_mesh, want)
    with forced_gather(label):
        return x.redistribute(x.device_mesh, want)


def gather_vocab(logits):
    """Logits whose vocabulary lies on ``model`` gathered whole over it
    for the loss (the identity on a plain tensor).  The port inserts it:
    the reference's compiler reduces the sharded vocabulary in place, so
    the cost pass lists it as forced."""
    if not is_dtensor(logits):
        return logits
    return replicate_model(logits, planned=False, label="gather_vocab")


def pick_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last axis (``torch.gather`` of ``idx[...,
    None]``).  On a mesh each rank gathers its own rows (``x`` whole on
    its last axis, both laid out alike on the batch): ``DTensor`` 's own
    gather would build its gradient replicated over the batch."""
    def take(a, i):
        return torch.gather(a, -1, i[..., None])[..., 0]
    if not is_dtensor(x):
        return take(x, idx)
    from torch.distributed.tensor.experimental import local_map
    idx = batch_like(idx, x)
    return local_map(take, out_placements=list(idx.placements),
                     device_mesh=x.device_mesh)(x, idx)


def batch_like(t: Optional[torch.Tensor], ref):
    """A plain tensor whose dim 0 is the global batch (RoPE tables, key
    masks), laid out as the DTensor ``ref``'s batch: ``Shard(0)`` on the
    mesh dims where ``ref`` has it, replicated on the others (each rank
    keeps its rows; nothing is sent).  ``None`` stays ``None``."""
    if t is None:
        return None
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = ref.device_mesh
    want = [Shard(0) if p == Shard(0) else Replicate()
            for p in ref.placements]
    if is_dtensor(t):
        return t if list(t.placements) == want else _planned(t, mesh, want)
    return distribute({"t": t}, {"t": tuple(
        _dp_entry(mesh, want) if d == 0 else None
        for d in range(t.ndim))}, mesh)["t"]


def _dp_entry(mesh, want):
    names = tuple(n for n, p in zip(mesh.mesh_dim_names, want)
                  if p.is_shard())
    return names if len(names) > 1 else (names[0] if names else None)


def model_all_reduce(t: torch.Tensor, op: str, mesh) -> torch.Tensor:
    """``t`` (a local tensor) reduced over the ``model`` axis of ``mesh``
    (``"sum"`` or ``"max"``); ``t`` itself where the axis has one
    rank."""
    size, _, dim = model_axis(mesh)
    if size == 1:
        return t
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, dim)))


def shard_threads(fn, n: int) -> list:
    """Run ``fn(rank, reduce)`` for ranks ``0 .. n - 1`` in ``n`` threads
    of this process and return their results in rank order.  ``reduce(t,
    op)`` combines ``t`` over the ranks as :func:`model_all_reduce` does
    across processes (``"max"``, or ``"sum"`` in rank order), so one
    device runs the code of a sequence split over ``n`` ranks: the decode
    cores' ``s0`` / ``reduce``.  Every thread calls ``reduce`` in the same
    order.  The threads share the device's stream, so a reduction reads
    what the other ranks enqueued before it."""
    import threading
    gate = threading.Barrier(n)
    slots, results, errors = [None] * n, [None] * n, []

    def reducer(rank):
        def reduce(t, op):
            slots[rank] = t
            gate.wait()
            out = slots[0]
            for other in slots[1:]:
                out = torch.maximum(out, other) if op == "max" else out + other
            gate.wait()                 # every rank has read the slots
            return out
        return reduce

    def run(rank):
        try:
            results[rank] = fn(rank, reducer(rank))
        except BaseException as e:      # the others stop at the gate
            errors.append(e)
            gate.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


_F = "__fsdp__"   # placeholder resolved to 'data' or ('pod', 'data')
_D = "__dp__"

# name -> spec for the TRAILING dims of the leaf
_PARAM_RULES = {
    # embeddings / heads
    "embed": ("model", _F),
    "lm_head": ("model", _F),
    "patch_proj": (_F, "model"),
    "frame_proj": (_F, "model"),
    # attention
    "wq": (_F, "model"), "wk": (_F, "model"), "wv": (_F, "model"),
    "wo": ("model", _F),
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # dense mlp
    "w_gate": (_F, "model"), "w_up": (_F, "model"), "w_down": ("model", _F),
    # moe (experts on model = EP; dense dims FSDP)
    "router": (_F, None),
    "we_gate": ("model", _F, None), "we_up": ("model", _F, None),
    "we_down": ("model", None, _F),
    # mamba2
    "wz": (_F, "model"), "wx": (_F, "model"),
    "wB": (_F, None), "wC": (_F, None), "wdt": (_F, "model"),
    "conv_x": (None, "model"), "conv_B": (None, None), "conv_C": (None, None),
    "conv_bx": ("model",), "conv_bB": (None,), "conv_bC": (None,),
    "a_log": ("model",), "d_skip": ("model",), "dt_bias": ("model",),
    "norm": ("model",),          # SSM gated-norm scale over d_inner
    "out_proj": ("model", _F),
    # layer norms (d_model,): small, replicated
    "ln": (None,), "ln1": (None,), "ln2": (None,), "ln_x": (None,),
    "post_attn_ln": (None,), "post_mlp_ln": (None,),
    "final_norm": (None,), "enc_norm": (None,),
}

_CACHE_RULES = {
    # KV caches: trailing (B, S, G, hd): batch on DP, sequence on model
    "k": (_D, "model", None, None), "v": (_D, "model", None, None),
    # PQ-compressed cache (serve/pqkv.py): codes shard like the exact
    # cache, codebooks are small and replicated, exact rings shard on
    # batch only
    "k_codes": (_D, "model", None, None),
    "v_codes": (_D, "model", None, None),
    "k_books": (None, None, None, None),
    "v_books": (None, None, None, None),
    "k_recent": (_D, None, None, None),
    "v_recent": (_D, None, None, None),
    "self_k": (_D, "model", None, None), "self_v": (_D, "model", None, None),
    "cross_k": (_D, "model", None, None), "cross_v": (_D, "model", None, None),
    "attn_k": (_D, "model", None, None), "attn_v": (_D, "model", None, None),
    # SSM states: trailing (B, H, P, N) / conv (B, ck-1, C)
    "ssd": (_D, "model", None, None),
    "conv_x": (_D, None, "model"), "conv_B": (_D, None, None),
    "conv_C": (_D, None, None),
}

_BATCH_RULES = {
    "tokens": (_D, None), "labels": (_D, None), "token": (_D, None),
    "patches": (_D, None, None), "frames": (_D, None, None),
}


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def dp_axes(mesh) -> Tuple[str, ...]:
    return fsdp_axes(mesh)


def dp_size(mesh) -> int:
    """The DP degree: the product of the DP axes' sizes."""
    sizes = mesh_sizes(mesh)
    n = 1
    for ax in dp_axes(mesh):
        n *= sizes[ax]
    return n


def _axis_size(sizes, entry) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in names:
        n *= sizes[a]
    return n


def _resolve(rule, mesh, shape, fsdp_enabled: bool = True) -> tuple:
    sizes = mesh_sizes(mesh)
    fsdp = fsdp_axes(mesh)
    fsdp = fsdp if len(fsdp) > 1 else fsdp[0]
    entries = []
    for e in rule:
        if e is _F and not fsdp_enabled:
            entries.append(None)         # TP-only (serving layout)
        elif e in (_F, _D):
            entries.append(fsdp)
        else:
            entries.append(e)
    # pad leading stack axes with None
    entries = [None] * (len(shape) - len(entries)) + entries
    # divisibility guard: replicate any dim the axis does not divide
    return tuple(None if e is not None and dim % _axis_size(sizes, e) else e
                 for dim, e in zip(shape, entries))


def _last_name(path) -> Optional[str]:
    for key in reversed(path):
        if isinstance(key, str):
            return key
    return None


def _specs(tree, mesh, rules, fsdp_enabled: bool = True):
    def leaf(path, x):
        rule = rules.get(_last_name(path))
        if rule is None or len(rule) > x.ndim:
            return ()
        return _resolve(rule, mesh, tuple(x.shape), fsdp_enabled)
    return tree_map_with_path(leaf, tree)


def param_specs(params, mesh, fsdp: bool = True):
    """Specs of model parameters (and, by structure, Adam moments).

    ``fsdp=False`` gives the TP-only serving layout: weights replicated
    across the DP axes, so decode steps never gather them again (training
    needs FSDP for the optimizer state's memory; serving keeps bf16
    weights resident)."""
    return _specs(params, mesh, _PARAM_RULES, fsdp)


def cache_specs(cache, mesh):
    return _specs(cache, mesh, _CACHE_RULES)


def batch_specs(batch, mesh):
    def leaf(path, x):
        rule = _BATCH_RULES.get(_last_name(path))
        if rule is None or x.ndim == 0:
            return ()
        return _resolve(rule, mesh, tuple(x.shape))
    return tree_map_with_path(leaf, batch)


def placements(spec, mesh) -> list:
    """A spec -> one ``Shard(d)`` / ``Replicate()`` per mesh dim, in the
    mesh's axis order.  A dim sharded over ``("pod", "data")`` is
    ``Shard(d)`` on both, the major axis first, as JAX splits it."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_sizes(mesh):
        where = [d for d, e in enumerate(spec) if e is not None
                 and name in (e if isinstance(e, tuple) else (e,))]
        out.append(Shard(where[0]) if where else Replicate())
    return out


def _local_chunk(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """This rank's block of ``t`` under placements ``pl`` (every rank
    holds the whole tensor, so nothing is sent): a compact copy, so that
    the whole tensor's storage is not kept alive by a view of it; ``t``
    itself where no dim is split."""
    coord = mesh.get_coordinate()
    out, split = t, False
    for mdim, p in enumerate(pl):
        n = mesh.size(mdim)
        if p.is_shard() and n > 1:
            step = out.shape[p.dim] // n
            out = out.narrow(p.dim, coord[mdim] * step, step)
            split = True
    return out.clone(memory_format=torch.contiguous_format) if split else out


def distribute(tree, specs, mesh):
    """``tree``'s tensors laid out on the ``DeviceMesh`` ``mesh`` by
    ``specs`` (the counterpart of ``named_shardings`` and a
    ``device_put``): each leaf a ``DTensor``.  Every rank holds the whole
    tensor (the same seed, the same checkpoint), so each keeps its own
    block and nothing is sent; on meta tensors nothing is allocated.
    ``requires_grad`` carries over."""
    from torch.distributed.tensor import DTensor

    def one(x, spec):
        if not isinstance(x, torch.Tensor) or is_dtensor(x):
            return x
        pl = placements(spec, mesh)
        local = _local_chunk(x.detach(), mesh, pl)
        out = DTensor.from_local(local, mesh, pl, run_check=False,
                                 shape=x.shape, stride=x.stride())
        return out.requires_grad_(x.requires_grad)
    return tree_map(one, tree, specs)


def redistribute_tree(tree, specs):
    """Each DTensor leaf of ``tree`` laid out again by ``specs`` (a
    planned redistribution: the reference's ``with_sharding_constraint``
    of a whole tree); plain leaves as they are."""
    def one(x, spec):
        if not is_dtensor(x):
            return x
        want = placements(spec, x.device_mesh)
        if want == list(x.placements):
            return x
        return _planned(x, x.device_mesh, want)
    return tree_map(one, tree, specs)


def full(tree):
    """Every DTensor leaf of ``tree`` gathered whole (a plain tensor);
    other leaves as they are."""
    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x,
                    tree)


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """A leaf's per-device shape under ``spec`` (no device needed)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        out[d] //= _axis_size(sizes, e)
    return tuple(out)


def local_bytes(tree, specs, mesh) -> int:
    """The per-device bytes of ``tree``'s leaves laid out by ``specs``."""
    n = []
    tree_map(lambda x, spec: n.append(
        math.prod(local_shape(tuple(x.shape), spec, mesh))
        * x.element_size()), tree, specs)
    return sum(n)
