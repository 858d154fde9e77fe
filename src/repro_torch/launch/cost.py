"""What one cell's step costs, counted on meta tensors (the port's
counterpart of :mod:`repro.launch.hlo_cost` and
:mod:`repro.launch.hlo_analysis`).

The reference parses the compiled HLO of a cell.  Here the step runs on
its meta arguments (:mod:`.cells`) under :class:`CostCounter`, a
``TorchDispatchMode`` that sees every aten op the eager step issues,
forward and backward:

* FLOPs come from ``torch.utils.flop_counter``'s formulas (matrix
  products, convolutions, attention), split by the first operand's type:
  ``bf16``, ``f32`` and ``other``.  Elementwise ops count no FLOPs, as
  ``hlo_cost``'s dots and convolutions alone do.
* Two byte counts.  ``hbm_bytes`` is the eager step's traffic: every
  op's operands plus outputs (each tensor at most its storage's bytes;
  views, ``empty`` and other metadata ops move nothing), the eager
  analogue of ``hlo_cost``'s per-op ``io``.  It is what the port's
  unfused step moves today, not a minimum: fusing ops removes some of
  it.  ``floor_bytes`` is the fused floor: the step's arguments read
  once (weights, optimizer state, caches, inputs), each region of an
  argument the step writes written once (the optimizer's update, a
  cache slot) and its new outputs written once.  No implementation of
  the step moves less; :func:`roofline` holds the step against it, as
  the reference's roofline holds the step against ``hbm_min``.
* A hand-written kernel's launch (an op of the ``repro_torch`` namespace,
  ``pq_attn``'s) counts as one op by its operands' and outputs' bytes, as
  ``hlo_cost`` charges a ``custom-call``; on meta tensors only its
  outputs' shapes are made, so the aten ops of its plain version never
  run.
* A simulated allocator keeps the live storages: it adds a storage when
  an op first returns it and subtracts it when the storage dies
  (``weakref.finalize``; autograd's saved tensors keep theirs alive).
  Its peak, arguments included, stands in for ``memory_analysis()``.

Loops are counted as ``hlo_cost`` counts a while body by its trip count:
a train cell runs one microbatch, scaled by the microbatch count, then
the optimizer step once (:func:`count_cell`).

:func:`roofline` keeps the reference's record (``hlo_analysis.py``) with
the H100's rates in place of the TPU's (:data:`H100`): float32 products
run outside the tensor cores (the port sets ``allow_tf32 = False``), so
the compute term sums each type's FLOPs at its own peak.

On a mesh (:func:`.cells.build_cell` with ``mesh``) the arguments are
``DTensor`` s on meta under a fake process group of the mesh's size, and
the step runs on rank 0's shards.  The counter lets ``DTensor`` unwrap
each op first (it returns ``NotImplemented`` for a ``DTensor`` op, as
``CommDebugMode`` does), so it counts the local ops: FLOPs, bytes and the
peak are per device.  The collectives ``DTensor`` issues are counted by
kind in ``collectives`` with the reference's ring conventions (all-reduce
twice its output, all-gather its output, reduce-scatter its input,
all-to-all its output).  An all-gather outside a redistribution that the
partition asks for (:func:`~repro_torch.sharding.partition.
in_planned_redistribute`) is ``DTensor`` 's own choice: it is listed in
``forced`` by the op that needed it, the gathered tensor and its bytes
per device (the counterpart of XLA's "involuntary full
rematerialization").  The roofline's collective term holds those bytes
against :data:`H100`'s NVLink rate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .._tree import leaves, unflatten

__all__ = ["HW", "H100", "CellCost", "CostCounter", "count_cell",
           "fake_group",
           "roofline", "model_flops_per_step", "RooflineReport",
           "tensor_bytes"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One card's rates: dense bf16 and float32 (no tensor cores)
    FLOP/s, HBM bytes/s, device memory, and ``link_bw``, the bytes a
    second one device sends to its peers (0: no collective term).

    The H100 SXM's NVLink 4 carries 900 GB/s a GPU in both directions
    together, 450 GB/s each way (NVIDIA H100 Tensor Core GPU datasheet);
    a ring collective sends its bytes one way, so ``link_bw`` is 450e9.
    The figure is the datasheet's, not measured here, and it holds inside
    one 8-GPU NVLink domain only: a mesh axis of 16 spans two, whose link
    is the network's, so the term is optimistic there."""
    name: str = "h100-sxm"
    peak_flops: float = 989e12
    peak_flops_f32: float = 67e12
    hbm_bw: float = 3.35e12
    link_bw: float = 450e9
    hbm_bytes: float = 80 * 2 ** 30


H100 = HW()

_FREE = frozenset((
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default, torch.ops.aten.sym_size.int,
    torch.ops.aten.sym_numel.default, torch.ops.aten.sym_stride.int,
    torch.ops.aten.sym_storage_offset.default,
))


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor spans: its elements, at most its storage (an
    expanded view reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _local(t):
    """A DTensor's local shard, any other tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _tensors(x):
    return [_local(t) for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_reduce": "all-reduce", "all_reduce_coalesced":
                "all-reduce", "all_to_all_single": "all-to-all"}
_COMM_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                    "c10d_functional")


@dataclasses.dataclass
class CellCost:
    """A step's counts: FLOPs by operand type, the eager step's HBM bytes,
    aten ops and hand-written kernel launches (``kernels``, with
    ``kernel_bytes`` of their operands and outputs), the simulated
    allocator's argument bytes and peak, and the regions of the arguments
    the step writes (``written_bytes``) and its new outputs
    (``output_bytes``), which with the arguments make the fused floor."""
    flops_bf16: float = 0.0
    flops_f32: float = 0.0
    flops_other: float = 0.0
    hbm_bytes: float = 0.0
    written_bytes: int = 0
    output_bytes: int = 0
    ops: float = 0.0
    kernels: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bytes: float = 0.0
    argument_bytes: int = 0
    peak_bytes: int = 0
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)
    forced: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.collectives.values()))

    @property
    def flops(self) -> float:
        return self.flops_bf16 + self.flops_f32 + self.flops_other

    @property
    def floor_bytes(self) -> float:
        """The fused floor: arguments read once, written regions and
        outputs written once."""
        return self.argument_bytes + self.written_bytes + self.output_bytes

    def compute_s(self, hw: HW = H100) -> float:
        """Each type's FLOPs at its own peak (``other`` at bf16's)."""
        return ((self.flops_bf16 + self.flops_other) / hw.peak_flops
                + self.flops_f32 / hw.peak_flops_f32)

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["flops"] = self.flops
        out["floor_bytes"] = self.floor_bytes
        out["coll_bytes"] = self.coll_bytes
        return out


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched inside the block into :attr:`cost`
    (module docstring); ``scale`` multiplies what is counted (a loop
    body's trip count).  :meth:`hold` registers tensors that exist
    before the block (the step's arguments) with the allocator."""

    def __init__(self):
        super().__init__()
        self.cost = CellCost()
        self.scale = 1.0
        self._live: Dict[int, int] = {}
        self._bytes = 0
        self._args: set = set()          # the arguments' storages
        self._written: set = set()       # regions of them written
        self._dt_op = None               # the last DTensor op unwrapped
        try:
            from torch.distributed.tensor import DTensor
            self._dtensor = DTensor
        except ImportError:                                 # pragma: no cover
            self._dtensor = None

    # the simulated allocator ------------------------------------------
    def _add(self, t: torch.Tensor) -> bool:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return False
        n = st.nbytes()
        self._live[key] = n
        self._bytes += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._bytes)
        weakref.finalize(st, self._free, key)
        return True

    def _free(self, key: int) -> None:
        self._bytes -= self._live.pop(key, 0)

    def hold(self, tree) -> int:
        """Register the storages of ``tree``'s tensors as arguments;
        returns their bytes."""
        n = 0
        for t in _tensors(tree):
            if self._add(t):
                n += self._live[t.untyped_storage()._cdata]
            self._args.add(t.untyped_storage()._cdata)
        self.cost.argument_bytes += n
        return n

    def _note_writes(self, func, args, kwargs) -> None:
        """Add each region of an argument that ``func`` writes in place
        (once per region, however often it is written)."""
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            for t in _tensors(v):
                key = t.untyped_storage()._cdata
                region = (key, t.storage_offset(), tuple(t.shape),
                          tuple(t.stride()))
                if key in self._args and region not in self._written:
                    self._written.add(region)
                    self.cost.written_bytes += tensor_bytes(t)

    def note_outputs(self, out) -> None:
        """Count the step's returned tensors that are not arguments."""
        self.cost.output_bytes += sum(
            tensor_bytes(t) for t in _tensors(out)
            if t.untyped_storage()._cdata not in self._args)

    # counting ------------------------------------------------------------
    def _kernel(self, name, inputs, outputs) -> None:
        nbytes = sum(tensor_bytes(t) for t in (*inputs, *outputs))
        c = self.cost
        c.kernels[name] = c.kernels.get(name, 0.0) + self.scale
        c.kernel_bytes += self.scale * nbytes
        c.hbm_bytes += self.scale * nbytes
        c.ops += self.scale

    def _collective(self, func, ins, outs) -> None:
        """One collective's bytes by kind (module docstring); a gather
        the partition did not ask for goes in ``forced``."""
        from ..sharding.partition import (forced_label,
                                          in_planned_redistribute)
        kind = _COLLECTIVES.get(func.name().split("::")[1])
        if kind is None:
            return
        n_out = sum(tensor_bytes(t) for t in outs)
        moved = (2.0 * n_out if kind == "all-reduce" else
                 sum(tensor_bytes(t) for t in ins[:1])
                 if kind == "reduce-scatter" else float(n_out))
        c, s = self.cost, self.scale
        c.collectives[kind] = c.collectives.get(kind, 0.0) + s * moved
        if kind == "all-gather" and not in_planned_redistribute():
            op = forced_label() or (self._dt_op.name()
                                    if self._dt_op is not None else "?")
            t = outs[0]
            key = f"{op} {tuple(t.shape)} {str(t.dtype)[6:]}"
            rec = c.forced.setdefault(key, {"op": op, "count": 0.0,
                                            "bytes": 0.0})
            rec["count"] += s
            rec["bytes"] += s * n_out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if self._dtensor is not None and any(
                issubclass(t, self._dtensor) for t in types):
            self._dt_op = func       # DTensor unwraps it into local ops
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs the op on fake tensors
            # of the global shape: metadata, not work on this device
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out                   # a fake factory call, the same
        for t in outs:
            self._add(t)
        if func.namespace in _COMM_NAMESPACES:
            self._collective(func, _tensors((args, kwargs)), outs)
            return out
        if func.is_view or func in _FREE:
            return out
        if func._schema.is_mutable:
            self._note_writes(func, args, kwargs)
        ins = _tensors((args, kwargs))
        if func.namespace == "repro_torch":
            self._kernel(func.name().split("::")[1], ins, outs)
            return out
        c, s = self.cost, self.scale
        c.ops += s
        c.hbm_bytes += s * sum(tensor_bytes(t) for t in (*ins, *outs))
        packet = func.overloadpacket
        if packet in flop_registry and ins:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            dtype = ins[0].dtype
            if dtype == torch.bfloat16:
                c.flops_bf16 += s * f
            elif dtype == torch.float32:
                c.flops_f32 += s * f
            else:
                c.flops_other += s * f
        return out


@contextlib.contextmanager
def fake_group(desc):
    """A fake process group of ``desc.size`` ranks (this process rank 0:
    collectives return at once and move nothing) and the ``DeviceMesh``
    of the :class:`~repro_torch.launch.mesh.MeshDesc` ``desc`` over it,
    for counting a mesh's cell on meta tensors without its devices.  The
    group is destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from .mesh import device_mesh
    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=desc.size)
    try:
        yield device_mesh(desc, "cpu")
    finally:
        dist.destroy_process_group()


def count_cell(plan) -> CellCost:
    """Run ``plan``'s step (:func:`.cells.build_cell`) on its meta
    arguments under a :class:`CostCounter`.  A train cell runs one
    microbatch of ``global_batch / microbatches`` rows, its loss,
    gradients and accumulation counted ``microbatches`` times, then the
    division by the count and the optimizer step once."""
    counter = CostCounter()
    args = plan.abstract_args
    counter.hold(args)
    with plan.sharding(), counter:
        if plan.shape.kind != "train":
            counter.note_outputs(plan.fn(*args))
        else:
            _count_train(plan, counter)
    return counter.cost


def _count_train(plan, counter: CostCounter) -> None:
    from ..train.optim import AdamWConfig, adamw_step
    from ..train.step import make_loss_and_grads, zeros_f32
    state, batch = plan.abstract_args
    micro = plan.microbatches
    one = make_loss_and_grads(plan.cfg, plan.q_chunk, microbatches=1,
                              remat=plan.remat, loss_chunk=plan.loss_chunk)
    mb = {k: v[: v.shape[0] // micro] for k, v in batch.items()}
    if plan.mb_constraint is not None:
        from ..sharding.partition import redistribute_tree
        mb = redistribute_tree(mb, plan.mb_constraint)
    acc = ([zeros_f32(p) for p in leaves(state.params)]
           if micro > 1 else None)
    counter.scale = float(micro)
    _, _, grads = one(state.params, mb)
    if acc is not None:
        for a, g in zip(acc, leaves(grads)):
            a.add_(g)
    counter.scale = 1.0
    if acc is not None:
        grads = unflatten(state.params, [a / micro for a in acc])
    counter.note_outputs(adamw_step(AdamWConfig(), state.params, grads,
                                    state.opt))


def model_flops_per_step(param_count: int, active_param_count: int,
                         tokens: int, kind: str) -> float:
    """Useful model FLOPs: 6·N·D train, 2·N·D forward-only (N = active
    parameters), the reference's."""
    n = active_param_count
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


@dataclasses.dataclass
class RooflineReport:
    flops: float                 # HLO-equivalent FLOPs of the step
    hbm_bytes: float             # the fused floor (CellCost.floor_bytes)
    coll_bytes: float            # per device; 0 on one card
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str                   # dominant term
    model_flops: float           # useful flops (6ND / 2ND)
    useful_ratio: float          # model_flops / (flops * chips)
    roofline_frac: float         # useful compute time / dominant term
    flops_bf16: float = 0.0
    flops_f32: float = 0.0
    flops_other: float = 0.0
    hbm_eager_bytes: float = 0.0   # what the eager step moves today
    memory_eager_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline(cost: CellCost, coll_bytes: float = 0.0, chips: int = 1, *,
             model_flops: float, hw: HW = H100) -> RooflineReport:
    """The reference's three-term roofline (``hlo_analysis.roofline``)
    from a :class:`CellCost` of one device: the memory term is the fused
    floor's (``floor_bytes``), the eager step's traffic is kept beside it
    (``hbm_eager_bytes``, ``memory_eager_s``); ``coll_bytes`` (a mesh's
    per-device collective bytes) at ``hw.link_bw``."""
    compute_s = cost.compute_s(hw)
    memory_s = cost.floor_bytes / hw.hbm_bw
    coll_s = coll_bytes / hw.link_bw if hw.link_bw else 0.0
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bound = max(terms, key=terms.get)
    total = cost.flops * chips
    useful = model_flops / total if total else 0.0
    useful_compute_s = (model_flops / chips) / hw.peak_flops
    dominant = max(terms.values()) or 1.0
    return RooflineReport(
        flops=cost.flops, hbm_bytes=cost.floor_bytes, coll_bytes=coll_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bound=bound, model_flops=model_flops, useful_ratio=useful,
        roofline_frac=useful_compute_s / dominant,
        flops_bf16=cost.flops_bf16, flops_f32=cost.flops_f32,
        flops_other=cost.flops_other, hbm_eager_bytes=cost.hbm_bytes,
        memory_eager_s=cost.hbm_bytes / hw.hbm_bw)
