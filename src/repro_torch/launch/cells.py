"""Cell builder (counterpart of :mod:`repro.launch.cells`): one (arch x
shape) -> the step and its abstract arguments.

A *cell* is the unit of the dry run: the step (train, prefill or decode)
and its arguments as meta tensors (:mod:`.specs`: nothing allocated).
Without a mesh it is one card's cell: the grad-accumulation count of a
train cell is ``global_batch / microbatch_rows``.  With a ``DeviceMesh``
the arguments are ``DTensor`` s laid out by the partition rules
(:mod:`repro_torch.sharding.partition`), as the reference's in-shardings:
a train cell's state FSDP + TP, a prefill cell's parameters too, a
decode cell's bf16 parameters TP only (``fsdp=False``), caches and
batches by their rules; the accumulation count is ``global_batch / (dp
* microbatch_rows)`` and each microbatch is laid out again over the DP
axes (``mb_constraint``).  The step runs inside :meth:`CellPlan.sharding`
(the reference's ``lower_cell`` context).  :mod:`.cost` counts a cell's
step on its meta arguments; :mod:`.dryrun` also runs it on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.registry import ShapeSpec, get_config
from ..models.config import ModelConfig
from ..sharding.partition import (activation_sharding, batch_specs,
                                  cache_specs, distribute, dp_axes, dp_size,
                                  param_specs)
from ..train.optim import AdamWConfig, OptState
from ..train.step import (TrainState, bf16_cast, make_forward,
                          make_train_step)
from .specs import (abstract_cache, abstract_params, abstract_pq_cache,
                    abstract_train_state, input_specs)

__all__ = ["CellPlan", "build_cell", "state_specs", "mesh_context"]


def state_specs(state, mesh):
    """Specs of a ``TrainState``: parameters and both moments by
    :func:`~repro_torch.sharding.partition.param_specs`, the counters
    replicated (the reference's ``_state_shardings``)."""
    p = param_specs(state.params, mesh)
    return TrainState(step=(), params=p,
                      opt=OptState(mu=p, nu=p, count=()))


@contextlib.contextmanager
def mesh_context(mesh):
    """The context a step runs in on ``mesh``: the activation constraints
    over its DP axes, and plain tensors (RoPE tables, masks, scalars) read
    as replicated; nothing without a mesh."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    with activation_sharding(dp_axes(mesh), sizes.get("model", 1)), \
            implicit_replication():
        yield


@dataclasses.dataclass
class CellPlan:
    """Everything needed to count or run one cell: ``fn(*abstract_args)``
    is the step.  A train cell also keeps what :mod:`.cost` needs to count
    one microbatch and multiply it by ``microbatches``."""
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    fn: Callable
    abstract_args: Tuple[Any, ...]
    microbatches: int = 1
    q_chunk: int = 512
    remat: bool = True
    loss_chunk: int = 0
    pqkv: Any = None
    mesh: Any = None
    mb_constraint: Any = None

    def sharding(self):
        """The context the step runs in (:func:`mesh_context`)."""
        return mesh_context(self.mesh)


def build_cell(arch: str, shape: ShapeSpec, mesh=None, *,
               q_chunk: int = 512, remat: bool = True,
               microbatch_rows: int = 1,
               extra: Optional[Dict[str, Any]] = None,
               cfg: Optional[ModelConfig] = None) -> CellPlan:
    """The step and abstract arguments of one cell.

    ``microbatch_rows``: batch rows a microbatch of a train cell
    (grad-accumulation count ``global_batch / microbatch_rows``).
    ``extra``: overrides (``q_chunk``, ``remat``, ``microbatch_rows``,
    ``loss_chunk``, ``global_batch`` (a cut of the shape's batch), and
    ``pqkv``: a ``PQKVConfig`` makes a decode cell serve from the
    PQ-compressed cache).  ``cfg`` replaces the arch's
    full config (a reduced one, in tests).  ``mesh``: a ``DeviceMesh``
    over ``("data", "model")`` or ``("pod", "data", "model")`` lays the
    arguments out on it (module docstring); ``None``, one card.
    """
    extra = dict(extra or {})
    q_chunk = extra.pop("q_chunk", q_chunk)
    remat = extra.pop("remat", remat)
    microbatch_rows = extra.pop("microbatch_rows", microbatch_rows)
    loss_chunk = extra.pop("loss_chunk", 0)
    pqkv = extra.pop("pqkv", None)
    if "global_batch" in extra:
        batch = int(extra.pop("global_batch"))
        shape = dataclasses.replace(shape, global_batch=batch)
    if extra:
        raise ValueError(f"unknown cell overrides: {sorted(extra)}")
    cfg = cfg or get_config(arch)
    batch_abs = input_specs(cfg, shape)
    common = dict(arch=arch, shape=shape, cfg=cfg, q_chunk=q_chunk,
                  remat=remat, loss_chunk=loss_chunk, mesh=mesh)

    def lay(tree, specs):
        return tree if mesh is None else distribute(tree, specs, mesh)

    def lay_batch(batch):
        return (batch if mesh is None else
                distribute(batch, batch_specs(batch, mesh), mesh))

    if shape.kind == "train":
        dp = 1 if mesh is None else dp_size(mesh)
        micro = max(1, shape.global_batch // (dp * microbatch_rows))
        mb_constraint = None
        if mesh is not None and micro > 1:
            mb_constraint = batch_specs(
                {k: v[: v.shape[0] // micro] for k, v in batch_abs.items()},
                mesh)
        step = make_train_step(cfg, AdamWConfig(), q_chunk=q_chunk,
                               microbatches=micro, remat=remat,
                               loss_chunk=loss_chunk,
                               mb_constraint=mb_constraint)
        state = abstract_train_state(cfg)
        if mesh is not None:
            state = lay(state, state_specs(state, mesh))
        return CellPlan(fn=step, microbatches=micro,
                        mb_constraint=mb_constraint,
                        abstract_args=(state, lay_batch(batch_abs)),
                        **common)

    params_abs = abstract_params(cfg)
    if shape.kind == "prefill":
        fwd = make_forward(cfg, q_chunk=q_chunk, remat=remat)

        def prefill_step(params, batch):
            """Last-position logits only: the LM head runs on ``(B, 1,
            d)``, the ``(B, S, V)`` logits never exist."""
            from ..models.lm import logits_from_hidden
            with torch.no_grad():
                h = fwd(params, batch=batch, return_hidden=True)
                return logits_from_hidden(params, cfg, h[:, -1:, :])

        if mesh is not None:
            params_abs = lay(params_abs, param_specs(params_abs, mesh))
        return CellPlan(fn=prefill_step,
                        abstract_args=(params_abs, lay_batch(batch_abs)),
                        **common)

    # decode: serve_step(params, cache, token, pos) at the cache's last
    # position; bf16 weights, by the train step's cast rule (the
    # reference's ``ndim >= 2`` on its stacked leaves); with a PQKVConfig
    # the PQ-compressed decode
    params_abs = bf16_cast(params_abs)
    pos = shape.seq_len - 1
    if pqkv is not None:
        from ..serve.pqkv import pq_serve_step
        cache_abs = abstract_pq_cache(cfg, shape, pqkv)

        def decode_step(params, cache, token, pos):
            with torch.no_grad():
                return pq_serve_step(params, cfg, cache, token, pos,
                                     pqc=pqkv)
    else:
        from ..serve.decode import serve_step
        cache_abs = abstract_cache(cfg, shape)

        def decode_step(params, cache, token, pos):
            with torch.no_grad():
                return serve_step(params, cfg, cache, token, pos)

    token = batch_abs["token"]
    if mesh is not None:
        params_abs = lay(params_abs, param_specs(params_abs, mesh,
                                                 fsdp=False))
        cache_abs = lay(cache_abs, cache_specs(cache_abs, mesh))
        token = lay_batch({"token": token})["token"]
    return CellPlan(fn=decode_step, pqkv=pqkv,
                    abstract_args=(params_abs, cache_abs, token, pos),
                    **common)
