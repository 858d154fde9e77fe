"""Cell builder (counterpart of :mod:`repro.launch.cells`): one (arch x
shape) -> the step and its abstract arguments.

A *cell* is the unit of the dry run: the step (train, prefill or decode)
and its arguments as meta tensors (:mod:`.specs`: nothing allocated).
One card has no mesh and no shardings, so the reference's in/out
shardings, ``dp_size`` and ``lower_cell`` have no counterpart; the
grad-accumulation count of a train cell is ``global_batch /
microbatch_rows`` (the reference's with dp = 1).  :mod:`.cost` counts a
cell's step on its meta arguments; :mod:`.dryrun` also runs it on the
card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.registry import ShapeSpec, get_config
from ..models.config import ModelConfig
from ..train.optim import AdamWConfig
from ..train.step import bf16_cast, make_forward, make_train_step
from .specs import (abstract_cache, abstract_params, abstract_pq_cache,
                    abstract_train_state, input_specs)

__all__ = ["CellPlan", "build_cell"]


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


def build_cell(arch: str, shape: ShapeSpec, *, q_chunk: int = 512,
               remat: bool = True, microbatch_rows: int = 1,
               extra: Optional[Dict[str, Any]] = None,
               cfg: Optional[ModelConfig] = None) -> CellPlan:
    """The step and abstract arguments of one cell.

    ``microbatch_rows``: batch rows a microbatch of a train cell
    (grad-accumulation count ``global_batch / microbatch_rows``).
    ``extra``: overrides (``q_chunk``, ``remat``, ``microbatch_rows``,
    ``loss_chunk``, ``global_batch`` (a cut of the shape's batch), and
    ``pqkv``: a ``PQKVConfig`` makes a decode cell serve from the
    PQ-compressed cache).  ``cfg`` replaces the arch's
    full config (a reduced one, in tests).
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
                  remat=remat, loss_chunk=loss_chunk)

    if shape.kind == "train":
        micro = max(1, shape.global_batch // microbatch_rows)
        step = make_train_step(cfg, AdamWConfig(), q_chunk=q_chunk,
                               microbatches=micro, remat=remat,
                               loss_chunk=loss_chunk)
        return CellPlan(fn=step, microbatches=micro,
                        abstract_args=(abstract_train_state(cfg), batch_abs),
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

        return CellPlan(fn=prefill_step,
                        abstract_args=(params_abs, batch_abs), **common)

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

    return CellPlan(fn=decode_step, pqkv=pqkv,
                    abstract_args=(params_abs, cache_abs,
                                   batch_abs["token"], pos), **common)
