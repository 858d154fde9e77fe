"""Train state and train step (counterpart of :mod:`repro.train.step`):
mixed precision over float32 masters, gradient accumulation over
microbatches, an optional sequence-chunked loss.

The step follows the reference's arithmetic.  Each microbatch casts the
masters once to a bf16 copy (:func:`bf16_cast`, the reference's
``_bf16_cast`` rule applied to its stacked shapes: :func:`~repro_torch.
train.optim.matrix_like`), runs ``forward`` on that copy under autograd
(``remat``: the reference's ``jax.checkpoint`` bodies) and takes the
gradient to the masters through the cast: a bf16 cotangent, summed in
bf16 where a weight is used more than once (a tied embedding, the
hybrid's shared block, repeated tokens' rows), then widened to float32.
Microbatch gradients accumulate in float32 and are divided by their
count; the loss is the microbatches' mean, the other metrics the last
microbatch's.  ``adamw_step`` then updates the masters in place.

>>> import torch
>>> from repro_torch.configs.registry import get_reduced
>>> from repro_torch.data.tokens import TokenStream
>>> cfg = get_reduced("internlm2-1.8b")
>>> state = init_train_state(torch.Generator().manual_seed(0), cfg, "cpu")
>>> step = make_train_step(cfg, AdamWConfig(), q_chunk=16)
>>> batch = {k: torch.from_numpy(v) for k, v in
...          TokenStream(cfg.vocab_size, 16, 2).batch_at(0).items()}
>>> state, metrics = step(state, batch)
>>> int(state.step), sorted(metrics)
(1, ['ce', 'loss', 'ppl', 'tokens', 'z_loss'])
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .._device import DeviceArg, resolve_device
from .._tree import leaves, tree_map_with_path, unflatten
from ..models import encdec as encdec_mod
from ..models import lm as lm_mod
from ..models.config import ModelConfig
from ..models.layers import BF16
from ..sharding.partition import (constrain_batch, gather_vocab,
                                  is_dtensor, pick_last, redistribute_tree)
from .losses import next_token_loss
from .optim import (AdamWConfig, OptState, adamw_init, adamw_step,
                    matrix_like)

__all__ = ["TrainState", "model_init", "make_forward", "init_train_state",
           "bf16_cast", "make_loss_and_grads", "make_train_step"]


class TrainState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the parameters' device
    params: Any
    opt: OptState


def model_init(cfg: ModelConfig) -> Callable:
    """The family's ``init(cfg, generator, device, dtype)``."""
    if cfg.family == "encdec":
        return encdec_mod.init_params_encdec
    return lm_mod.init_params


def make_forward(cfg: ModelConfig, q_chunk: int = 512, remat: bool = True):
    """``fwd(params, batch=..., return_hidden=...)`` of the family."""
    if cfg.family == "encdec":
        return functools.partial(encdec_mod.forward_encdec, cfg=cfg,
                                 q_chunk=q_chunk, remat=remat)
    return functools.partial(lm_mod.forward, cfg=cfg, q_chunk=q_chunk,
                             remat=remat)


def init_train_state(generator: torch.Generator, cfg: ModelConfig,
                     device: DeviceArg = None) -> TrainState:
    """Float32 masters drawn from ``generator`` (on its device, then
    moved to ``device``: the card unless ``"cpu"``), zero moments, step
    0."""
    dev = resolve_device(device)
    params = model_init(cfg)(cfg, generator, dev, dtype=torch.float32)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt=adamw_init(params))


def bf16_cast(params):
    """The bf16 copy of the float32 masters that one microbatch runs on:
    every :func:`~repro_torch.train.optim.matrix_like` float32 leaf cast
    to bf16 (autograd reaches the master through the cast); ``final_norm``,
    ``enc_norm`` and ``shared_attn``'s 1-D leaves stay float32."""
    return tree_map_with_path(
        lambda path, p: (p.to(BF16) if p.dtype == torch.float32
                         and matrix_like(path, p) else p), params)


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """A float32 accumulator shaped like ``p`` (a DTensor's laid out as
    it is)."""
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def make_loss_and_grads(cfg: ModelConfig, q_chunk: int = 512,
                        microbatches: int = 1, remat: bool = True,
                        loss_chunk: int = 0, mb_constraint=None):
    """``fn(params, batch) -> (loss, metrics, grads)``: the reference's
    ``value_and_grad`` of its train step's loss, with float32 ``grads``
    shaped like ``params``.  ``batch = {"tokens" (B, S), "labels" (B, S),
    [extras]}``; ``microbatches`` splits it along axis 0, one
    microbatch's activations live at a time.  ``loss_chunk > 0``
    projects and reduces the logits ``loss_chunk`` positions at a time,
    each chunk recomputed in the backward pass, so the ``(B, S, V)``
    logits never exist at once (the reference's chunk rule: ``S /
    loss_chunk`` chunks if that divides and ``S > loss_chunk``, else
    one)."""
    fwd = make_forward(cfg, q_chunk=q_chunk, remat=remat)

    def chunk_sums(p, hb, lb):
        logits = gather_vocab(
            lm_mod.logits_from_hidden(p, cfg, hb).float())
        lse = constrain_batch(torch.logsumexp(logits, dim=-1))
        picked = constrain_batch(
            pick_last(logits, torch.clamp(lb, min=0).long()))
        mask = (lb != -100).float()
        return (torch.sum((lse - picked) * mask),
                torch.sum((lse ** 2) * mask), torch.sum(mask))

    def loss_fn(p, mb):
        if not loss_chunk:
            return next_token_loss(fwd(p, batch=mb), mb["labels"])
        h = fwd(p, batch=mb, return_hidden=True)
        S = h.shape[1]
        n = S // loss_chunk if S % loss_chunk == 0 and S > loss_chunk else 1
        ch = S // n
        nll = zl = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n):
            sl = slice(i * ch, (i + 1) * ch)
            a, b, c = checkpoint(chunk_sums, p, h[:, sl], mb["labels"][:, sl],
                                 use_reentrant=False)
            nll, zl, cnt = nll + a, zl + b, cnt + c
        denom = torch.clamp(cnt, min=1.0)
        ce = nll / denom
        zloss = zl / denom
        metrics = {"ce": ce, "z_loss": zloss,
                   "ppl": torch.exp(torch.clamp(ce, 0.0, 20.0)),
                   "tokens": cnt}
        return ce + 1e-4 * zloss, metrics

    def one(params, mb):
        masters = [p.detach().requires_grad_() for p in leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(bf16_cast(unflatten(params, masters)), mb)
            grads = torch.autograd.grad(loss, masters, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(masters, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def loss_and_grads(params, batch):
        if mb_constraint is not None and not all(
                is_dtensor(v) for v in batch.values()):
            raise ValueError("mb_constraint lays microbatches out on a "
                             "mesh; this batch lies on no mesh")
        if microbatches == 1:
            loss, metrics, grads = one(params, batch)
            return loss, metrics, unflatten(params, grads)
        mbs = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                            *v.shape[1:]) for k, v in batch.items()}
        acc = [zeros_f32(p) for p in leaves(params)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=acc[0].device)
        for i in range(microbatches):
            mb = {k: v[i] for k, v in mbs.items()}
            if mb_constraint is not None:
                mb = redistribute_tree(mb, mb_constraint)
            loss, metrics, grads = one(params, mb)
            for a, g in zip(acc, grads):
                a.add_(g)
            loss_sum = loss_sum + loss
        return (loss_sum / microbatches, metrics,
                unflatten(params, [a / microbatches for a in acc]))

    return loss_and_grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    q_chunk: int = 512, microbatches: int = 1,
                    remat: bool = True, mb_constraint=None,
                    loss_chunk: int = 0):
    """``train_step(state, batch) -> (state, metrics)``, the state's
    masters and moments updated in place; ``metrics`` are float32 scalar
    tensors (``loss``, ``ce``, ``z_loss``, ``ppl``, ``tokens``).  The
    arguments are :func:`make_loss_and_grads`'s; ``mb_constraint`` pins
    each microbatch's layout on a mesh (the reference's, its
    ``train/step.py:54-66``): a batch on no mesh with a constraint
    raises ``ValueError``."""
    loss_and_grads = make_loss_and_grads(cfg, q_chunk, microbatches, remat,
                                         loss_chunk, mb_constraint)

    def train_step(state: TrainState, batch):
        loss, metrics, grads = loss_and_grads(state.params, batch)
        params, opt = adamw_step(opt_cfg, state.params, grads, state.opt)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return TrainState(step=state.step + 1, params=params,
                          opt=opt), metrics

    return train_step
