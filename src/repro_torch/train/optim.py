"""AdamW and its learning-rate schedule on the port's parameter trees
(counterpart of :mod:`repro.train.optim`).

The moments are trees of the parameters' structure.  ``adamw_step``
updates parameters and moments in place (the reference donates its
state to the jitted step): a caller that keeps the old state copies it
first, as ``AsyncCheckpointer.submit`` does.

Arithmetic follows the reference op by op on float32 tensors on the
parameters' device: ``lr``, ``b1 ** count`` and ``b2 ** count`` are
float32 tensors (no host read of ``count``; Python's float64 would round
otherwise), the constants ``1 - b1`` and ``1 - b2`` are Python floats
rounded to float32 at use, as the reference's weak types are, and each
line of ``upd`` keeps its order of operations.  XLA may contract a
product and a sum into one fused multiply-add where PyTorch rounds twice:
the two agree within a float32 ulp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from .._tree import leaves, leaves_with_paths, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_step",
           "warmup_cosine", "global_norm", "matrix_like", "LAYER_STACKS"]

# the fields the reference stacks along a leading layer axis
LAYER_STACKS = ("blocks", "enc_blocks", "dec_blocks")


def matrix_like(path: Tuple, leaf: torch.Tensor) -> bool:
    """Whether the reference's leaf at ``path`` has ``ndim >= 2``: the
    rule of its bf16 cast (``train/step.py``) and its weight decay
    (``adamw_step``).  The reference stacks every block along a layer axis
    (``models/lm.py::_stack``), so every leaf under ``blocks`` /
    ``enc_blocks`` / ``dec_blocks`` counts, norm scales, biases and the
    SSM's ``conv_*``, ``a_log``, ``d_skip`` and ``dt_bias`` included; the
    port keeps one tensor a layer, one axis fewer.  Elsewhere (``embed``,
    ``lm_head``, the projections, the hybrid's unstacked ``shared_attn``,
    ``final_norm``, ``enc_norm``) the leaf's own ``ndim`` decides."""
    return path[0] in LAYER_STACKS or leaf.dim() >= 2


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: Any                 # first moments (a tree like params)
    nu: Any                 # second moments
    count: torch.Tensor     # int32 scalar on the parameters' device


def adamw_init(params) -> OptState:
    """Zero moments like ``params``, ``count`` 0 on their device."""
    dev = leaves(params)[0].device
    return OptState(mu=tree_map(torch.zeros_like, params),
                    nu=tree_map(torch.zeros_like, params),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to ``min_lr_frac * lr`` at
    ``total_steps``; ``step`` an integer tensor, the result float32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm of every leaf together."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def adamw_step(cfg: AdamWConfig, params, grads, state: OptState
               ) -> Tuple[Any, OptState]:
    """One AdamW update with global-norm clipping and decoupled decay
    (:func:`matrix_like` leaves only), in place: returns ``params`` and
    the moments updated, and the new ``count``."""
    gnorm = global_norm(grads)
    clip = torch.tensor(cfg.grad_clip, dtype=torch.float32,
                        device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    lr = warmup_cosine(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    with torch.no_grad():
        for (path, p), g, m, v in zip(leaves_with_paths(params),
                                      leaves(grads), leaves(state.mu),
                                      leaves(state.nu)):
            g = g.float() * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if matrix_like(path, p):
                step = step + cfg.weight_decay * p
            p.sub_(lr * step)
    return params, OptState(mu=state.mu, nu=state.nu, count=count)
