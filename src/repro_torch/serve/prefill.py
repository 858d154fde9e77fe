"""Batched prefill (counterpart of :mod:`repro.serve.prefill`): one
chunked-causal pass over the whole prompt that fills the KV cache and
returns the last position's logits.  Dense family."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.config import ModelConfig
from ..models.layers import _qkv, attention, mlp, rms_norm, rotary
from ..models.lm import (LmParams, check_supported, embed_tokens,
                         logits_from_hidden)

__all__ = ["prefill"]


def prefill(params: LmParams, cfg: ModelConfig,
            cache: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            *, q_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``batch = {"tokens": (B, S)}`` -> (last logits ``(B, 1, Vp)``, the
    cache with positions ``[0, S)`` written in place).  ``S`` may be less
    than the cache's ``max_len``."""
    check_supported(cfg)
    x = embed_tokens(params, batch["tokens"])
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    cos_sin = rotary(positions, cfg.head_dim_, cfg.rope_theta)
    q_chunk = min(q_chunk, S)
    for layer, blk in enumerate(params.blocks):
        xn = rms_norm(x, blk.ln1, cfg.norm_eps)
        _, k, v = _qkv(blk.attn, cfg, xn, *cos_sin)       # roped k, raw v
        cache["k"][layer, :, :S] = k
        cache["v"][layer, :, :S] = v
        a = attention(blk.attn, cfg, xn, positions, q_chunk=q_chunk,
                      cos_sin=cos_sin, kv=(k, v))
        x = x + a
        x = x + mlp(blk.mlp, rms_norm(x, blk.ln2, cfg.norm_eps), cfg.act)
    return logits_from_hidden(params, cfg, x[:, -1:, :]), cache
