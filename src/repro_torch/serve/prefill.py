"""Batched prefill (counterpart of :mod:`repro.serve.prefill`): one
chunked-causal pass over the whole prompt that fills the KV cache and
returns the last position's logits.  Dense (gemma2's local/global layers
included), moe and vlm families; the ssm, hybrid and encdec families
raise, as in the reference: they prefill one token at a time through
``serve_step``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.config import ModelConfig
from ..models.layers import (_mrope_tables, _qkv, attention,
                             mrope_positions, rotary)
from ..models.lm import (LmParams, block_apply, check_kv_family,
                         embed_batch, layer_window, logits_from_hidden)

__all__ = ["prefill"]


def prefill(params: LmParams, cfg: ModelConfig,
            cache: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
            *, q_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``batch = {"tokens": (B, S)[, "patches": (B, P, d)]}`` -> (last
    logits ``(B, 1, Vp)``, the cache with positions ``[0, S)`` written in
    place).  ``S`` may be less than the cache's ``max_len``.  M-RoPE
    positions apply only when patches are given (text alone takes plain
    RoPE, which M-RoPE equals there, as decode does)."""
    check_kv_family(cfg, "batched prefill")
    x = embed_batch(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    if cfg.mrope and "patches" in batch:
        cos_sin = _mrope_tables(
            mrope_positions(positions, cfg.n_frontend_tokens,
                            cfg.mrope_sections),
            cfg.head_dim_, cfg.rope_theta, cfg.mrope_sections)
    else:
        cos_sin = rotary(positions, cfg.head_dim_, cfg.rope_theta)
    q_chunk = min(q_chunk, S)

    def attend(layer, p, xn):
        _, k, v = _qkv(p, cfg, xn, *cos_sin)             # roped k, raw v
        cache["k"][layer, :, :S] = k
        cache["v"][layer, :, :S] = v
        return attention(p, cfg, xn, positions,
                         window=layer_window(cfg, layer), q_chunk=q_chunk,
                         cos_sin=cos_sin, kv=(k, v))

    for layer, blk in enumerate(params.blocks):
        x = block_apply(blk, cfg, x, lambda p, xn: attend(layer, p, xn))
    return logits_from_hidden(params, cfg, x[:, -1:, :]), cache
