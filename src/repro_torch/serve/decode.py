"""Single-token decode (counterpart of :mod:`repro.serve.decode`) for the
dense (gemma2's local/global layers included), moe and vlm families:
``serve_step(params, cfg, cache, token, pos) -> (logits, cache)``.  The
layers are a Python loop; each writes its cache slice at ``pos`` in
place."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.config import ModelConfig
from ..models.layers import attention_decode, rotary
from ..models.lm import (LmParams, block_apply, check_supported,
                         embed_tokens, layer_window, logits_from_hidden)

__all__ = ["serve_step", "decode_cos_sin"]


def decode_cos_sin(cfg: ModelConfig, batch: int, pos: int,
                   device: torch.device):
    """RoPE tables of the decode position, shared by every layer (a vlm's
    text positions too: M-RoPE equals RoPE where t = h = w)."""
    positions = torch.full((batch, 1), pos, dtype=torch.int32, device=device)
    return rotary(positions, cfg.head_dim_, cfg.rope_theta)


def serve_step(params: LmParams, cfg: ModelConfig,
               cache: Dict[str, torch.Tensor], token: torch.Tensor,
               pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``token (B, 1)`` integer ids, ``pos`` the write index -> (logits
    ``(B, 1, Vp)`` float32, the cache written at ``pos``)."""
    check_supported(cfg)
    pos = int(pos)
    x = embed_tokens(params, cfg, token)
    cos_sin = decode_cos_sin(cfg, x.shape[0], pos, x.device)
    for layer, blk in enumerate(params.blocks):
        x = block_apply(blk, cfg, x, lambda p, xn: attention_decode(
            p, cfg, xn, cache["k"][layer], cache["v"][layer], pos,
            window=layer_window(cfg, layer), cos_sin=cos_sin))
    return logits_from_hidden(params, cfg, x), cache
