"""Single-token decode (counterpart of :mod:`repro.serve.decode`) for
every family: ``serve_step(params, cfg, cache, token, pos) -> (logits,
cache)``.  The layers are a Python loop; each writes its cache slice in
place: the KV cache at ``pos`` (dense with gemma2's local/global layers,
moe, vlm; the hybrid's shared-block slots; the encdec's self-attention),
the SSM states of the ssm and hybrid families.  The encdec's cross K/V
come from :func:`prefill_cache_encdec`, once a sequence."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.config import ModelConfig
from ..models.encdec import (EncDecParams, cross_kv, encode_frames,
                             zero_cos_sin)
from ..models.layers import attention_decode, mlp, rms_norm, rotary
from ..models.lm import (SsmBlock, block_apply, check_supported,
                         embed_tokens, layer_window, logits_from_hidden,
                         shared_slot)
from ..models.ssm import SSM_STATES, ssd_decode_step

__all__ = ["serve_step", "decode_cos_sin", "prefill_cache_encdec"]


def decode_cos_sin(cfg: ModelConfig, batch: int, pos: int,
                   device: torch.device):
    """RoPE tables of the decode position, shared by every layer (a vlm's
    text positions too: M-RoPE equals RoPE where t = h = w)."""
    positions = torch.full((batch, 1), pos, dtype=torch.int32, device=device)
    return rotary(positions, cfg.head_dim_, cfg.rope_theta)


def serve_step(params, cfg: ModelConfig, cache: Dict[str, torch.Tensor],
               token: torch.Tensor,
               pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``token (B, 1)`` integer ids, ``pos`` the write index -> (logits
    ``(B, 1, Vp)`` float32, the cache written in place).  ``params`` is an
    :class:`~repro_torch.models.lm.LmParams`, or an
    :class:`~repro_torch.models.encdec.EncDecParams` for encdec."""
    pos = int(pos)
    if cfg.family == "encdec":
        return _serve_encdec(params, cfg, cache, token, pos)
    check_supported(cfg)
    x = embed_tokens(params, cfg, token)
    cos_sin = (decode_cos_sin(cfg, x.shape[0], pos, x.device)
               if cfg.n_heads else None)

    def attn_block(blk, h, k_cache, v_cache, window=0):
        return block_apply(blk, cfg, h, lambda p, xn: attention_decode(
            p, cfg, xn, k_cache, v_cache, pos, window=window,
            cos_sin=cos_sin))

    for layer, blk in enumerate(params.blocks):
        slot = shared_slot(cfg, layer)
        if slot is not None:
            x = attn_block(params.shared_attn, x, cache["attn_k"][slot],
                           cache["attn_v"][slot])
        if isinstance(blk, SsmBlock):
            x = _ssm_decode_block(blk, cfg, x, cache, layer)
        else:
            x = attn_block(blk, x, cache["k"][layer], cache["v"][layer],
                           layer_window(cfg, layer))
    return logits_from_hidden(params, cfg, x), cache


def _ssm_decode_block(blk: SsmBlock, cfg: ModelConfig, h: torch.Tensor,
                      cache: Dict[str, torch.Tensor],
                      layer: int) -> torch.Tensor:
    """One SSM layer's recurrence step, its four states updated in
    place."""
    state = tuple(cache[name][layer] for name in SSM_STATES)
    out, new = ssd_decode_step(blk.ssm, cfg,
                               rms_norm(h, blk.ln, cfg.norm_eps), state)
    for old, t in zip(state, new):
        old.copy_(t)
    return h + out


def _serve_encdec(params: EncDecParams, cfg: ModelConfig, cache, token,
                  pos: int):
    """The decoder's step: causal self-attention over ``self_k/v`` (written
    at ``pos``), cross-attention over the whole ``cross_k/v`` (read only,
    queries at position 0), the MLP."""
    x = embed_tokens(params, cfg, token)
    B = x.shape[0]
    cos_sin = decode_cos_sin(cfg, B, pos, x.device)
    zeros = zero_cos_sin(cfg, B, 1, x.device)
    Sf = cache["cross_k"].shape[2]
    for layer, blk in enumerate(params.dec_blocks):
        x = x + attention_decode(
            blk.self_attn, cfg, rms_norm(x, blk.ln1, cfg.norm_eps),
            cache["self_k"][layer], cache["self_v"][layer], pos,
            cos_sin=cos_sin)
        x = x + attention_decode(
            blk.cross_attn, cfg, rms_norm(x, blk.ln_x, cfg.norm_eps),
            cache["cross_k"][layer], cache["cross_v"][layer], Sf - 1,
            update_cache=False, cos_sin=zeros)
        x = x + mlp(blk.mlp, rms_norm(x, blk.ln2, cfg.norm_eps), cfg.act)
    return logits_from_hidden(params, cfg, x), cache


def prefill_cache_encdec(params: EncDecParams, cfg: ModelConfig,
                         cache: Dict[str, torch.Tensor],
                         frames: torch.Tensor, q_chunk: int = 512
                         ) -> Dict[str, torch.Tensor]:
    """Run the encoder once over ``frames (B, Sf, d)`` and write every
    decoder layer's cross-attention K/V (bf16) into the cache in place."""
    enc_out = encode_frames(params, cfg, frames, q_chunk=q_chunk)
    for layer, blk in enumerate(params.dec_blocks):
        k, v = cross_kv(blk.cross_attn, cfg, enc_out)
        cache["cross_k"][layer] = k.to(torch.bfloat16)
        cache["cross_v"][layer] = v.to(torch.bfloat16)
    return cache
