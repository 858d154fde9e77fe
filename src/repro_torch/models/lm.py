"""Decoder-only LM, dense family (counterpart of :mod:`repro.models.lm`).

``[pre-norm attention + SwiGLU] x L``; the layers are a Python loop over
per-layer parameter tuples (the reference scans over stacked ones).  The
other families of the reference (moe, vlm, gemma2-style local/global,
ssm, hybrid, encdec) raise ``NotImplementedError`` naming the family.

Randomness: ``init_params`` draws with a ``torch.Generator``, whose numbers
are not ``jax.random``'s; ``params_from_numpy`` carries the reference's
parameters over instead, so both packages can run the same weights.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .._device import DeviceArg, resolve_device
from .config import ModelConfig
from .layers import (BF16, AttnParams, MlpParams, attention, init_attn,
                     init_mlp, mlp, normal_weight, rms_norm, rotary, softcap)

__all__ = ["DenseBlock", "LmParams", "check_supported", "init_params",
           "params_from_numpy", "embed_tokens", "logits_from_hidden",
           "forward"]


class DenseBlock(NamedTuple):
    ln1: torch.Tensor
    attn: AttnParams
    post_attn_ln: Optional[torch.Tensor]   # gemma2 sandwich norm (unported)
    ln2: torch.Tensor
    mlp: MlpParams
    post_mlp_ln: Optional[torch.Tensor]


class LmParams(NamedTuple):
    embed: torch.Tensor                    # (Vp, d)
    blocks: Sequence[DenseBlock]           # one per layer
    final_norm: torch.Tensor               # (d,)
    lm_head: Optional[torch.Tensor]        # (Vp, d); None when tied


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet: every family but dense,
    and the dense family's gemma2-style local/global alternation."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported (dense only)")
    if cfg.local_global or cfg.sliding_window:
        raise NotImplementedError(
            "gemma2-style local/global attention is not ported")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceArg = None) -> LmParams:
    """Random parameters (reference scale: ``N(0, 0.02)`` weights, zero
    norm scales), weights stored in bf16 on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    d = cfg.d_model

    def zeros():
        return torch.zeros(d, dtype=BF16, device=dev)

    blocks = tuple(
        DenseBlock(ln1=zeros(), attn=init_attn(generator, cfg, dev),
                   post_attn_ln=None, ln2=zeros(),
                   mlp=init_mlp(generator, d, cfg.d_ff, dev),
                   post_mlp_ln=None)
        for _ in range(cfg.n_layers))
    embed = normal_weight(generator, (cfg.padded_vocab, d), dev)
    lm_head = (None if cfg.tie_embeddings else
               normal_weight(generator, (cfg.padded_vocab, d), dev))
    return LmParams(embed=embed, blocks=blocks, final_norm=zeros(),
                    lm_head=lm_head)


def params_from_numpy(params, cfg: ModelConfig,
                      device: DeviceArg = None) -> LmParams:
    """The reference's parameters as numpy arrays -> the port's.

    ``params`` has the reference's ``LmParams`` fields (``embed``,
    ``blocks``, ``final_norm``, ``lm_head``), its ``blocks`` the
    ``DenseBlock`` / ``AttnParams`` / ``MlpParams`` fields stacked along a
    leading layer axis, read by attribute name.  Weights and norm scales
    are stored in bf16 (the reference rounds them to bf16 at every use),
    biases in float32."""
    check_supported(cfg)
    dev = resolve_device(device)

    def weight(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev, BF16)

    def bias(a):
        return (None if a is None else
                torch.from_numpy(np.array(a, np.float32)).to(dev))

    stacked = params.blocks
    blocks = []
    for i in range(cfg.n_layers):
        at, ml = stacked.attn, stacked.mlp
        blocks.append(DenseBlock(
            ln1=weight(stacked.ln1[i]),
            attn=AttnParams(
                wq=weight(at.wq[i]), wk=weight(at.wk[i]),
                wv=weight(at.wv[i]), wo=weight(at.wo[i]),
                bq=None if at.bq is None else bias(at.bq[i]),
                bk=None if at.bk is None else bias(at.bk[i]),
                bv=None if at.bv is None else bias(at.bv[i])),
            post_attn_ln=None, ln2=weight(stacked.ln2[i]),
            mlp=MlpParams(w_gate=weight(ml.w_gate[i]),
                          w_up=weight(ml.w_up[i]),
                          w_down=weight(ml.w_down[i])),
            post_mlp_ln=None))
    return LmParams(
        embed=weight(params.embed), blocks=tuple(blocks),
        final_norm=weight(params.final_norm),
        lm_head=None if params.lm_head is None else weight(params.lm_head))


def embed_tokens(params: LmParams, tokens: torch.Tensor) -> torch.Tensor:
    """``tokens (B, S)`` -> bf16 ``(B, S, d)``."""
    return params.embed[tokens.long()].to(BF16)


def _dense_block_apply(blk: DenseBlock, cfg: ModelConfig, h: torch.Tensor,
                positions: torch.Tensor, cos_sin, *,
                q_chunk: int) -> torch.Tensor:
    a = attention(blk.attn, cfg, rms_norm(h, blk.ln1, cfg.norm_eps),
                  positions, q_chunk=q_chunk, cos_sin=cos_sin)
    h = h + a
    return h + mlp(blk.mlp, rms_norm(h, blk.ln2, cfg.norm_eps), cfg.act)


def logits_from_hidden(params: LmParams, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head: bf16 operands, float32 products and sums
    (float32 logits), as the reference's ``preferred_element_type``."""
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    head = params.embed if params.lm_head is None else params.lm_head
    logits = torch.matmul(h.to(BF16).float(), head.to(BF16).float().T)
    return softcap(logits, cfg.final_softcap)


def forward(params: LmParams, cfg: ModelConfig, batch, *,
            q_chunk: int = 512, return_hidden: bool = False) -> torch.Tensor:
    """Token logits ``(B, S, padded_vocab)`` for ``batch = {"tokens": (B,
    S)}``; ``return_hidden=True`` returns the final hidden states."""
    check_supported(cfg)
    x = embed_tokens(params, batch["tokens"])
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    cos_sin = rotary(positions, cfg.head_dim_, cfg.rope_theta)
    for blk in params.blocks:
        x = _dense_block_apply(blk, cfg, x, positions, cos_sin,
                               q_chunk=q_chunk)
    if return_hidden:
        return x
    return logits_from_hidden(params, cfg, x)
