"""Decoder-only LM (counterpart of :mod:`repro.models.lm`): the dense, moe
and vlm families.

dense   [pre-norm attention + SwiGLU/GeGLU] x L; gemma2 adds sandwich
        norms (``post_attn_ln``, ``post_mlp_ln``), softcaps, a scaled
        embedding and local/global alternation: layer ``2j`` attends over
        a ``sliding_window``, layer ``2j + 1`` over the whole prefix;
moe     attention + top-k routed experts (+ optional shared experts);
vlm     the dense backbone, a patch projection written over the first
        positions and M-RoPE positions.

The layers are a Python loop over a flat tuple of per-layer parameters
(the reference scans over stacked ones, gemma2's as ``(L/2, 2)`` pairs).
The ssm, hybrid and encdec families raise ``NotImplementedError`` naming
the family.

Randomness: ``init_params`` draws with a ``torch.Generator``, whose numbers
are not ``jax.random``'s; ``params_from_numpy`` carries the reference's
parameters over instead, so both packages can run the same weights.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .._device import DeviceArg, resolve_device
from .config import ModelConfig
from .layers import (BF16, AttnParams, MlpParams, MoeParams, _dot,
                     _mrope_tables, attention, init_attn, init_mlp,
                     init_moe, mlp, moe, mrope_positions, normal_weight,
                     rms_norm, rotary, softcap)

__all__ = ["DenseBlock", "MoeBlock", "LmParams", "FAMILIES",
           "check_supported", "init_params", "params_from_numpy",
           "layer_window", "embed_tokens", "embed_batch",
           "logits_from_hidden", "block_apply", "forward"]

FAMILIES = ("dense", "moe", "vlm")


class DenseBlock(NamedTuple):
    ln1: torch.Tensor
    attn: AttnParams
    post_attn_ln: Optional[torch.Tensor]   # gemma2 sandwich norm
    ln2: torch.Tensor
    mlp: MlpParams
    post_mlp_ln: Optional[torch.Tensor]


class MoeBlock(NamedTuple):
    ln1: torch.Tensor
    attn: AttnParams
    ln2: torch.Tensor
    moe: MoeParams


class LmParams(NamedTuple):
    embed: torch.Tensor                    # (Vp, d)
    blocks: Sequence[Union[DenseBlock, MoeBlock]]   # one per layer
    final_norm: torch.Tensor               # (d,)
    lm_head: Optional[torch.Tensor]        # (Vp, d); None when tied
    patch_proj: Optional[torch.Tensor] = None   # (d, d), vlm only


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families the port does not run: ssm, hybrid, encdec."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported (dense, moe, vlm)")


def layer_window(cfg: ModelConfig, layer: int) -> int:
    """The attention window of ``layer``: gemma2's even layers are local
    (``sliding_window``), every other layer attends to the whole prefix
    (0)."""
    return cfg.sliding_window if cfg.local_global and layer % 2 == 0 else 0


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceArg = None) -> LmParams:
    """Random parameters (reference scale: ``N(0, 0.02)`` weights, zero
    norm scales), weights stored in bf16 on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    d = cfg.d_model

    def zeros():
        return torch.zeros(d, dtype=BF16, device=dev)

    def block():
        if cfg.family == "moe":
            return MoeBlock(ln1=zeros(), attn=init_attn(generator, cfg, dev),
                            ln2=zeros(), moe=init_moe(generator, cfg, dev))
        sandwich = cfg.local_global
        return DenseBlock(ln1=zeros(), attn=init_attn(generator, cfg, dev),
                          post_attn_ln=zeros() if sandwich else None,
                          ln2=zeros(),
                          mlp=init_mlp(generator, d, cfg.d_ff, dev),
                          post_mlp_ln=zeros() if sandwich else None)

    blocks = tuple(block() for _ in range(cfg.n_layers))
    embed = normal_weight(generator, (cfg.padded_vocab, d), dev)
    lm_head = (None if cfg.tie_embeddings else
               normal_weight(generator, (cfg.padded_vocab, d), dev))
    patch_proj = (normal_weight(generator, (d, d), dev)
                  if cfg.family == "vlm" else None)
    return LmParams(embed=embed, blocks=blocks, final_norm=zeros(),
                    lm_head=lm_head, patch_proj=patch_proj)


def params_from_numpy(params, cfg: ModelConfig,
                      device: DeviceArg = None) -> LmParams:
    """The reference's parameters as numpy arrays -> the port's.

    ``params`` has the reference's ``LmParams`` fields (``embed``,
    ``blocks``, ``final_norm``, ``lm_head``, ``patch_proj``), its
    ``blocks`` the ``DenseBlock`` / ``MoeBlock`` fields stacked along a
    leading layer axis (gemma2's along ``(L/2, 2)`` pairs: layer ``2j +
    i`` is pair ``j``'s ``i``-th), read by attribute name.  Weights and
    norm scales are stored in bf16 (the reference rounds them to bf16 at
    every use), biases in float32."""
    check_supported(cfg)
    dev = resolve_device(device)

    def weight(a):
        return (None if a is None else
                torch.from_numpy(np.array(a, np.float32)).to(dev, BF16))

    def bias(a):
        return (None if a is None else
                torch.from_numpy(np.array(a, np.float32)).to(dev))

    def layer(a, i):
        if a is None:
            return None
        return a[i // 2, i % 2] if cfg.local_global else a[i]

    stacked = params.blocks
    blocks = []
    for i in range(cfg.n_layers):
        at = stacked.attn
        attn = AttnParams(
            wq=weight(layer(at.wq, i)), wk=weight(layer(at.wk, i)),
            wv=weight(layer(at.wv, i)), wo=weight(layer(at.wo, i)),
            bq=bias(layer(at.bq, i)), bk=bias(layer(at.bk, i)),
            bv=bias(layer(at.bv, i)))
        if cfg.family == "moe":
            mo = stacked.moe
            sh = mo.shared
            blocks.append(MoeBlock(
                ln1=weight(layer(stacked.ln1, i)), attn=attn,
                ln2=weight(layer(stacked.ln2, i)),
                moe=MoeParams(
                    router=weight(layer(mo.router, i)),
                    we_gate=weight(layer(mo.we_gate, i)),
                    we_up=weight(layer(mo.we_up, i)),
                    we_down=weight(layer(mo.we_down, i)),
                    shared=None if sh is None else MlpParams(
                        w_gate=weight(layer(sh.w_gate, i)),
                        w_up=weight(layer(sh.w_up, i)),
                        w_down=weight(layer(sh.w_down, i))))))
            continue
        ml = stacked.mlp
        blocks.append(DenseBlock(
            ln1=weight(layer(stacked.ln1, i)), attn=attn,
            post_attn_ln=weight(layer(stacked.post_attn_ln, i)),
            ln2=weight(layer(stacked.ln2, i)),
            mlp=MlpParams(w_gate=weight(layer(ml.w_gate, i)),
                          w_up=weight(layer(ml.w_up, i)),
                          w_down=weight(layer(ml.w_down, i))),
            post_mlp_ln=weight(layer(stacked.post_mlp_ln, i))))
    return LmParams(
        embed=weight(params.embed), blocks=tuple(blocks),
        final_norm=weight(params.final_norm),
        lm_head=weight(params.lm_head),
        patch_proj=weight(getattr(params, "patch_proj", None)))


def embed_tokens(params: LmParams, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """``tokens (B, S)`` -> bf16 ``(B, S, d)``; gemma2 scales them by
    ``bf16(sqrt(d_model))`` (a bf16 product)."""
    x = params.embed[tokens.long()].to(BF16)
    if cfg.local_global:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=BF16,
                             device=x.device)
    return x


def embed_batch(params: LmParams, cfg: ModelConfig, batch) -> torch.Tensor:
    """:func:`embed_tokens` of ``batch["tokens"]``; a vlm batch's
    ``patches (B, P, d)``, projected by ``patch_proj`` (one bf16 product),
    replace the first ``P`` positions."""
    x = embed_tokens(params, cfg, batch["tokens"])
    if cfg.family == "vlm" and "patches" in batch:
        proj = _dot(batch["patches"], params.patch_proj)
        x[:, :proj.shape[1]] = proj
    return x


def block_apply(blk, cfg: ModelConfig, h: torch.Tensor, attn_fn
                ) -> torch.Tensor:
    """One block around its attention: ``attn_fn(attn_params, normed h)``
    gives the attention output (prefill, decode or PQ decode).  Then the
    sandwich norms where the block has them, and the MLP or the experts."""
    a = attn_fn(blk.attn, rms_norm(h, blk.ln1, cfg.norm_eps))
    if getattr(blk, "post_attn_ln", None) is not None:
        a = rms_norm(a, blk.post_attn_ln, cfg.norm_eps)
    h = h + a
    if isinstance(blk, MoeBlock):
        return h + moe(blk.moe, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))
    m = mlp(blk.mlp, rms_norm(h, blk.ln2, cfg.norm_eps), cfg.act)
    if blk.post_mlp_ln is not None:
        m = rms_norm(m, blk.post_mlp_ln, cfg.norm_eps)
    return h + m


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
    S)[, "patches": (B, P, d)]}``; ``return_hidden=True`` returns the final
    hidden states.  A config with ``mrope`` takes M-RoPE positions whether
    or not patches are given, as the reference's ``forward`` does."""
    check_supported(cfg)
    x = embed_batch(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    if cfg.mrope:
        cos_sin = _mrope_tables(
            mrope_positions(positions, cfg.n_frontend_tokens,
                            cfg.mrope_sections),
            cfg.head_dim_, cfg.rope_theta, cfg.mrope_sections)
    else:
        cos_sin = rotary(positions, cfg.head_dim_, cfg.rope_theta)
    for i, blk in enumerate(params.blocks):
        window = layer_window(cfg, i)
        x = block_apply(blk, cfg, x, lambda p, xn: attention(
            p, cfg, xn, positions, window=window, q_chunk=q_chunk,
            cos_sin=cos_sin))
    if return_hidden:
        return x
    return logits_from_hidden(params, cfg, x)
