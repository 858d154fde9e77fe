"""Encoder-decoder backbone, seamless-m4t style (counterpart of
:mod:`repro.models.encdec`).

The speech frontend is a stub: the encoder takes precomputed frame
embeddings ``(B, S_frames, d_model)``.  Encoder blocks are bidirectional;
decoder blocks add cross-attention to the encoder's output.
Cross-attention queries use position-0 rope tables (the identity
rotation), and the cross keys and values take no rope.  The layers are a
Python loop over flat tuples of per-layer parameters (the reference scans
over stacked ones); under autograd ``remat=True`` recomputes one encoder
or decoder layer at a time in the backward pass, as the reference's
``jax.checkpoint`` on its scanned bodies.

>>> import torch
>>> from repro_torch.configs.registry import get_reduced
>>> cfg = get_reduced("seamless-m4t-large-v2")
>>> g = torch.Generator().manual_seed(0)
>>> p = init_params_encdec(cfg, g, "cpu")
>>> batch = {"frames": torch.randn((1, cfg.n_frontend_tokens, cfg.d_model),
...                                generator=g),
...          "tokens": torch.zeros((1, 3), dtype=torch.int32)}
>>> forward_encdec(p, cfg, batch).shape
torch.Size([1, 3, 512])
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .._device import DeviceArg, resolve_device
from ..sharding.partition import constrain_batch, gather_fsdp, is_dtensor
from .config import ModelConfig
from .layers import (BF16, AttnParams, MlpParams, _dot, attention, init_attn,
                     init_mlp, mlp, normal_weight, remat_call, rms_norm,
                     rotary)
from .lm import (_take, _weight, attn_from_numpy, embed_tokens,
                 logits_from_hidden, mlp_from_numpy)

__all__ = ["EncBlock", "DecBlock", "EncDecParams", "init_params_encdec",
           "encdec_params_from_numpy", "encode_frames", "cross_kv",
           "forward_encdec"]


class EncBlock(NamedTuple):
    ln1: torch.Tensor
    attn: AttnParams
    ln2: torch.Tensor
    mlp: MlpParams


class DecBlock(NamedTuple):
    ln1: torch.Tensor
    self_attn: AttnParams
    ln_x: torch.Tensor
    cross_attn: AttnParams
    ln2: torch.Tensor
    mlp: MlpParams


class EncDecParams(NamedTuple):
    embed: torch.Tensor                  # (Vp, d) decoder token embeddings
    frame_proj: torch.Tensor             # (d, d) frontend-stub projection
    enc_blocks: Sequence[EncBlock]       # one per encoder layer
    enc_norm: torch.Tensor
    dec_blocks: Sequence[DecBlock]       # one per decoder layer
    final_norm: torch.Tensor
    lm_head: Optional[torch.Tensor]


def init_params_encdec(cfg: ModelConfig, generator: torch.Generator,
                       device: DeviceArg = None,
                       dtype: torch.dtype = BF16) -> EncDecParams:
    """Random parameters (reference scale: ``N(0, 0.02)`` weights, zero
    norm scales), weights and norm scales stored in ``dtype`` on
    ``device`` (bf16, or ``torch.float32`` for training masters)."""
    dev = resolve_device(device)
    d, Vp = cfg.d_model, cfg.padded_vocab

    def zeros():
        return torch.zeros(d, dtype=dtype, device=dev)

    def attn():
        return init_attn(generator, cfg, dev, dtype)

    def ff():
        return init_mlp(generator, d, cfg.d_ff, dev, dtype)

    def enc():
        return EncBlock(ln1=zeros(), attn=attn(), ln2=zeros(), mlp=ff())

    def dec():
        return DecBlock(ln1=zeros(), self_attn=attn(), ln_x=zeros(),
                        cross_attn=attn(), ln2=zeros(), mlp=ff())

    enc_blocks = tuple(enc() for _ in range(cfg.n_enc_layers))
    dec_blocks = tuple(dec() for _ in range(cfg.n_layers))
    return EncDecParams(
        embed=normal_weight(generator, (Vp, d), dev, dtype),
        frame_proj=normal_weight(generator, (d, d), dev, dtype),
        enc_blocks=enc_blocks, enc_norm=zeros(), dec_blocks=dec_blocks,
        final_norm=zeros(),
        lm_head=normal_weight(generator, (Vp, d), dev, dtype))


def encdec_params_from_numpy(params, cfg: ModelConfig,
                             device: DeviceArg = None,
                             dtype: torch.dtype = BF16) -> EncDecParams:
    """The reference's ``EncDecParams`` as numpy arrays -> the port's: its
    ``enc_blocks`` / ``dec_blocks`` stacked along a leading layer axis,
    read by attribute name.  Weights and norm scales in ``dtype`` (bf16,
    or float32 for training masters), biases in float32 (as
    ``lm.params_from_numpy``)."""
    dev = resolve_device(device)

    def w(a):
        return _weight(a, dev, dtype)

    def enc(i):
        b = _take(params.enc_blocks, i)
        return EncBlock(ln1=w(b.ln1), attn=attn_from_numpy(b.attn, dev, dtype),
                        ln2=w(b.ln2), mlp=mlp_from_numpy(b.mlp, dev, dtype))

    def dec(i):
        b = _take(params.dec_blocks, i)
        return DecBlock(ln1=w(b.ln1),
                        self_attn=attn_from_numpy(b.self_attn, dev, dtype),
                        ln_x=w(b.ln_x),
                        cross_attn=attn_from_numpy(b.cross_attn, dev, dtype),
                        ln2=w(b.ln2), mlp=mlp_from_numpy(b.mlp, dev, dtype))

    return EncDecParams(
        embed=w(params.embed), frame_proj=w(params.frame_proj),
        enc_blocks=tuple(enc(i) for i in range(cfg.n_enc_layers)),
        enc_norm=w(params.enc_norm),
        dec_blocks=tuple(dec(i) for i in range(cfg.n_layers)),
        final_norm=w(params.final_norm), lm_head=w(params.lm_head))


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def encode_frames(params: EncDecParams, cfg: ModelConfig,
                  frames: torch.Tensor, *, q_chunk: int = 512,
                  remat: bool = True) -> torch.Tensor:
    """Bidirectional encoder over frontend-stub frames ``(B, Sf, d)``:
    the frame projection (one bf16 product), the encoder blocks, then
    ``enc_norm``.  Returns bf16 ``(B, Sf, d)``."""
    x = _dot(constrain_batch(frames), gather_fsdp(params.frame_proj))
    B, Sf, _ = x.shape
    positions = _positions(B, Sf, x.device)
    cos_sin = rotary(positions, cfg.head_dim_, cfg.rope_theta)

    def body(blk):
        def run(h):
            h, blk_ = constrain_batch(h), gather_fsdp(blk)
            h = h + constrain_batch(attention(
                blk_.attn, cfg, rms_norm(h, blk_.ln1, cfg.norm_eps),
                positions, causal=False, q_chunk=q_chunk, cos_sin=cos_sin))
            return constrain_batch(h + constrain_batch(mlp(
                blk_.mlp, rms_norm(h, blk_.ln2, cfg.norm_eps), cfg.act)))
        return run

    for blk in params.enc_blocks:
        x = remat_call(body(blk), x, remat)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def cross_kv(blk_cross: AttnParams, cfg: ModelConfig,
             enc_out: torch.Tensor):
    """One decoder layer's cross-attention keys and values ``(B, Sf, G,
    hd)`` from the encoder's output: bf16 products, no rope.  On a mesh
    they stay ``(B, Sf, G * hd)``, their heads on ``model`` as the
    products leave them (:func:`~repro_torch.models.spmd.attention_mesh`
    takes either form)."""
    B, Sf, _ = enc_out.shape
    G, hd = cfg.n_kv_heads, cfg.head_dim_
    k = _dot(enc_out, blk_cross.wk, blk_cross.bk)
    v = _dot(enc_out, blk_cross.wv, blk_cross.bv)
    if is_dtensor(k):
        return k, v
    return k.reshape(B, Sf, G, hd), v.reshape(B, Sf, G, hd)


def zero_cos_sin(cfg: ModelConfig, B: int, S: int, device):
    """Position-0 rope tables ``(B, S, hd/2)``: cross-attention's queries
    (cos 1, sin 0: the identity)."""
    zero = torch.zeros((B, S), dtype=torch.int32, device=device)
    return rotary(zero, cfg.head_dim_, cfg.rope_theta)


def forward_encdec(params: EncDecParams, cfg: ModelConfig, batch, *,
                   q_chunk: int = 512, remat: bool = True,
                   return_hidden: bool = False) -> torch.Tensor:
    """``batch = {"frames": (B, Sf, d), "tokens": (B, S)}`` -> logits
    ``(B, S, padded_vocab)`` float32 (the final hidden states with
    ``return_hidden``).  ``remat`` as :func:`encode_frames`'s."""
    enc_out = encode_frames(params, cfg, batch["frames"], q_chunk=q_chunk,
                            remat=remat)
    B, Sf, _ = enc_out.shape
    x = embed_tokens(params, cfg, batch["tokens"])
    S = x.shape[1]
    positions = _positions(B, S, x.device)
    cos_sin = rotary(positions, cfg.head_dim_, cfg.rope_theta)
    zero_pos = torch.zeros_like(positions)
    zeros = zero_cos_sin(cfg, B, S, x.device)
    kv_mask = torch.ones((B, Sf), dtype=torch.bool, device=x.device)
    def body(blk):
        def run(h):
            h, blk_ = constrain_batch(h), gather_fsdp(blk)
            h = h + constrain_batch(attention(
                blk_.self_attn, cfg, rms_norm(h, blk_.ln1, cfg.norm_eps),
                positions, q_chunk=q_chunk, cos_sin=cos_sin))
            k, v = cross_kv(blk_.cross_attn, cfg, enc_out)
            h = h + constrain_batch(attention(
                blk_.cross_attn, cfg, rms_norm(h, blk_.ln_x, cfg.norm_eps),
                zero_pos, causal=False, q_chunk=q_chunk, cos_sin=zeros,
                kv=(k, v), kv_mask=kv_mask))
            return constrain_batch(h + constrain_batch(mlp(
                blk_.mlp, rms_norm(h, blk_.ln2, cfg.norm_eps), cfg.act)))
        return run

    for blk in params.dec_blocks:
        x = remat_call(body(blk), x, remat)
    if return_hidden:
        return x
    return logits_from_hidden(params, cfg, x)
