"""Decoder-only LM (counterpart of :mod:`repro.models.lm`): the dense,
moe, ssm, hybrid and vlm families.

dense   [pre-norm attention + SwiGLU/GeGLU] x L; gemma2 adds sandwich
        norms (``post_attn_ln``, ``post_mlp_ln``), softcaps, a scaled
        embedding and local/global alternation: layer ``2j`` attends over
        a ``sliding_window``, layer ``2j + 1`` over the whole prefix;
moe     attention + top-k routed experts (+ optional shared experts);
ssm     Mamba2 SSD blocks (:mod:`repro_torch.models.ssm`), attention-free;
hybrid  the Mamba2 backbone with ONE weight-tied attention + MLP block
        (``shared_attn``) applied before every ``attn_every`` SSM blocks
        (zamba2-style): before layer ``i`` where ``i % attn_every == 0``,
        its KV slot ``i // attn_every`` (:func:`shared_slot`);
vlm     the dense backbone, a patch projection written over the first
        positions and M-RoPE positions.

The layers are a Python loop over a flat tuple of per-layer parameters
(the reference scans over stacked ones, gemma2's as ``(L/2, 2)`` pairs,
the hybrid's as ``(L / attn_every, attn_every)`` groups).  Under
autograd, ``forward(remat=True)`` recomputes in the backward pass what
the reference's ``jax.checkpoint`` does: one scanned body at a time
(:func:`layer_groups`).  The encoder-decoder lives in
:mod:`repro_torch.models.encdec`.

Randomness: ``init_params`` draws with a ``torch.Generator``, whose numbers
are not ``jax.random``'s; ``params_from_numpy`` carries the reference's
parameters over instead, so both packages can run the same weights.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .._device import DeviceArg, resolve_device
from ..sharding.partition import constrain_batch, gather_fsdp, is_dtensor
from .config import ModelConfig
from .layers import (BF16, AttnParams, MlpParams, MoeParams, _dot,
                     _mrope_tables, attention, init_attn, init_mlp,
                     init_moe, mlp, moe, mrope_positions, normal_weight,
                     remat_call, rms_norm, rotary, softcap)
from .ssm import SsmParams, init_ssm, ssd_forward

__all__ = ["DenseBlock", "MoeBlock", "SsmBlock", "LmParams", "FAMILIES",
           "KV_FAMILIES", "check_supported", "check_kv_family",
           "init_params", "params_from_numpy", "layer_window", "shared_slot",
           "layer_groups",
           "embed_tokens", "embed_batch", "logits_from_hidden",
           "block_apply", "ssm_block_apply", "forward"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
# the families with a KV cache of every layer: batched prefill and PQ-KV
# serve these only, as in the reference
KV_FAMILIES = ("dense", "moe", "vlm")


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


class SsmBlock(NamedTuple):
    ln: torch.Tensor
    ssm: SsmParams


class LmParams(NamedTuple):
    embed: torch.Tensor                    # (Vp, d)
    blocks: Sequence[Union[DenseBlock, MoeBlock, SsmBlock]]  # one a layer
    final_norm: torch.Tensor               # (d,)
    lm_head: Optional[torch.Tensor]        # (Vp, d); None when tied
    patch_proj: Optional[torch.Tensor] = None   # (d, d), vlm only
    shared_attn: Optional[DenseBlock] = None    # hybrid only (weight-tied)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a family the decoder LM does not run: ``ValueError`` for
    encdec (:mod:`repro_torch.models.encdec`), ``NotImplementedError``
    for an unknown one."""
    if cfg.family == "encdec":
        raise ValueError("family 'encdec' lives in repro_torch.models.encdec"
                         " (init_params_encdec, forward_encdec)")
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported ({', '.join(FAMILIES)})")


def check_kv_family(cfg: ModelConfig, what: str) -> None:
    """Raise ``NotImplementedError`` naming the family where ``what``
    (batched prefill, PQ-KV) needs a KV cache in every layer: the ssm,
    hybrid and encdec families prefill one token at a time through
    ``serve_step``, and the reference refuses them PQ-KV too."""
    if cfg.family not in KV_FAMILIES:
        raise NotImplementedError(
            f"{what}: not for the {cfg.family!r} family "
            f"({', '.join(KV_FAMILIES)} only)")


def shared_slot(cfg: ModelConfig, layer: int) -> Optional[int]:
    """The hybrid's shared attention block runs before ``layer`` when
    ``layer % attn_every == 0``: its KV slot (the group ``layer //
    attn_every``), else ``None``.  ``None`` for every other family."""
    if cfg.family != "hybrid" or layer % cfg.attn_every:
        return None
    return layer // cfg.attn_every


def layer_window(cfg: ModelConfig, layer: int) -> int:
    """The attention window of ``layer``: gemma2's even layers are local
    (``sliding_window``), every other layer attends to the whole prefix
    (0)."""
    return cfg.sliding_window if cfg.local_global and layer % 2 == 0 else 0


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceArg = None,
                dtype: torch.dtype = BF16) -> LmParams:
    """Random parameters (reference scale: ``N(0, 0.02)`` weights, zero
    norm scales), weights and norm scales stored in ``dtype`` on
    ``device``: bf16 for serving, ``torch.float32`` for the reference's
    training masters (the SSM blocks' float32 leaves are float32 either
    way: :func:`~repro_torch.models.ssm.init_ssm`).  ``ValueError`` for
    encdec, as the reference's."""
    check_supported(cfg)
    dev = resolve_device(device)
    d = cfg.d_model

    def zeros():
        return torch.zeros(d, dtype=dtype, device=dev)

    def dense(sandwich):
        return DenseBlock(ln1=zeros(),
                          attn=init_attn(generator, cfg, dev, dtype),
                          post_attn_ln=zeros() if sandwich else None,
                          ln2=zeros(),
                          mlp=init_mlp(generator, d, cfg.d_ff, dev, dtype),
                          post_mlp_ln=zeros() if sandwich else None)

    def block():
        if cfg.family == "moe":
            return MoeBlock(ln1=zeros(),
                            attn=init_attn(generator, cfg, dev, dtype),
                            ln2=zeros(),
                            moe=init_moe(generator, cfg, dev, dtype))
        if cfg.family in ("ssm", "hybrid"):
            return SsmBlock(ln=zeros(),
                            ssm=init_ssm(generator, cfg, dev, dtype))
        return dense(cfg.local_global)

    def w(*shape):
        return normal_weight(generator, shape, dev, dtype)

    blocks = tuple(block() for _ in range(cfg.n_layers))
    shared_attn = dense(False) if cfg.family == "hybrid" else None
    embed = w(cfg.padded_vocab, d)
    lm_head = None if cfg.tie_embeddings else w(cfg.padded_vocab, d)
    patch_proj = w(d, d) if cfg.family == "vlm" else None
    return LmParams(embed=embed, blocks=blocks, final_norm=zeros(),
                    lm_head=lm_head, patch_proj=patch_proj,
                    shared_attn=shared_attn)


def _weight(a, dev, dtype: torch.dtype = BF16) -> Optional[torch.Tensor]:
    """A numpy weight stored in ``dtype``: bf16 (the reference rounds it
    to bf16 at every use), or float32 for training masters."""
    return (None if a is None else
            torch.from_numpy(np.array(a, np.float32)).to(dev, dtype))


def _f32(a, dev) -> Optional[torch.Tensor]:
    """A numpy leaf the reference uses in float32 (biases, the SSM's
    convolutions, ``a_log``, ``d_skip``, ``dt_bias``)."""
    return (None if a is None else
            torch.from_numpy(np.array(a, np.float32)).to(dev))


def attn_from_numpy(at, dev, dtype: torch.dtype = BF16) -> AttnParams:
    """One layer's ``AttnParams`` fields (numpy) -> the port's."""
    return AttnParams(wq=_weight(at.wq, dev, dtype),
                      wk=_weight(at.wk, dev, dtype),
                      wv=_weight(at.wv, dev, dtype),
                      wo=_weight(at.wo, dev, dtype),
                      bq=_f32(at.bq, dev), bk=_f32(at.bk, dev),
                      bv=_f32(at.bv, dev))


def mlp_from_numpy(ml, dev, dtype: torch.dtype = BF16) -> MlpParams:
    return MlpParams(w_gate=_weight(ml.w_gate, dev, dtype),
                     w_up=_weight(ml.w_up, dev, dtype),
                     w_down=_weight(ml.w_down, dev, dtype))


def _dense_from_numpy(blk, dev, dtype: torch.dtype = BF16) -> DenseBlock:
    """One (unstacked) ``DenseBlock``'s fields (numpy) -> the port's."""
    return DenseBlock(
        ln1=_weight(blk.ln1, dev, dtype),
        attn=attn_from_numpy(blk.attn, dev, dtype),
        post_attn_ln=_weight(getattr(blk, "post_attn_ln", None), dev, dtype),
        ln2=_weight(blk.ln2, dev, dtype),
        mlp=mlp_from_numpy(blk.mlp, dev, dtype),
        post_mlp_ln=_weight(getattr(blk, "post_mlp_ln", None), dev, dtype))


def _ssm_from_numpy(s, dev, dtype: torch.dtype = BF16) -> SsmParams:
    """One layer's ``SsmParams`` fields (numpy): the projections, ``norm``
    and ``out_proj`` in ``dtype``, the float32 leaves in float32."""
    f32 = ("conv_x", "conv_B", "conv_C", "conv_bx", "conv_bB", "conv_bC",
           "a_log", "d_skip", "dt_bias")
    return SsmParams(**{
        name: (_f32(getattr(s, name), dev) if name in f32
               else _weight(getattr(s, name), dev, dtype))
        for name in SsmParams._fields})


def _take(tree, index):
    """``tree`` (NamedTuples of stacked numpy arrays) at ``index`` of the
    leading axes; ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_take(f, index) for f in tree))
    return tree[index]


def params_from_numpy(params, cfg: ModelConfig, device: DeviceArg = None,
                      dtype: torch.dtype = BF16) -> LmParams:
    """The reference's parameters as numpy arrays -> the port's.

    ``params`` has the reference's ``LmParams`` fields (``embed``,
    ``blocks``, ``final_norm``, ``lm_head``, ``patch_proj``,
    ``shared_attn``), its ``blocks`` the ``DenseBlock`` / ``MoeBlock`` /
    ``SsmBlock`` fields stacked along a leading layer axis, read by
    attribute name: gemma2's along ``(L/2, 2)`` pairs (layer ``2j + i``
    is pair ``j``'s ``i``-th), the hybrid's along ``(L / attn_every,
    attn_every)`` groups (layer ``i`` is group ``i // attn_every``'s
    ``i % attn_every``-th; ``shared_attn`` one unstacked ``DenseBlock``).
    Weights and norm scales are stored in ``dtype``: bf16 (the reference
    rounds them to bf16 at every use), or ``torch.float32`` to load the
    reference's training masters; biases and the SSM's float32 leaves in
    float32."""
    check_supported(cfg)
    dev = resolve_device(device)

    def index(i):
        if cfg.local_global:
            return (i // 2, i % 2)
        if cfg.family == "hybrid":
            return divmod(i, cfg.attn_every)
        return i

    blocks = []
    for i in range(cfg.n_layers):
        blk = _take(params.blocks, index(i))
        if cfg.family == "moe":
            mo = blk.moe
            blocks.append(MoeBlock(
                ln1=_weight(blk.ln1, dev, dtype),
                attn=attn_from_numpy(blk.attn, dev, dtype),
                ln2=_weight(blk.ln2, dev, dtype),
                moe=MoeParams(
                    router=_weight(mo.router, dev, dtype),
                    we_gate=_weight(mo.we_gate, dev, dtype),
                    we_up=_weight(mo.we_up, dev, dtype),
                    we_down=_weight(mo.we_down, dev, dtype),
                    shared=(None if mo.shared is None
                            else mlp_from_numpy(mo.shared, dev, dtype)))))
        elif cfg.family in ("ssm", "hybrid"):
            blocks.append(SsmBlock(ln=_weight(blk.ln, dev, dtype),
                                   ssm=_ssm_from_numpy(blk.ssm, dev, dtype)))
        else:
            blocks.append(_dense_from_numpy(blk, dev, dtype))
    shared = getattr(params, "shared_attn", None)
    return LmParams(
        embed=_weight(params.embed, dev, dtype), blocks=tuple(blocks),
        final_norm=_weight(params.final_norm, dev, dtype),
        lm_head=_weight(params.lm_head, dev, dtype),
        patch_proj=_weight(getattr(params, "patch_proj", None), dev, dtype),
        shared_attn=(None if shared is None
                     else _dense_from_numpy(shared, dev, dtype)))


def embed_tokens(params: LmParams, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """``tokens (B, S)`` -> bf16 ``(B, S, d)``; gemma2 scales them by
    ``bf16(sqrt(d_model))`` (a bf16 product)."""
    table = gather_fsdp(params.embed)
    if is_dtensor(table):
        from .spmd import embed_mesh
        x = constrain_batch(embed_mesh(table, tokens).to(BF16))
    else:
        x = table[tokens.long()].to(BF16)
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
        proj = _dot(batch["patches"], gather_fsdp(params.patch_proj))
        x[:, :proj.shape[1]] = proj
    return x


def block_apply(blk, cfg: ModelConfig, h: torch.Tensor, attn_fn
                ) -> torch.Tensor:
    """One block around its attention: ``attn_fn(attn_params, normed h)``
    gives the attention output (prefill, decode or PQ decode).  Then the
    sandwich norms where the block has them, and the MLP or the experts.
    On a mesh the block's weights are gathered over the FSDP axes here,
    and ``h`` and the row-parallel outputs (partial sums over ``model``)
    are pinned to the DP axes, replicated over ``model``, before they are
    added."""
    h = constrain_batch(h)
    blk = gather_fsdp(blk)
    a = constrain_batch(attn_fn(blk.attn, rms_norm(h, blk.ln1, cfg.norm_eps)))
    if getattr(blk, "post_attn_ln", None) is not None:
        a = rms_norm(a, blk.post_attn_ln, cfg.norm_eps)
    h = h + a
    if isinstance(blk, MoeBlock):
        return constrain_batch(h + constrain_batch(
            moe(blk.moe, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))))
    m = constrain_batch(mlp(blk.mlp, rms_norm(h, blk.ln2, cfg.norm_eps),
                            cfg.act))
    if blk.post_mlp_ln is not None:
        m = rms_norm(m, blk.post_mlp_ln, cfg.norm_eps)
    return constrain_batch(h + m)


def ssm_block_apply(blk: SsmBlock, cfg: ModelConfig, h: torch.Tensor, *,
                    chunk: int = 128) -> torch.Tensor:
    """One SSM block over a full sequence: ``h + ssd_forward(norm(h))``."""
    h = constrain_batch(h)
    blk = gather_fsdp(blk)
    return constrain_batch(h + constrain_batch(ssd_forward(
        blk.ssm, cfg, rms_norm(h, blk.ln, cfg.norm_eps), chunk=chunk)))


def logits_from_hidden(params, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head: bf16 operands, float32 products and sums
    (float32 logits), as the reference's ``preferred_element_type``.
    ``params`` is an :class:`LmParams` or an
    :class:`~repro_torch.models.encdec.EncDecParams`."""
    h = rms_norm(constrain_batch(h), params.final_norm, cfg.norm_eps)
    head = gather_fsdp(params.embed if params.lm_head is None
                       else params.lm_head)
    logits = torch.matmul(h.to(BF16).float(), head.to(BF16).float().T)
    return softcap(logits, cfg.final_softcap)


def layer_groups(cfg: ModelConfig):
    """The layers of each body the reference scans and checkpoints: one
    layer, gemma2's local/global pair (its ``(L/2, 2)`` scan), or the
    hybrid's group (the shared block with its ``attn_every`` SSM
    layers)."""
    size = (2 if cfg.local_global else
            cfg.attn_every if cfg.family == "hybrid" else 1)
    return [range(i, min(i + size, cfg.n_layers))
            for i in range(0, cfg.n_layers, size)]


def forward(params: LmParams, cfg: ModelConfig, batch, *,
            q_chunk: int = 512, remat: bool = True, ssm_chunk: int = 128,
            return_hidden: bool = False) -> torch.Tensor:
    """Token logits ``(B, S, padded_vocab)`` for ``batch = {"tokens": (B,
    S)[, "patches": (B, P, d)]}``; ``return_hidden=True`` returns the final
    hidden states.  A config with ``mrope`` takes M-RoPE positions whether
    or not patches are given, as the reference's ``forward`` does.
    ``ssm_chunk`` is the SSD chunk of the ssm and hybrid families.
    ``remat``: under autograd, each of :func:`layer_groups` keeps only its
    input and recomputes the rest in the backward pass (the same values
    and gradients, bit for bit)."""
    check_supported(cfg)
    x = embed_batch(params, cfg, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    if cfg.family == "ssm":
        cos_sin = None
    elif cfg.mrope:
        cos_sin = _mrope_tables(
            mrope_positions(positions, cfg.n_frontend_tokens,
                            cfg.mrope_sections),
            cfg.head_dim_, cfg.rope_theta, cfg.mrope_sections)
    else:
        cos_sin = rotary(positions, cfg.head_dim_, cfg.rope_theta)

    def attend(window):
        return lambda p, xn: attention(p, cfg, xn, positions, window=window,
                                       q_chunk=q_chunk, cos_sin=cos_sin)

    def body(layers):
        def run(h):
            for i in layers:
                if shared_slot(cfg, i) is not None:
                    h = block_apply(params.shared_attn, cfg, h, attend(0))
                blk = params.blocks[i]
                if isinstance(blk, SsmBlock):
                    h = ssm_block_apply(blk, cfg, h, chunk=ssm_chunk)
                else:
                    h = block_apply(blk, cfg, h, attend(layer_window(cfg, i)))
            return h
        return run

    for layers in layer_groups(cfg):
        x = remat_call(body(layers), x, remat)
    if return_hidden:
        return x
    return logits_from_hidden(params, cfg, x)
