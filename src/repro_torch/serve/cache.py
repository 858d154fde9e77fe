"""Cache construction (counterpart of :mod:`repro.serve.cache`).

A cache is a dict of tensors with a leading layer (or slot) axis, the
reference's layouts:

* dense (gemma2's local and global layers alike), moe, vlm: ``{"k",
  "v"}: (L, B, max_len, G, hd)`` bf16;
* ssm: the float32 SSM states ``"ssd" (L, B, H, P, N)``, ``"conv_x" (L, B,
  ck-1, din)``, ``"conv_B"`` and ``"conv_C" (L, B, ck-1, N)``;
* hybrid: the same states, plus ``"attn_k"`` and ``"attn_v" (L /
  attn_every, B, max_len, G, hd)`` bf16, one slot for each application of
  the shared attention block.  The states keep a flat layer axis (the
  reference's are ``(L / attn_every, attn_every, ...)``: the same layers
  in the same order);
* encdec: ``"self_k"``, ``"self_v" (L, B, max_len, G, hd)`` and
  ``"cross_k"``, ``"cross_v" (L, B, n_frontend_tokens, G, hd)`` bf16.

The head width is 0 where the config has no heads (mamba2).  Decode writes
the cache in place.  A dense, moe or vlm cache can be PQ-compressed
(:mod:`repro_torch.serve.pqkv`).
"""

from __future__ import annotations

from typing import Dict

import torch

from .._device import DeviceArg, resolve_device
from ..models.config import ModelConfig
from ..models.lm import KV_FAMILIES

__all__ = ["init_cache"]


def _kv(n: int, B: int, S: int, G: int, hd: int, dev: torch.device,
        prefix: str = "") -> Dict[str, torch.Tensor]:
    shape = (n, B, S, G, hd)
    return {prefix + name: torch.zeros(shape, dtype=torch.bfloat16,
                                       device=dev) for name in ("k", "v")}


def _ssm_states(cfg: ModelConfig, B: int,
                dev: torch.device) -> Dict[str, torch.Tensor]:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    din, ck, L = cfg.d_inner, cfg.ssm_conv, cfg.n_layers

    def zeros(*shape):
        return torch.zeros((L, B, *shape), dtype=torch.float32, device=dev)

    return {"ssd": zeros(H, P, N), "conv_x": zeros(ck - 1, din),
            "conv_B": zeros(ck - 1, N), "conv_C": zeros(ck - 1, N)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceArg = None) -> Dict[str, torch.Tensor]:
    """Zero-initialised cache for ``serve_step``."""
    dev = resolve_device(device)
    G, hd = cfg.n_kv_heads, (cfg.head_dim_ if cfg.n_heads else 0)
    fam = cfg.family
    if fam in KV_FAMILIES:
        return _kv(cfg.n_layers, batch, max_len, G, hd, dev)
    if fam == "ssm":
        return _ssm_states(cfg, batch, dev)
    if fam == "hybrid":
        cache = _ssm_states(cfg, batch, dev)
        cache.update(_kv(cfg.n_layers // cfg.attn_every, batch, max_len, G,
                         hd, dev, "attn_"))
        return cache
    if fam == "encdec":
        cache = _kv(cfg.n_layers, batch, max_len, G, hd, dev, "self_")
        cache.update(_kv(cfg.n_layers, batch, cfg.n_frontend_tokens, G, hd,
                         dev, "cross_"))
        return cache
    raise ValueError(f"init_cache: unknown family {fam!r}")
