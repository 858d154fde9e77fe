"""KV cache construction (counterpart of :mod:`repro.serve.cache`).

A cache is a dict of bf16 tensors with a leading layer axis,
``{"k", "v"}: (L, B, max_len, G, hd)``, the same layout for the dense
(gemma2's local and global layers alike), moe and vlm families, as the
reference's ``init_cache`` gives them.  Decode writes it in place.  A
cache can be PQ-compressed (:mod:`repro_torch.serve.pqkv`).
"""

from __future__ import annotations

from typing import Dict

import torch

from .._device import DeviceArg, resolve_device
from ..models.config import ModelConfig
from ..models.lm import check_supported

__all__ = ["init_cache"]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceArg = None) -> Dict[str, torch.Tensor]:
    """Zero-initialised cache for ``serve_step``."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}
