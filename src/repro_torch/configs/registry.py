"""Architecture registry: ``--arch <id>`` -> (full config, reduced config).

Shape sets (assignment): every LM arch is paired with
    train_4k      seq 4096,   batch 256   (train_step)
    prefill_32k   seq 32768,  batch 32    (prefill forward)
    decode_32k    seq 32768,  batch 128   (serve_step, KV cache 32k)
    long_500k     seq 524288, batch 1     (serve_step; SSM/hybrid only)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

from . import (deepseek_moe_16b, gemma2_27b, internlm2_1_8b, mamba2_780m,
               minitron_8b, qwen2_72b, qwen2_vl_72b, qwen3_moe_30b_a3b,
               seamless_m4t_large_v2, zamba2_2_7b)

_MODULES = {
    "qwen2-72b": qwen2_72b,
    "gemma2-27b": gemma2_27b,
    "minitron-8b": minitron_8b,
    "internlm2-1.8b": internlm2_1_8b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "zamba2-2.7b": zamba2_2_7b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "mamba2-780m": mamba2_780m,
}

ARCH_IDS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _MODULES[arch].REDUCED


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Which (arch x shape) cells run (skips recorded in DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k context needs "
                       "sub-quadratic attention (DESIGN.md §5)")
    return True, ""


def all_cells():
    """All 40 (arch, shape) cells with applicability flags."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            yield arch, shape, ok, why
