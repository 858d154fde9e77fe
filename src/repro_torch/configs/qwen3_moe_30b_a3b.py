"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                 # per-expert hidden size
    moe_d_ff=768,
    vocab_size=151936,
    head_dim=128,
    n_experts=128,
    n_active_experts=8,
    rope_theta=1e6,
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen3-moe-30b-a3b-reduced", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=32, moe_d_ff=32, vocab_size=512,
    head_dim=16, n_experts=8, n_active_experts=2)
