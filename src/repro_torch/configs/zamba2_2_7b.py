"""zamba2-2.7b [hybrid] — Mamba2 backbone + weight-shared attention blocks.
[arXiv:2411.15242; hf]

Simplification recorded in DESIGN.md: the released model interleaves two
alternating shared transformer blocks with LoRA-adapted projections; we
model one weight-tied attention+MLP block applied every ``attn_every``
Mamba2 blocks (same compute/communication shape, fewer bespoke details).
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,              # mamba2 blocks
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,               # shared attention block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,             # shared attn block before every 6 mamba blocks
)

REDUCED = dataclasses.replace(
    CONFIG, name="zamba2-2.7b-reduced", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16,
    attn_every=2)
