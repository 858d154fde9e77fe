"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

The vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings ``(B, n_frontend_tokens, d_model)`` which the
backbone consumes at the start of the sequence with M-RoPE (t, h, w)
position ids.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    mrope=True,
    mrope_sections=(16, 24, 24),
    frontend="vision",
    n_frontend_tokens=256,    # patch embeddings per sample (stub)
)

REDUCED = dataclasses.replace(
    CONFIG, name="qwen2-vl-72b-reduced", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, mrope_sections=(4, 6, 6),
    n_frontend_tokens=8)
