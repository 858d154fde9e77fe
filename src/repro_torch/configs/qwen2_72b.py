"""qwen2-72b [dense] — GQA, QKV bias. [arXiv:2407.10671; hf]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)

# Same family, laptop-scale — used by the per-arch smoke tests.
REDUCED = dataclasses.replace(
    CONFIG, name="qwen2-72b-reduced", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512)
