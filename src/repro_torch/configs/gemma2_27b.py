"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    act="gelu",
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global=True,
    tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, name="gemma2-27b-reduced", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, sliding_window=32)
