"""minitron-8b [dense] — width-pruned nemotron. [arXiv:2407.14679; hf]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
)

REDUCED = dataclasses.replace(
    CONFIG, name="minitron-8b-reduced", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16)
