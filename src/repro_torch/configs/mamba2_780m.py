"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,                # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, name="mamba2-780m-reduced", n_layers=2, d_model=64,
    vocab_size=512, ssm_state=16, ssm_head_dim=16)
