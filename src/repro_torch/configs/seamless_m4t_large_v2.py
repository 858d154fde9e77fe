"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.
[arXiv:2308.11596; hf]

The speech frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings ``(B, n_frontend_tokens, d_model)``.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,              # decoder
    n_enc_layers=24,          # encoder
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio",
    n_frontend_tokens=1024,   # precomputed speech frames per sample
)

REDUCED = dataclasses.replace(
    CONFIG, name="seamless-m4t-large-v2-reduced", n_layers=2, n_enc_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    n_frontend_tokens=16)
