"""Model configuration — one dataclass covering every assigned family."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # explicit (gemma2 != d_model/heads)

    # attention flavour
    qkv_bias: bool = False               # qwen2
    rope_theta: float = 1e4
    attn_softcap: float = 0.0            # gemma2 attention-logit softcap
    final_softcap: float = 0.0           # gemma2 final-logit softcap
    sliding_window: int = 0              # gemma2 local layers
    local_global: bool = False           # gemma2 alternating pattern
    mrope: bool = False                  # qwen2-vl multimodal RoPE
    mrope_sections: Tuple[int, ...] = (16, 24, 24)

    # mlp
    act: str = "silu"                    # silu (SwiGLU) | gelu (GeGLU)

    # MoE
    n_experts: int = 0
    n_active_experts: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                    # per-expert hidden (fine-grained)

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0                  # hybrid: shared attn block period

    # encoder-decoder
    n_enc_layers: int = 0

    # modality frontend stub
    frontend: str = "none"               # none | vision | audio
    n_frontend_tokens: int = 0           # patches / audio frames per sample

    # numerics / embedding
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so TP=16 / 32-way sharding always divides."""
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:            # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic context handling (SSM state / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # all assigned archs include a decoder stack

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        dense_mlp = 3 * d * f
        if self.family == "moe":
            moe = 3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
            moe += d * self.n_experts  # router
            block = attn + moe
        elif self.family == "ssm":
            din, N = self.d_inner, self.ssm_state
            H = self.ssm_heads
            block = d * (2 * din + 2 * N + H) + self.ssm_conv * (din + 2 * N) \
                + din * d + 2 * H
        elif self.family == "hybrid":
            din, N = self.d_inner, self.ssm_state
            H = self.ssm_heads
            block = d * (2 * din + 2 * N + H) + self.ssm_conv * (din + 2 * N) \
                + din * d + 2 * H
            n_shared = 1  # weight-tied attention block
            extra = n_shared * (attn + dense_mlp)
            return L * block + extra + self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        else:
            block = attn + dense_mlp
        total = L * block
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn + dense_mlp)
            total += self.n_layers * attn  # cross-attention
        total += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd = self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        moe_active = 3 * d * self.moe_d_ff * (self.n_active_experts +
                                              self.n_shared_experts)
        total = L * (attn + moe_active + d * self.n_experts)
        total += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return total
