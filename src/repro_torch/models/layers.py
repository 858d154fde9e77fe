"""Transformer building blocks (counterpart of :mod:`repro.models.layers`):
norms, RoPE and M-RoPE, attention (causal with an optional sliding
window, bidirectional, or across to another sequence), the dense MLP and
the top-k routed experts.

Numerics follow the reference op by op, because its values are what the
port is held to:

* every weight product is bf16 x bf16 accumulated in float32 and rounded
  once to bf16 (:func:`_dot`); a bias is added to that in float32 and the
  sum rounded again.  The SSM projections keep the float32 sum
  (:func:`_dot_f32`);
* attention scores are the bf16 operands' products summed in float32
  (bf16 values are exact in float32, so a float32 product of the upcast
  operands is the same sum), softmax runs on float32 scores, and the
  probabilities are rounded to bf16 before the value product;
* ``rms_norm`` reduces in float32 and multiplies in the input dtype, one
  rounding per op;
* RoPE tables: the frequencies are ``theta ** -(t / half)`` rounded once
  from float64 (the reference's ``pow`` is correctly rounded, and it turns
  ``/ half`` into ``* (1 / half)``); ``cos`` and ``sin`` are float64
  rounded to float32.  The reference's compiler approximates ``cos`` and
  ``sin``, one float32 ulp off the correctly rounded value on some table
  entries, which stays below a bf16 ulp of the rotated activations almost
  always.  M-RoPE's sectioned tables (:func:`_mrope_tables`) take the
  same frequencies and float32 angles, and pick each frequency's angle
  from its section's position axis;
* the experts (:func:`moe`): float32 routing on bf16-rounded router
  logits, top-k by a stable descending sort (the reference's ``top_k``
  keeps the lower index first on ties), float32 gate and up products,
  a bf16 down product, and the bf16 combine summed expert by expert in
  the reference's update order (:func:`_combine`).

Parameters are NamedTuples of tensors with the reference's field names;
weight matrices and norm scales may be stored in bf16 (every use in the
reference casts them to bf16 first), biases stay float32 (the reference
adds them in float32).  Training passes the bf16 copy of its float32
masters that the reference's train step makes (biases included), and
differentiates through these functions: each in-place write here
(``masked_fill_`` on fresh scores, the routing matrix's ``scatter_``,
the combine's ``index_add_`` into fresh zeros) leaves autograd the
reference's gradient.  Attention activations keep the GQA layout
``(B, S, G, R, hd)``.  The reference's sharding hints are
:mod:`repro_torch.sharding.partition`'s ``constrain_*`` calls (the
identity without a mesh); ops on a mesh are :mod:`.spmd`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..sharding.partition import is_dtensor
from .config import ModelConfig

__all__ = ["rms_norm", "softcap", "rotary", "apply_rope", "mrope_positions",
           "AttnParams", "init_attn", "attention", "attention_decode",
           "MlpParams", "init_mlp", "mlp", "MoeParams", "init_moe", "moe",
           "moe_capacity", "top_k", "normal_weight", "remat_call"]

_NEG_INF = -2.0e38
BF16 = torch.bfloat16


def remat_call(fn, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``fn(x)``; with ``remat`` and a graph to record (``x`` requires
    grad), under ``torch.utils.checkpoint`` (non-reentrant), so only ``x``
    is kept for the backward pass and ``fn`` runs again there (the
    reference's ``jax.checkpoint`` on its scanned bodies).  Serving, whose
    activations need no grad, calls ``fn`` as it is."""
    if remat and x.requires_grad:
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


# ---------------------------------------------------------------------------
# Norms / activations / rope
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm: float32 variance, then ``x * inv * (1 + scale)`` in the
    input dtype, rounded after every op as the reference is."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale.to(x.dtype))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: ``cap * tanh(x / cap)``."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def _freqs(half: int, theta: float, device) -> torch.Tensor:
    """``theta ** -(t / half)`` for ``t < half``, float32 rounded once."""
    expo = -(torch.arange(half, dtype=torch.float32, device=device)
             * torch.tensor(1.0 / half, dtype=torch.float32))
    base = torch.tensor(theta, dtype=torch.float32).double()
    return torch.pow(base, expo.double()).float()


def _cos_sin(ang: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 angles -> their cos and sin, float64 rounded to float32."""
    ang = ang.double()
    return torch.cos(ang).float(), torch.sin(ang).float()


def rotary(positions: torch.Tensor, head_dim: int, theta: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: ``positions (..., S)`` -> ``(..., S, hd/2)`` each."""
    freqs = _freqs(head_dim // 2, theta, positions.device)
    return _cos_sin(positions.float()[..., None] * freqs)


def mrope_positions(text_positions: torch.Tensor, n_frontend: int,
                    sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL M-RoPE position ids ``(3, B, S)`` for (t, h, w): the first
    ``n_frontend`` positions are vision patches on a square (h, w) grid at
    t = 0; text positions advance all three equally."""
    B, S = text_positions.shape
    side = max(1, int(n_frontend ** 0.5))
    pos = text_positions
    idx = torch.arange(S, device=pos.device)
    is_patch = (idx < n_frontend)[None, :]
    t = torch.where(is_patch, torch.zeros_like(pos), pos)
    h = torch.where(is_patch, (idx // side)[None, :].to(pos.dtype), pos)
    w = torch.where(is_patch, (idx % side)[None, :].to(pos.dtype), pos)
    return torch.stack([t, h, w])


def _mrope_tables(mpos: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sectioned rope tables from ``mpos (3, B, S)`` -> ``(B, S, hd/2)``:
    frequency ``t`` takes the angle of the axis whose section holds it
    (sections past ``hd/2`` are cut, an index past them takes axis 2)."""
    half = head_dim // 2
    dev = mpos.device
    ang = mpos.float()[..., None] * _freqs(half, theta, dev)  # 3,B,S,half
    bounds = torch.cumsum(torch.tensor(tuple(sections), device=dev), 0)
    which = torch.searchsorted(bounds, torch.arange(half, device=dev),
                               right=True).clamp(0, 2)
    picked = torch.gather(ang, 0, which.expand(1, *ang.shape[1:]))[0]
    return _cos_sin(picked)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """``x (B, S, ..., hd)`` rotated by position tables ``(B, S, hd/2)``."""
    half = x.shape[-1] // 2
    for _ in range(x.dim() - cos.dim()):
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    xf1 = x[..., :half].float()
    xf2 = x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class AttnParams(NamedTuple):
    wq: torch.Tensor            # (d, H*hd)
    wk: torch.Tensor            # (d, G*hd)
    wv: torch.Tensor            # (d, G*hd)
    wo: torch.Tensor            # (H*hd, d)
    bq: Optional[torch.Tensor]  # (H*hd,) float32 or None
    bk: Optional[torch.Tensor]
    bv: Optional[torch.Tensor]


def normal_weight(generator: torch.Generator, shape, device: torch.device,
                  dtype: torch.dtype = BF16) -> torch.Tensor:
    """``N(0, 1) * 0.02`` drawn in float32 on the generator's device, as
    the reference's initialiser, stored in ``dtype`` on ``device``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device).mul_(0.02)
    return w.to(device=device, dtype=dtype)


def init_attn(generator: torch.Generator, cfg: ModelConfig,
              device: torch.device, dtype: torch.dtype = BF16) -> AttnParams:
    d = cfg.d_model
    hd, H, G = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads

    def bias(n):
        return (torch.zeros(n, dtype=torch.float32, device=device)
                if cfg.qkv_bias else None)

    return AttnParams(
        wq=normal_weight(generator, (d, H * hd), device, dtype),
        wk=normal_weight(generator, (d, G * hd), device, dtype),
        wv=normal_weight(generator, (d, G * hd), device, dtype),
        wo=normal_weight(generator, (H * hd, d), device, dtype),
        bq=bias(H * hd), bk=bias(G * hd), bv=bias(G * hd))


def _dot(x: torch.Tensor, w: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16 product, float32 accumulation, one rounding to bf16 (the
    reference's ``preferred_element_type=bf16``).  A float32 bias is added
    to that bf16 result in float32 (the reference's type promotion), and
    the sum is rounded to bf16 again."""
    y = torch.matmul(x.to(BF16), w.to(BF16))
    if bias is not None:
        y = (y.float() + bias).to(BF16)
    return y


class _MmF32(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=float32)`` of bf16 ``x (n, d)`` and ``w
    (d, e)`` with the reference's gradient (cuBLAS has no derivative for
    that overload).  The reference's transpose of a ``preferred_element_
    type=float32`` product contracts the float32 cotangent with the other
    bf16 operand in float32 and rounds the result to the operand's bf16;
    so does this backward (TF32 is off: full float32 products)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(g, w.float().T).to(BF16)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(x.float().T, g).to(BF16)
        return gx, gw


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 product with a float32 result (the reference's
    ``preferred_element_type=float32``, as its SSM projections take it):
    ``x (..., d) @ w (d, e)``, no rounding to bf16.  On the card a cuBLAS
    bf16 GEMM writes float32 (``torch.mm(..., out_dtype=float32)``, no
    float32 copy of the weights; :class:`_MmF32` gives it the reference's
    gradient).  On the CPU, whose ``matmul`` of bf16 tensors returns bf16,
    the bf16-rounded operands are upcast and multiplied in float32; TF32
    is off, so those products are exact, and autograd's gradient of that
    form is the reference's too.  Meta tensors take the card's form, so a
    cost pass on them counts the card's bf16 product."""
    xb, wb = x.to(BF16), w.to(BF16)
    if is_dtensor(xb):
        from .spmd import mm_f32_mesh
        y = mm_f32_mesh(xb.reshape(-1, xb.shape[-1]), wb)
        return y.reshape(*xb.shape[:-1], wb.shape[-1])
    if xb.is_cuda or xb.is_meta:
        y = _MmF32.apply(xb.reshape(-1, xb.shape[-1]), wb)
        return y.reshape(*xb.shape[:-1], wb.shape[-1])
    return torch.matmul(xb.float(), wb.float())


def _qkv(p: AttnParams, cfg: ModelConfig, x: torch.Tensor, cos, sin):
    B, S, _ = x.shape
    hd, H, G = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    R = H // G
    q = _dot(x, p.wq, p.bq).reshape(B, S, G, R, hd)
    k = _dot(x, p.wk, p.bk).reshape(B, S, G, hd)
    v = _dot(x, p.wv, p.bv).reshape(B, S, G, hd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _attend_block(q_blk: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, cap: float, mask: torch.Tensor,
                  reduce=None) -> torch.Tensor:
    """``q_blk (B, Qc, G, R, hd)``, ``k/v (B, S, G, hd)``, ``mask (Qc, S)``
    or ``(B, Qc, S)`` -> ``(B, Qc, G, R, hd)``.  With ``reduce(t, op)``
    (``op`` ``"max"`` or ``"sum"`` over the ranks that hold the rest of a
    sequence split along ``S``) the softmax takes the global maximum and
    denominator, and the ranks' float32 weighted values are summed before
    the one rounding to bf16."""
    scores = torch.einsum("bqgrh,bkgh->bgrqk", q_blk.to(BF16).float(),
                          k.to(BF16).float()) * scale
    scores = softcap(scores, cap)
    mask_b = mask[None, None, None] if mask.dim() == 2 else mask[:, None, None]
    scores.masked_fill_(~mask_b, _NEG_INF)
    if reduce is None:
        p = torch.softmax(scores, dim=-1).to(BF16)
        del scores
        return torch.einsum("bgrqk,bkgh->bqgrh", p, v.to(BF16))
    e = torch.exp(scores - reduce(scores.amax(dim=-1, keepdim=True), "max"))
    p = (e / reduce(e.sum(dim=-1, keepdim=True), "sum")).to(BF16)
    o = torch.einsum("bgrqk,bkgh->bqgrh", p.float(), v.to(BF16).float())
    return reduce(o, "sum").to(BF16)


def attention(p: AttnParams, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: int = 0, q_chunk: int = 512,
              cos_sin: Optional[Tuple] = None,
              kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (prefill, the encoder), query-chunked: each
    chunk of ``q_chunk`` queries attends to all keys under the mask, so one
    chunk's float32 scores ``(B, G, R, q_chunk, Sk)`` are the largest
    transient.  ``causal=False`` lets every query see every key (the
    encoder); under ``causal``, ``window > 0`` keeps only the last
    ``window`` keys of each query (gemma2's local layers).  ``kv=(k, v)``
    passes keys and values ``(B, Sk, G, hd)`` taken as they are: prefill's
    own (roped keys, to fill its cache), or another sequence's for
    cross-attention (no rope; the reference's ``kv_override``), whose
    ``kv_mask (B, Sk)`` says which keys a query may see.  Rope applies to
    the queries only then.  On a mesh (a ``DTensor`` ``x``) each rank
    attends with its own heads (:mod:`.spmd`)."""
    if is_dtensor(x):
        from .spmd import attention_mesh
        return attention_mesh(p, cfg, x, positions, causal=causal,
                              window=window, q_chunk=q_chunk,
                              cos_sin=cos_sin, kv=kv, kv_mask=kv_mask)
    B, S, _ = x.shape
    hd = cfg.head_dim_
    scale = hd ** -0.5
    if cos_sin is None:
        cos_sin = rotary(positions, hd, cfg.rope_theta)
    cos, sin = cos_sin
    if kv is None:
        q, k, v = _qkv(p, cfg, x, cos, sin)
    else:
        G = cfg.n_kv_heads
        q = _dot(x, p.wq, p.bq).reshape(B, S, G, cfg.n_heads // G, hd)
        q = apply_rope(q, cos, sin)
        k, v = kv
    out = _attend_chunks(q, k, v, causal=causal, window=window,
                         q_chunk=q_chunk, scale=scale, cap=cfg.attn_softcap,
                         kv_mask=kv_mask)
    return _dot(out.reshape(B, S, cfg.n_heads * hd), p.wo)


def _attend_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int, q_chunk: int, scale: float,
                   cap: float, kv_mask: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """:func:`attention`'s core on roped ``q (B, S, G, R, hd)`` and ``k,
    v (B, Sk, G, hd)``: each chunk of queries against every key under
    the mask -> ``(B, S, G, R, hd)``."""
    S, Sk = q.shape[1], k.shape[1]
    dev = q.device
    nc = S // q_chunk if (S % q_chunk == 0 and S > q_chunk) else 1
    qc = S // nc
    kpos = torch.arange(Sk, device=dev)
    outs = []
    for c in range(nc):
        qpos = c * qc + torch.arange(qc, device=dev)
        if causal:
            mask = kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
        else:
            mask = torch.ones((qc, Sk), dtype=torch.bool, device=dev)
        if kv_mask is not None:
            mask = mask[None] & kv_mask[:, None, :]
        outs.append(_attend_block(q[:, c * qc:(c + 1) * qc], k, v,
                                  scale=scale, cap=cap, mask=mask))
    return torch.cat(outs, dim=1) if nc > 1 else outs[0]


def attention_decode(p: AttnParams, cfg: ModelConfig, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: int, *, window: int = 0, update_cache: bool = True,
                     cos_sin: Optional[Tuple] = None) -> torch.Tensor:
    """One-token decode: ``x (B, 1, d)``; caches ``(B, Smax, G, hd)``,
    written at ``pos`` in place (the reference's one-hot select exists only
    for its sharded cache); ``update_cache=False`` reads them without
    writing (cross-attention decode); ``window > 0`` attends to the last
    ``window`` positions only.  Returns ``out (B, 1, d)``.  On a mesh (a
    ``DTensor`` ``x``) a cache split along its sequence over ``model``
    is scored shard by shard and merged (:mod:`.spmd`)."""
    if is_dtensor(x):
        from .spmd import attention_decode_mesh
        return attention_decode_mesh(p, cfg, x, k_cache, v_cache, pos,
                                     window=window,
                                     update_cache=update_cache,
                                     cos_sin=cos_sin)
    B = x.shape[0]
    if cos_sin is None:
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        cos_sin = rotary(positions, cfg.head_dim_, cfg.rope_theta)
    k2 = v2 = None
    if update_cache:
        k2, v2 = _dot(x, p.wk, p.bk), _dot(x, p.wv, p.bv)
    out = _decode_attend(cfg, _dot(x, p.wq, p.bq), k2, v2, cos_sin, k_cache,
                         v_cache, pos, window=window)
    return _dot(out, p.wo)


def _decode_attend(cfg: ModelConfig, q2: torch.Tensor,
                   k2: Optional[torch.Tensor], v2: Optional[torch.Tensor],
                   cos_sin: Tuple, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, pos: int, *, window: int,
                   s0: int = 0, reduce=None) -> torch.Tensor:
    """:func:`attention_decode`'s core on the step's projections ``q2 (B,
    1, H hd)``, ``k2`` / ``v2 (B, 1, G hd)`` (``None``: no cache write):
    rope, write the caches at ``pos``, attend -> ``(B, 1, H hd)``.  On a
    mesh the caches hold positions ``[s0, s0 + S)`` of a sequence split
    over the ranks that ``reduce`` combines (:func:`_attend_block`), and a
    rank writes ``pos`` only where it holds it."""
    B = q2.shape[0]
    hd, H, G = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    S = k_cache.shape[1]
    cos, sin = cos_sin
    q = apply_rope(q2.reshape(B, 1, G, H // G, hd), cos, sin)
    if k2 is not None and (reduce is None or s0 <= pos < s0 + S):
        k_new = apply_rope(k2.reshape(B, 1, G, hd), cos, sin)
        k_cache[:, pos - s0] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, pos - s0] = v2.reshape(B, G, hd).to(v_cache.dtype)
    kpos = torch.arange(s0, s0 + S, device=q.device)
    mask = kpos <= pos
    if window > 0:
        mask &= kpos > pos - window
    out = _attend_block(q, k_cache, v_cache, scale=hd ** -0.5,
                        cap=cfg.attn_softcap, mask=mask[None, :],
                        reduce=reduce)
    return out.reshape(B, 1, H * hd)


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

class MlpParams(NamedTuple):
    w_gate: torch.Tensor   # (d, f)
    w_up: torch.Tensor     # (d, f)
    w_down: torch.Tensor   # (f, d)


def init_mlp(generator: torch.Generator, d: int, f: int,
             device: torch.device, dtype: torch.dtype = BF16) -> MlpParams:
    return MlpParams(w_gate=normal_weight(generator, (d, f), device, dtype),
                     w_up=normal_weight(generator, (d, f), device, dtype),
                     w_down=normal_weight(generator, (f, d), device, dtype))


def mlp(p: MlpParams, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = _act(_dot(x, p.w_gate).float(), act).to(BF16)
    u = _dot(x, p.w_up)
    return _dot(g * u, p.w_down)


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k routing, capacity drop, optional shared experts)
# ---------------------------------------------------------------------------

class MoeParams(NamedTuple):
    router: torch.Tensor             # (d, E)
    we_gate: torch.Tensor            # (E, d, f)
    we_up: torch.Tensor              # (E, d, f)
    we_down: torch.Tensor            # (E, f, d)
    shared: Optional[MlpParams]      # fused shared experts or None


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             device: torch.device, dtype: torch.dtype = BF16) -> MoeParams:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    shared = (init_mlp(generator, d, f * cfg.n_shared_experts, device, dtype)
              if cfg.n_shared_experts else None)

    def w(*shape):
        return normal_weight(generator, shape, device, dtype)

    return MoeParams(router=w(d, E), we_gate=w(E, d, f), we_up=w(E, d, f),
                     we_down=w(E, f, d), shared=shared)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, the
    lower index first among equal values (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: ModelConfig, tokens: int,
                 capacity_factor: float = 1.25) -> int:
    """Tokens an expert takes at most: the reference's formula, Python's
    float floor division included, at least 8 and at most ``tokens``."""
    k, E = cfg.n_active_experts, cfg.n_experts
    C = max(8, int(-(-k * tokens * capacity_factor // E) // 8 * 8))
    return min(C, tokens)


def _combine(y: torch.Tensor, tok_ec: torch.Tensor, T: int) -> torch.Tensor:
    """``out[tok_ec[e, c]] += y[e, c]`` in bf16, one expert after another
    (the reference's scatter-add, which rounds after every add in update
    order).  An expert's token ids are distinct, so each ``index_add_``
    adds one term to a row, with no atomics racing on the card."""
    out = torch.zeros((T, y.shape[-1]), dtype=BF16, device=y.device)
    for e in range(y.shape[0]):
        out.index_add_(0, tok_ec[e], y[e])
    return out


def moe(p: MoeParams, cfg: ModelConfig, x: torch.Tensor,
        capacity_factor: float = 1.25, *, stats: Optional[dict] = None,
        routing: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-k routed experts with a static per-expert capacity ``C``
    (:func:`moe_capacity`): each expert takes the ``C`` tokens with the
    largest routing weight (zero-weight tokens fill what is left), runs
    its SwiGLU/GeGLU on them, and the weighted outputs are summed back per
    token.  ``stats``, if given, receives the tokens routed to each expert
    (``routed``), the routed (token, expert) pairs dropped by capacity
    (``dropped``), each token's ``k`` experts (``top_i``, ``(T, k)``) and
    ``tok_ec``, the ``(E, C)`` token ids taken.  ``routing (T, k)``, if
    given, are the experts each token takes in place of the router's top
    ``k`` (weighted by the router's probabilities there): it holds two
    computations of the same tokens to the same experts, where bf16
    router logits an ulp apart would pick differently."""
    if is_dtensor(x):
        if stats is not None or routing is not None:
            raise NotImplementedError("moe on a mesh takes no stats or "
                                      "pinned routing")
        from .spmd import moe_mesh
        return moe_mesh(p, cfg, x, capacity_factor)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_active_experts
    T = B * S
    xf = x.reshape(T, d)
    logits = _dot(xf, p.router).float()                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    if routing is None:
        top_w, top_i = top_k(probs, k)                       # (T, k)
    else:
        top_i = routing.reshape(T, k).to(device=x.device, dtype=torch.int64)
        top_w = torch.gather(probs, 1, top_i)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    W = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    W.scatter_(1, top_i, top_w)
    C = moe_capacity(cfg, T, capacity_factor)
    w_ec, tok_ec = top_k(W.T, C)                             # (E, C) each
    if stats is not None:
        routed = torch.zeros(E, dtype=torch.int64, device=x.device)
        routed.scatter_add_(0, top_i.reshape(-1),
                            torch.ones_like(top_i.reshape(-1)))
        kept = (w_ec > 0).sum(dim=1)
        # repro: ignore[RS101] routing statistics, only when asked for
        stats.update(routed=routed, dropped=int((routed - kept).sum()),
                     top_i=top_i, tok_ec=tok_ec)
    xg = xf[tok_ec.reshape(-1)].reshape(E, C, d).to(BF16).float()
    g = torch.bmm(xg, p.we_gate.to(BF16).float())           # float32 sums
    u = torch.bmm(xg, p.we_up.to(BF16).float())
    h = (_act(g, cfg.act) * u).to(BF16)
    y = torch.bmm(h, p.we_down.to(BF16))                     # bf16 (E, C, d)
    y = y * w_ec[..., None].to(BF16)
    out = _combine(y, tok_ec, T)
    if p.shared is not None:
        out = out + mlp(p.shared, xf.to(BF16), cfg.act)
    return out.reshape(B, S, d)
