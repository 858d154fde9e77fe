"""PQ-compressed KV cache (counterpart of :mod:`repro.serve.pqkv`): the
paper's technique as a serving feature.

The KV cache is a database of key vectors and decode attention is a
similarity search of the query against it, so the paper's machinery maps
onto it one to one:

  codebook training   -> per-(layer, kv-group, subspace) Euclidean k-means
                         over observed keys (``fit_kv_books``), batched
                         over all fits;
  encoding            -> every cached key becomes M uint8 codes
                         (``encode_kv``);
  asymmetric distance -> the decode query builds one small table per layer
                         and every cached position's score is M table
                         look-ups (the ``pq_attn`` kernel);
  filter-then-refine  -> the last W positions keep their exact keys in a
                         ring, and attention over them is exact.

Dense family, ``mode="softmax"``, exact values.  ``mode="topk"`` and
``quantize_v=True`` raise ``NotImplementedError`` (not ported yet), as do
the other families and gemma2-style local windows.

Decode attention has two routes over the same cache:

* ``"plain"``: the reference's arithmetic step by step (a bf16 query
  table, its entries gathered and summed in float32, one softmax over the
  ADC tail and the exact ring, the bf16 value product);
* ``"kernel"``: the ``pq_attn`` kernel over the tail (the prefix of
  ``max(pos - W + 1, 0)`` positions that lie before the ring) with the same
  bf16 table, uint8 codes and bf16 values, then the ring's exact softmax
  piece merged through the kernel's running max and denominator.  It
  agrees with the plain route at bf16 tolerance (the online softmax
  rescales in another order, and the value product is not rounded to bf16
  first).

The cache is updated in place at each decode step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .._device import DeviceArg, resolve_device
from ..kernels.pq_attn.ops import pq_attn
from ..models.config import ModelConfig
from ..models.layers import _dot, apply_rope, mlp, rms_norm
from ..models.lm import (LmParams, check_supported, embed_tokens,
                         logits_from_hidden)
from .decode import decode_cos_sin

__all__ = ["PQKVConfig", "PQKVCache", "fit_kv_books", "kmeans_batched",
           "encode_kv", "decode_kv", "init_pq_cache", "compress_cache",
           "pq_attention_decode", "pq_serve_step", "pqkv_memory"]

_NEG_INF = -1e30
BF16 = torch.bfloat16
# k-means fits run in groups whose (fits, tokens, K) float32 distance
# block stays under this many bytes
FIT_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class PQKVConfig:
    """Serving-time PQ configuration (paper §3.4 semantics)."""
    n_sub: int = 8              # M subspaces along head_dim
    codebook_size: int = 256    # K (uint8 codes: K <= 256)
    recent_window: int = 128    # W, the exact ring (refinement window)
    mode: str = "softmax"       # "softmax" (dense ADC); "topk" unported
    quantize_v: bool = False    # PQ the values too (unported)
    kmeans_iters: int = 12
    fit_sample: int = 4096      # max tokens sampled per (layer, group) fit

    def __post_init__(self):
        if self.mode == "topk":
            raise NotImplementedError("PQ-KV mode='topk' is not ported")
        if self.mode != "softmax":
            raise ValueError(f"unknown PQ-KV mode {self.mode!r}")
        if self.quantize_v:
            raise NotImplementedError("PQ-KV quantize_v=True is not ported")
        if not 1 <= self.codebook_size <= 256:
            raise ValueError("codebook_size must be in [1, 256] (uint8 "
                             "codes)")


class PQKVCache(NamedTuple):
    """Layer-stacked compressed cache (``layer(i)`` gives one layer's
    views, the form :func:`pq_attention_decode` takes)."""
    k_codes: torch.Tensor       # (L, B, Smax, G, M) uint8
    k_books: torch.Tensor       # (L, G, M, K, hd/M) float32
    v: torch.Tensor             # (L, B, Smax, G, hd) bf16
    k_recent: torch.Tensor      # (L, B, W, G, hd) bf16 exact ring
    v_recent: torch.Tensor      # (L, B, W, G, hd) bf16 exact ring

    def layer(self, i: int) -> "PQKVCache":
        return PQKVCache(*(t[i] for t in self))


# ---------------------------------------------------------------------------
# Codebook fitting / encoding
# ---------------------------------------------------------------------------

def kmeans_batched(X: torch.Tensor, init: torch.Tensor,
                   iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means of many independent fits at once: ``X (F, N, D)``
    from ``init (F, K, D)`` -> ``(centroids (F, K, D), inertia (F,))``.
    Each fit is :func:`repro_torch.core.kmeans.euclidean_kmeans` from the
    same initial centroids, written over a leading fit axis (the same
    products, sums and tie order)."""
    X = X.float()
    C = init.float().clone()
    K = C.shape[1]
    a2 = (X * X).sum(-1)[:, :, None]

    def dist(C):
        b2 = (C * C).sum(-1)[:, None, :]
        return torch.clamp(a2 + b2 - 2.0 * torch.bmm(X, C.transpose(1, 2)),
                           min=0.0)

    d = dist(C)
    for _ in range(iters):
        d = dist(C)
        oh = torch.nn.functional.one_hot(d.argmin(dim=2), K).float()
        count = oh.sum(1)[:, :, None]
        mean = torch.bmm(oh.transpose(1, 2), X) / torch.clamp(count, min=1e-9)
        C = torch.where(count > 0, mean, C)
    return C, d.min(dim=2).values.sum(dim=1)


def _draw(n: int, k: int, generator: torch.Generator) -> torch.Tensor:
    """``k`` of ``n`` indices, without replacement when ``n >= k``."""
    if n >= k:
        return torch.randperm(n, generator=generator,
                              device=generator.device)[:k]
    return torch.randint(n, (k,), generator=generator,
                         device=generator.device)


def fit_kv_books(kv: torch.Tensor, pqc: PQKVConfig,
                 generator: torch.Generator,
                 valid_len: Optional[int] = None) -> torch.Tensor:
    """Fit codebooks from observed keys: ``kv (L, B, S, G, hd)`` -> books
    ``(L, G, M, K, hd/M)`` float32.

    Per (layer, group), ``fit_sample`` of its ``B * valid_len`` tokens are
    drawn without replacement; each subspace of each (layer, group) is one
    k-means fit from ``K`` of those tokens.  All ``L * G * M`` fits run
    batched (:func:`kmeans_batched`), in groups under
    :data:`FIT_CHUNK_BYTES`.  The draws come from ``generator`` (the
    reference's ``jax.random`` draws cannot be reproduced)."""
    L, B, S, G, hd = kv.shape
    M, K = pqc.n_sub, pqc.codebook_size
    Ds = hd // M
    S_eff = S if valid_len is None else int(valid_len)
    T = B * S_eff
    n = min(pqc.fit_sample, T)
    tok = torch.stack([torch.stack([_draw(T, n, generator)
                                    for _ in range(G)]) for _ in range(L)])
    init_idx = torch.stack([_draw(n, K, generator)
                            for _ in range(L * G * M)])
    dev = kv.device
    tok = tok.to(dev)
    l_ar = torch.arange(L, device=dev)[:, None, None]
    g_ar = torch.arange(G, device=dev)[None, :, None]
    sample = kv[l_ar, tok // S_eff, tok % S_eff, g_ar].float()   # L,G,n,hd
    X = sample.reshape(L, G, n, M, Ds).permute(0, 1, 3, 2, 4)
    X = X.reshape(L * G * M, n, Ds)
    init = torch.gather(X, 1, init_idx.to(dev)[:, :, None].expand(-1, -1, Ds))
    step = max(1, FIT_CHUNK_BYTES // (n * K * 4))
    books = torch.cat([kmeans_batched(X[i:i + step], init[i:i + step],
                                      pqc.kmeans_iters)[0]
                       for i in range(0, X.shape[0], step)])
    return books.reshape(L, G, M, K, Ds)


def encode_kv(kv: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """``kv (..., G, hd)``, books ``(G, M, K, Ds)`` -> uint8 codes
    ``(..., G, M)``: the nearest codeword per subspace, first on ties."""
    G, M, K, Ds = books.shape
    lead = kv.shape[:-2]
    x = kv.float().reshape(*lead, G, M, Ds)
    d2 = ((x * x).sum(-1)[..., None]
          - 2.0 * torch.einsum("...gmd,gmkd->...gmk", x, books)
          + (books * books).sum(-1))
    return torch.argmin(d2, dim=-1).to(torch.uint8)


def decode_kv(codes: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_kv` (reconstruction): codes ``(..., G, M)``
    -> ``(..., G, M * Ds)``."""
    G, M, K, Ds = books.shape
    g_idx = torch.arange(G, device=codes.device)[:, None]
    m_idx = torch.arange(M, device=codes.device)[None, :]
    return books[g_idx, m_idx, codes.long()].reshape(
        *codes.shape[:-1], M * Ds)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def init_pq_cache(cfg: ModelConfig, pqc: PQKVConfig, batch: int,
                  max_len: int, books: torch.Tensor,
                  device: DeviceArg = None) -> PQKVCache:
    """Empty compressed cache around pre-fit ``books``."""
    check_supported(cfg)
    dev = resolve_device(device)
    L, G, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    W = pqc.recent_window
    return PQKVCache(
        k_codes=torch.zeros((L, batch, max_len, G, pqc.n_sub),
                            dtype=torch.uint8, device=dev),
        k_books=books.to(dev, torch.float32),
        v=torch.zeros((L, batch, max_len, G, hd), dtype=BF16, device=dev),
        k_recent=torch.zeros((L, batch, W, G, hd), dtype=BF16, device=dev),
        v_recent=torch.zeros((L, batch, W, G, hd), dtype=BF16, device=dev))


def compress_cache(cache: Dict[str, torch.Tensor], cfg: ModelConfig,
                   pqc: PQKVConfig, pos: int,
                   generator: Optional[torch.Generator] = None,
                   books: Optional[torch.Tensor] = None) -> PQKVCache:
    """Compress an exact prefill cache ``{k, v}`` into a
    :class:`PQKVCache`: fit key codebooks on the first ``pos`` entries
    (from ``generator``) unless pre-fit ``books (L, G, M, K, Ds)`` are
    given, encode every cached key, and seed the exact ring with the last W
    tokens (ring slot ``p % W``).  The PQ cache takes ``cache["v"]``
    itself: copy it first if the exact cache goes on decoding."""
    check_supported(cfg)
    k_cache, v_cache = cache["k"], cache["v"]
    L, B, Smax, G, hd = k_cache.shape
    W = pqc.recent_window
    if books is None:
        if generator is None:
            raise ValueError("pass a torch.Generator (generator=) to fit "
                             "the codebooks, or pre-fit books (books=)")
        books = fit_kv_books(k_cache, pqc, generator, valid_len=pos)
    books = books.to(k_cache.device, torch.float32)
    codes = torch.empty((L, B, Smax, G, pqc.n_sub), dtype=torch.uint8,
                        device=k_cache.device)
    for layer in range(L):
        for b in range(B):
            codes[layer, b] = encode_kv(k_cache[layer, b], books[layer])
    take = torch.arange(W, device=k_cache.device)
    ring_pos = (pos - W + take) % Smax                # absolute positions
    slot = ((pos - W + take) % W + W) % W
    k_ring = torch.zeros((L, B, W, G, hd), dtype=BF16, device=k_cache.device)
    v_ring = torch.zeros_like(k_ring)
    k_ring[:, :, slot] = k_cache[:, :, ring_pos].to(BF16)
    v_ring[:, :, slot] = v_cache[:, :, ring_pos].to(BF16)
    return PQKVCache(k_codes=codes, k_books=books, v=v_cache,
                     k_recent=k_ring, v_recent=v_ring)


# ---------------------------------------------------------------------------
# Decode attention against the compressed cache (one layer)
# ---------------------------------------------------------------------------

def _query_table(q: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """``q (B, G, R, hd)``, books ``(G, M, K, Ds)`` -> the bf16 table
    ``(B, G, R, M, K)`` (float32 products, rounded once, as the
    reference)."""
    G, M, K, Ds = books.shape
    B, _, R, _ = q.shape
    qr = q.float().reshape(B, G, R, M, Ds)
    return torch.einsum("bgrmd,gmkd->bgrmk", qr, books).to(BF16)


def _ring_scores(q: torch.Tensor, k_rec: torch.Tensor, pos: int,
                 scale: float) -> torch.Tensor:
    """Exact scores of the ring ``(B, G, R, W)``; slots not yet written
    (absolute position < 0) are -1e30."""
    W = k_rec.shape[1]
    s_ring = torch.einsum("bgrh,bwgh->bgrw", q.float(), k_rec.float()) * scale
    slots = torch.arange(W, device=q.device)
    ring_abs = pos - torch.remainder(pos - slots, W)
    return s_ring.masked_fill(ring_abs < 0, _NEG_INF)


def pq_attention_decode(q: torch.Tensor, layer_cache: PQKVCache, pos: int,
                        *, pqc: PQKVConfig, window: int = 0,
                        route: Optional[str] = None) -> torch.Tensor:
    """One layer's decode attention against its compressed cache.

    ``q (B, G, R, hd)``; ``layer_cache`` one layer of a :class:`PQKVCache`
    (``cache.layer(i)``).  Returns ``(B, G, R, hd)`` bf16.  ``route``:
    ``"plain"`` or ``"kernel"`` (module docstring); by default the kernel
    for CUDA tensors and the plain route for CPU ones."""
    if window > 0:
        raise NotImplementedError("PQ-KV local windows (gemma2) are not "
                                  "ported")
    if route is None:
        route = "kernel" if q.is_cuda else "plain"
    k_codes, k_books, v, k_rec, v_rec = layer_cache
    B, S, G, M = k_codes.shape
    R, hd = q.shape[2], q.shape[3]
    K = k_books.shape[2]
    W = k_rec.shape[1]
    scale = hd ** -0.5
    qlut = _query_table(q, k_books)
    s_ring = _ring_scores(q, k_rec, pos, scale)
    if route == "kernel":
        o_t, m_t, l_t = pq_attn(qlut.reshape(B, G * R, M, K), k_codes, v,
                                max(pos - W + 1, 0), scale)
        m_t, l_t = m_t.reshape(B, G, R, 1), l_t.reshape(B, G, R, 1)
        m_r = s_ring.amax(dim=-1, keepdim=True)
        er = torch.exp(s_ring - m_r)
        acc_r = torch.einsum("bgrw,bwgh->bgrh", er, v_rec.float())
        m = torch.maximum(m_t, m_r)
        w_t = l_t * torch.exp(m_t - m)
        w_r = torch.exp(m_r - m)
        out = ((o_t.reshape(B, G, R, hd) * w_t + acc_r * w_r)
               / (w_t + er.sum(dim=-1, keepdim=True) * w_r))
        return out.to(BF16)
    if route != "plain":
        raise ValueError(f"unknown route {route!r}")
    idx = k_codes.long().permute(0, 2, 3, 1)[:, :, None].expand(
        B, G, R, M, S)
    scores = torch.gather(qlut.float(), 4, idx).sum(dim=3) * scale
    tail = torch.arange(S, device=q.device) <= pos - W
    s_tail = scores.masked_fill(~tail, _NEG_INF)
    m = torch.maximum(s_tail.amax(dim=-1, keepdim=True),
                      s_ring.amax(dim=-1, keepdim=True))
    et = torch.exp(s_tail - m)
    er = torch.exp(s_ring - m)
    denom = et.sum(dim=-1, keepdim=True) + er.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrw,bwgh->bgrh", er, v_rec.float())
    out = out + torch.einsum("bgrs,bsgh->bgrh", et.to(BF16).float(),
                             v.float())
    return (out / denom).to(BF16)


# ---------------------------------------------------------------------------
# Full decode step with the compressed cache
# ---------------------------------------------------------------------------

def _pq_attn_block(attn_p, cfg: ModelConfig, x: torch.Tensor,
                   layer_cache: PQKVCache, pos: int, *, pqc: PQKVConfig,
                   cos_sin) -> torch.Tensor:
    """Project q/k/v, write the compressed cache at ``pos`` (the key's
    codes, the value, and both into ring slot ``pos % W``), attend."""
    B = x.shape[0]
    hd, H, G = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    cos, sin = cos_sin
    q = apply_rope(_dot(x, attn_p.wq, attn_p.bq).reshape(B, 1, G, H // G, hd),
                   cos, sin)[:, 0]
    k_new = apply_rope(_dot(x, attn_p.wk, attn_p.bk).reshape(B, 1, G, hd),
                       cos, sin)[:, 0]
    v_new = _dot(x, attn_p.wv, attn_p.bv).reshape(B, G, hd)
    k_codes, k_books, v, k_rec, v_rec = layer_cache
    k_codes[:, pos] = encode_kv(k_new, k_books)
    v[:, pos] = v_new.to(v.dtype)
    slot = pos % k_rec.shape[1]
    k_rec[:, slot] = k_new.to(k_rec.dtype)
    v_rec[:, slot] = v_new.to(v_rec.dtype)
    out = pq_attention_decode(q, layer_cache, pos, pqc=pqc)
    return _dot(out.reshape(B, 1, H * hd).to(BF16), attn_p.wo)


def pq_serve_step(params: LmParams, cfg: ModelConfig, pq_cache: PQKVCache,
                  token: torch.Tensor, pos: int, *, pqc: PQKVConfig
                  ) -> Tuple[torch.Tensor, PQKVCache]:
    """Single-token decode with the PQ-compressed cache: ``token (B, 1)``
    -> (logits ``(B, 1, Vp)`` float32, the cache updated at ``pos`` in
    place).  Dense family."""
    check_supported(cfg)
    pos = int(pos)
    x = embed_tokens(params, token)
    cos_sin = decode_cos_sin(cfg, x.shape[0], pos, x.device)
    for layer, blk in enumerate(params.blocks):
        a = _pq_attn_block(blk.attn, cfg, rms_norm(x, blk.ln1, cfg.norm_eps),
                           pq_cache.layer(layer), pos, pqc=pqc,
                           cos_sin=cos_sin)
        x = x + a
        x = x + mlp(blk.mlp, rms_norm(x, blk.ln2, cfg.norm_eps), cfg.act)
    return logits_from_hidden(params, cfg, x), pq_cache


# ---------------------------------------------------------------------------
# Memory accounting (paper §3.4, applied to the KV cache)
# ---------------------------------------------------------------------------

def pqkv_memory(cfg: ModelConfig, pqc: PQKVConfig, batch: int,
                seq_len: int) -> dict:
    """Bytes for the exact vs the PQ-compressed cache (paper §3.4)."""
    L, G, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    M, K, W = pqc.n_sub, pqc.codebook_size, pqc.recent_window
    n_vec = L * batch * seq_len * G
    exact = 2 * n_vec * hd * 2                       # k+v bf16
    bits = (K - 1).bit_length()
    code_bytes = max(1, bits // 8 + (1 if bits % 8 else 0))
    k_side = n_vec * M * code_bytes + n_vec * hd * 2  # codes + exact values
    books = L * G * M * K * (hd // M) * 4
    ring = 2 * L * batch * W * G * hd * 2
    total = k_side + books + ring
    return dict(exact_bytes=exact, pq_bytes=total, books_bytes=books,
                ring_bytes=ring, compression=exact / max(total, 1))
