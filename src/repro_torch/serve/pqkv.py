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

Families: dense (gemma2's local layers mask both the coded tail and the
ring to their window), moe and vlm.  Beyond the paper, as in the
reference: ``mode="topk"`` reads the values of the ``top_t`` best-scored
tail positions only, and ``quantize_v=True`` codes the values too and
forms the output from the softmax mass per codeword (``w[k] = sum p_s``,
``out = w @ book``) without reconstructing them.  As in the reference,
PQ decode applies no attention softcap (gemma2's exact decode does).

Decode attention has two routes over the same cache:

* ``"plain"``: the reference's arithmetic step by step (a bf16 query
  table, its entries gathered and summed in float32, one softmax over the
  ADC tail and the exact ring, the bf16 value product);
* ``"kernel"``: the ``pq_attn`` kernel over the tail (positions
  ``[max(pos - window + 1, 0), max(pos - W + 1, 0))``, the start 0 without
  a window) with the same bf16 table, uint8 codes and bf16 values, then
  the ring's exact softmax piece merged through the kernel's running max
  and denominator.  It agrees with the plain route at bf16 tolerance (the
  online softmax rescales in another order, and the value product is not
  rounded to bf16 first).  ``mode="softmax"`` with exact values only: the
  reference computes ``topk`` and coded values outside its kernel, so
  they take the plain route (their default on every device) and
  ``route="kernel"`` raises for them.

The cache is updated in place at each decode step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .._device import DeviceArg, resolve_device
from ..kernels.pq_attn.ops import pq_attn
from ..models.config import ModelConfig
from ..models.layers import _dot, apply_rope, top_k
from ..models.lm import (LmParams, block_apply, check_kv_family,
                         embed_tokens, layer_window, logits_from_hidden)
from .decode import decode_cos_sin

__all__ = ["PQKVConfig", "PQKVCache", "fit_kv_books", "kmeans_batched",
           "encode_kv", "decode_kv", "init_pq_cache", "compress_cache",
           "tail_range", "pq_attention_decode", "pq_serve_step",
           "pqkv_memory"]

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
    mode: str = "softmax"       # "softmax" (dense ADC) | "topk" (sparse reads)
    top_t: int = 128            # T for mode="topk"
    quantize_v: bool = False    # PQ the values too
    kmeans_iters: int = 12
    fit_sample: int = 4096      # max tokens sampled per (layer, group) fit

    def __post_init__(self):
        if self.mode not in ("softmax", "topk"):
            raise ValueError(f"unknown PQ-KV mode {self.mode!r}")
        if not 1 <= self.codebook_size <= 256:
            raise ValueError("codebook_size must be in [1, 256] (uint8 "
                             "codes)")


class PQKVCache(NamedTuple):
    """Layer-stacked compressed cache (``layer(i)`` gives one layer's
    views, the form :func:`pq_attention_decode` takes).  Exact values
    (``v``) or coded ones (``v_codes`` and ``v_books``), never both."""
    k_codes: torch.Tensor       # (L, B, Smax, G, M) uint8
    k_books: torch.Tensor       # (L, G, M, K, hd/M) float32
    v: Optional[torch.Tensor]   # (L, B, Smax, G, hd) bf16 | None
    k_recent: torch.Tensor      # (L, B, W, G, hd) bf16 exact ring
    v_recent: torch.Tensor      # (L, B, W, G, hd) bf16 exact ring
    v_codes: Optional[torch.Tensor] = None   # (L, B, Smax, G, M) uint8
    v_books: Optional[torch.Tensor] = None   # (L, G, M, K, hd/M) float32

    def layer(self, i: int) -> "PQKVCache":
        return PQKVCache(*(None if t is None else t[i] for t in self))


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
                  device: DeviceArg = None,
                  v_books: Optional[torch.Tensor] = None) -> PQKVCache:
    """Empty compressed cache around pre-fit ``books`` (and ``v_books``,
    which ``quantize_v=True`` needs)."""
    check_kv_family(cfg, "PQ-KV")
    dev = resolve_device(device)
    L, G, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim_
    W = pqc.recent_window
    codes_shape = (L, batch, max_len, G, pqc.n_sub)
    v = v_codes = None
    if pqc.quantize_v:
        if v_books is None:
            raise ValueError("quantize_v=True needs fitted v_books")
        v_codes = torch.zeros(codes_shape, dtype=torch.uint8, device=dev)
        v_books = v_books.to(dev, torch.float32)
    else:
        v = torch.zeros((L, batch, max_len, G, hd), dtype=BF16, device=dev)
        v_books = None
    return PQKVCache(
        k_codes=torch.zeros(codes_shape, dtype=torch.uint8, device=dev),
        k_books=books.to(dev, torch.float32), v=v,
        k_recent=torch.zeros((L, batch, W, G, hd), dtype=BF16, device=dev),
        v_recent=torch.zeros((L, batch, W, G, hd), dtype=BF16, device=dev),
        v_codes=v_codes, v_books=v_books)


def _encode_cache(kv: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """Codes of a whole cache ``(L, B, S, G, hd)``, one (layer, row) at a
    time (each one's distance block is ``(S, G, M, K)``)."""
    L, B, S, G, _ = kv.shape
    codes = torch.empty((L, B, S, G, books.shape[2]), dtype=torch.uint8,
                        device=kv.device)
    for layer in range(L):
        for b in range(B):
            codes[layer, b] = encode_kv(kv[layer, b], books[layer])
    return codes


def _fit_or_given(kv, pqc, generator, pos, books, what):
    if books is None:
        if generator is None:
            raise ValueError(f"pass a torch.Generator (generator=) to fit "
                             f"the {what} codebooks, or pre-fit ones")
        books = fit_kv_books(kv, pqc, generator, valid_len=pos)
    return books.to(kv.device, torch.float32)


def compress_cache(cache: Dict[str, torch.Tensor], cfg: ModelConfig,
                   pqc: PQKVConfig, pos: int,
                   generator: Optional[torch.Generator] = None,
                   books: Optional[torch.Tensor] = None,
                   v_books: Optional[torch.Tensor] = None) -> PQKVCache:
    """Compress an exact prefill cache ``{k, v}`` into a
    :class:`PQKVCache`: fit key codebooks on the first ``pos`` entries
    (from ``generator``) unless pre-fit ``books (L, G, M, K, Ds)`` are
    given, encode every cached key, and seed the exact ring with the last W
    tokens (ring slot ``p % W``).  With ``quantize_v=True`` the values are
    coded the same way (``v_books``, else fit after the key books from the
    same generator); otherwise the PQ cache takes ``cache["v"]`` itself:
    copy it first if the exact cache goes on decoding."""
    check_kv_family(cfg, "PQ-KV")
    k_cache, v_cache = cache["k"], cache["v"]
    L, B, Smax, G, hd = k_cache.shape
    W = pqc.recent_window
    books = _fit_or_given(k_cache, pqc, generator, pos, books, "key")
    codes = _encode_cache(k_cache, books)
    v, v_codes = v_cache, None
    if pqc.quantize_v:
        v_books = _fit_or_given(v_cache, pqc, generator, pos, v_books,
                                "value")
        v, v_codes = None, _encode_cache(v_cache, v_books)
    else:
        v_books = None
    take = torch.arange(W, device=k_cache.device)
    ring_pos = (pos - W + take) % Smax                # absolute positions
    slot = ((pos - W + take) % W + W) % W
    k_ring = torch.zeros((L, B, W, G, hd), dtype=BF16, device=k_cache.device)
    v_ring = torch.zeros_like(k_ring)
    k_ring[:, :, slot] = k_cache[:, :, ring_pos].to(BF16)
    v_ring[:, :, slot] = v_cache[:, :, ring_pos].to(BF16)
    return PQKVCache(k_codes=codes, k_books=books, v=v, k_recent=k_ring,
                     v_recent=v_ring, v_codes=v_codes, v_books=v_books)


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
                 scale: float, window: int = 0) -> torch.Tensor:
    """Exact scores of the ring ``(B, G, R, W)``; slots not yet written
    (absolute position < 0) and, with ``window > 0``, slots at or before
    ``pos - window`` are -1e30."""
    W = k_rec.shape[1]
    s_ring = torch.einsum("bgrh,bwgh->bgrw", q.float(), k_rec.float()) * scale
    slots = torch.arange(W, device=q.device)
    ring_abs = pos - torch.remainder(pos - slots, W)
    invalid = ring_abs < 0
    if window > 0:
        invalid |= ring_abs <= pos - window
    return s_ring.masked_fill(invalid, _NEG_INF)


def tail_range(pos: int, W: int, window: int = 0) -> Tuple[int, int]:
    """The coded tail a decode step at ``pos`` attends to, as ``[start,
    stop)``: the positions before the ring (``<= pos - W``) and, with a
    window, inside it (``> pos - window``).  Empty when ``start >=
    stop``.

    >>> tail_range(2048, 128), tail_range(4610, 128, 4096), tail_range(5, 8)
    ((0, 1921), (515, 4483), (0, 0))
    """
    stop = max(pos - W + 1, 0)
    return (max(pos - window + 1, 0) if window > 0 else 0), stop


def _gather_positions(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, S, G, D)`` at positions ``idx (B, G, R, T)`` -> ``(B, G, R,
    T, D)``."""
    B, S, G, D = x.shape
    R, T = idx.shape[2], idx.shape[3]
    xt = x.permute(0, 2, 1, 3)[:, :, None].expand(B, G, R, S, D)
    return torch.gather(xt, 3, idx[..., None].expand(B, G, R, T, D))


def _book_rows(codes: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """Codewords of ``codes (B, G, R, T, M)`` from ``books (G, M, K, Ds)``
    -> ``(B, G, R, T, M * Ds)`` float32 (the reference's one-hot product,
    exact: one nonzero term)."""
    G, M = books.shape[:2]
    g = torch.arange(G, device=codes.device)[None, :, None, None, None]
    m = torch.arange(M, device=codes.device)
    rows = books[g, m, codes.long()]
    return rows.reshape(*codes.shape[:-1], -1)


def _codeword_mass(p: torch.Tensor, v_codes: torch.Tensor,
                   v_books: torch.Tensor) -> torch.Tensor:
    """The coded values' share of the output: the softmax mass of each
    codeword, ``w[b, g, r, m, k] = sum_s p[b, g, r, s] [code[b, s, g, m]
    = k]`` (bf16 weights, float32 sums), times the books -> ``(B, G, R,
    hd)`` float32."""
    B, G, R, S = p.shape
    M, K = v_books.shape[1], v_books.shape[2]
    idx = v_codes.long().permute(0, 2, 3, 1)[:, :, None].expand(B, G, R, M, S)
    src = p.to(BF16).float()[:, :, :, None, :].expand(B, G, R, M, S)
    mass = torch.zeros((B, G, R, M, K), dtype=torch.float32, device=p.device)
    mass.scatter_add_(4, idx, src)
    vhat = torch.einsum("bgrmk,gmkd->bgrmd", mass, v_books)
    return vhat.reshape(B, G, R, -1)


def pq_attention_decode(q: torch.Tensor, layer_cache: PQKVCache, pos: int,
                        *, pqc: PQKVConfig, window: int = 0,
                        route: Optional[str] = None) -> torch.Tensor:
    """One layer's decode attention against its compressed cache.

    ``q (B, G, R, hd)``; ``layer_cache`` one layer of a :class:`PQKVCache`
    (``cache.layer(i)``); ``window > 0`` restricts the tail and the ring
    to the last ``window`` positions (gemma2's local layers).  Returns
    ``(B, G, R, hd)`` bf16.  ``route``: ``"plain"`` or ``"kernel"``
    (module docstring); by default the kernel for tensors off the CPU
    with ``mode="softmax"`` and exact values, else the plain route."""
    lc = layer_cache
    coded_v = lc.v is None
    if route is None:
        route = ("kernel" if q.device.type != "cpu"
                 and pqc.mode == "softmax"
                 and not coded_v else "plain")
    B, S, G, M = lc.k_codes.shape
    R, hd = q.shape[2], q.shape[3]
    K = lc.k_books.shape[2]
    W = lc.k_recent.shape[1]
    scale = hd ** -0.5
    qlut = _query_table(q, lc.k_books)
    s_ring = _ring_scores(q, lc.k_recent, pos, scale, window)
    if route == "kernel":
        if pqc.mode != "softmax" or coded_v:
            what = ("mode='topk'" if pqc.mode != "softmax"
                    else "quantize_v=True")
            raise ValueError(
                f"route='kernel' runs the pq_attn kernel (mode='softmax', "
                f"exact values); {what} has no kernel (the reference "
                f"computes it outside its Pallas kernel): use route='plain'")
        start, stop = tail_range(pos, W, window)
        o_t, m_t, l_t = pq_attn(qlut.reshape(B, G * R, M, K), lc.k_codes,
                                lc.v, stop, scale, start)
        m_t, l_t = m_t.reshape(B, G, R, 1), l_t.reshape(B, G, R, 1)
        m_r = s_ring.amax(dim=-1, keepdim=True)
        er = torch.exp(s_ring - m_r)
        acc_r = torch.einsum("bgrw,bwgh->bgrh", er, lc.v_recent.float())
        m = torch.maximum(m_t, m_r)
        w_t = l_t * torch.exp(m_t - m)
        w_r = torch.exp(m_r - m)
        out = ((o_t.reshape(B, G, R, hd) * w_t + acc_r * w_r)
               / (w_t + er.sum(dim=-1, keepdim=True) * w_r))
        return out.to(BF16)
    if route != "plain":
        raise ValueError(f"unknown route {route!r}")
    idx = lc.k_codes.long().permute(0, 2, 3, 1)[:, :, None].expand(
        B, G, R, M, S)
    scores = torch.gather(qlut.float(), 4, idx).sum(dim=3) * scale
    kpos = torch.arange(S, device=q.device)
    tail = kpos <= pos - W
    if window > 0:
        tail &= kpos > pos - window
    s_tail = scores.masked_fill(~tail, _NEG_INF)
    v_rec = lc.v_recent.float()
    if pqc.mode == "topk":
        # sparse value reads: the top_t best-scored tail positions' values
        top_s, top_i = top_k(s_tail, min(pqc.top_t, S))
        m = torch.maximum(top_s.amax(dim=-1, keepdim=True),
                          s_ring.amax(dim=-1, keepdim=True))
        et = torch.exp(top_s - m)
        er = torch.exp(s_ring - m)
        denom = et.sum(dim=-1, keepdim=True) + er.sum(dim=-1, keepdim=True)
        vg = (_gather_positions(lc.v.float(), top_i) if not coded_v else
              _book_rows(_gather_positions(lc.v_codes, top_i), lc.v_books))
        out = torch.einsum("bgrt,bgrth->bgrh", et, vg)
        out = out + torch.einsum("bgrw,bwgh->bgrh", er, v_rec)
        return (out / denom).to(BF16)
    m = torch.maximum(s_tail.amax(dim=-1, keepdim=True),
                      s_ring.amax(dim=-1, keepdim=True))
    et = torch.exp(s_tail - m)
    er = torch.exp(s_ring - m)
    denom = et.sum(dim=-1, keepdim=True) + er.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrw,bwgh->bgrh", er, v_rec)
    if coded_v:
        out = out + _codeword_mass(et, lc.v_codes, lc.v_books)
    else:
        out = out + torch.einsum("bgrs,bsgh->bgrh", et.to(BF16).float(),
                                 lc.v.float())
    return (out / denom).to(BF16)


# ---------------------------------------------------------------------------
# Full decode step with the compressed cache
# ---------------------------------------------------------------------------

def _pq_attn_block(attn_p, cfg: ModelConfig, x: torch.Tensor,
                   layer_cache: PQKVCache, pos: int, *, pqc: PQKVConfig,
                   window: int, cos_sin) -> torch.Tensor:
    """Project q/k/v, write the compressed cache at ``pos`` (the key's
    codes, the value or its codes, and both into ring slot ``pos % W``),
    attend."""
    B = x.shape[0]
    hd, H, G = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    cos, sin = cos_sin
    q = apply_rope(_dot(x, attn_p.wq, attn_p.bq).reshape(B, 1, G, H // G, hd),
                   cos, sin)[:, 0]
    k_new = apply_rope(_dot(x, attn_p.wk, attn_p.bk).reshape(B, 1, G, hd),
                       cos, sin)[:, 0]
    v_new = _dot(x, attn_p.wv, attn_p.bv).reshape(B, G, hd)
    lc = layer_cache
    lc.k_codes[:, pos] = encode_kv(k_new, lc.k_books)
    if lc.v is not None:
        lc.v[:, pos] = v_new.to(lc.v.dtype)
    else:
        lc.v_codes[:, pos] = encode_kv(v_new, lc.v_books)
    slot = pos % lc.k_recent.shape[1]
    lc.k_recent[:, slot] = k_new.to(lc.k_recent.dtype)
    lc.v_recent[:, slot] = v_new.to(lc.v_recent.dtype)
    out = pq_attention_decode(q, lc, pos, pqc=pqc, window=window)
    return _dot(out.reshape(B, 1, H * hd).to(BF16), attn_p.wo)


def pq_serve_step(params: LmParams, cfg: ModelConfig, pq_cache: PQKVCache,
                  token: torch.Tensor, pos: int, *, pqc: PQKVConfig
                  ) -> Tuple[torch.Tensor, PQKVCache]:
    """Single-token decode with the PQ-compressed cache: ``token (B, 1)``
    -> (logits ``(B, 1, Vp)`` float32, the cache updated at ``pos`` in
    place).  Dense (gemma2's local layers attend over their window, with
    the sandwich norms and the scaled embedding), moe and vlm families."""
    check_kv_family(cfg, "PQ-KV")
    pos = int(pos)
    x = embed_tokens(params, cfg, token)
    cos_sin = decode_cos_sin(cfg, x.shape[0], pos, x.device)
    for layer, blk in enumerate(params.blocks):
        x = block_apply(blk, cfg, x, lambda p, xn: _pq_attn_block(
            p, cfg, xn, pq_cache.layer(layer), pos, pqc=pqc,
            window=layer_window(cfg, layer), cos_sin=cos_sin))
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
    codes = n_vec * M * code_bytes
    k_side = codes if pqc.quantize_v else codes + n_vec * hd * 2
    v_side = codes if pqc.quantize_v else 0          # exact values: k_side
    books = L * G * M * K * (hd // M) * 4 * (2 if pqc.quantize_v else 1)
    ring = 2 * L * batch * W * G * hd * 2
    total = k_side + v_side + books + ring
    return dict(exact_bytes=exact, pq_bytes=total, books_bytes=books,
                ring_bytes=ring, compression=exact / max(total, 1))
