"""Plain PyTorch versions of the ``pq_attn`` kernel.

:func:`pq_attn_lut_ref` is the kernel's own function on its own inputs (a
query table, codes, values): the table entries gathered and summed in
float32, then one softmax over the positions ``[start, valid_len)``.
:func:`pq_attn_decode_ref` is the reference's oracle: reconstruct the keys
from the codes and run exact attention in float32.  ADC scores are
algebraically the scores against reconstructed keys, so the two agree up
to the order of float32 sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["reconstruct_keys", "pq_attn_decode_ref", "pq_attn_lut_ref",
           "NEG_INIT"]

NEG_INIT = -1e30  # the running max of an empty prefix (the kernel's init)


def reconstruct_keys(k_codes: torch.Tensor,
                     k_books: torch.Tensor) -> torch.Tensor:
    """``codes (..., S, G, M)``, ``books (G, M, K, Ds)`` -> keys
    ``(..., S, G, M*Ds)``."""
    G, M, K, Ds = k_books.shape
    g_idx = torch.arange(G, device=k_codes.device)[:, None]
    m_idx = torch.arange(M, device=k_codes.device)[None, :]
    gathered = k_books[g_idx, m_idx, k_codes.long()]     # (..., S, G, M, Ds)
    return gathered.reshape(*k_codes.shape[:-1], M * Ds)


def pq_attn_decode_ref(q: torch.Tensor, k_codes: torch.Tensor,
                       k_books: torch.Tensor, v: torch.Tensor,
                       valid_len: Optional[int] = None) -> torch.Tensor:
    """``q ([B,] H, D)``, codes ``([B,] S, G, M)``, books ``(G, M, K, Ds)``,
    values ``([B,] S, G, Dv)`` -> ``([B,] H, Dv)`` float32."""
    batched = q.dim() == 3
    if not batched:
        q, k_codes, v = q[None], k_codes[None], v[None]
    B, H, D = q.shape
    S, G = k_codes.shape[1], k_codes.shape[2]
    R = H // G
    valid_len = S if valid_len is None else int(valid_len)
    khat = reconstruct_keys(k_codes, k_books.float())    # (B, S, G, D)
    qg = q.float().reshape(B, G, R, D)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, khat) / (D ** 0.5)
    mask = torch.arange(S, device=q.device) < valid_len
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v.float()).reshape(B, H, -1)
    return out if batched else out[0]


def pq_attn_lut_ref(qlut: torch.Tensor, codes: torch.Tensor,
                    v: torch.Tensor, valid_len: int, scale: float,
                    start: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``qlut (B, G*R, M, K)``, ``codes (B, S, G, M)``, ``v (B, S, G, Dv)``
    -> ``(out (B, H, Dv), m (B, H), l (B, H))`` float32: the softmax of
    ``scale * sum_m qlut[h, m, code]`` over positions ``[start,
    valid_len)``, its maximum ``m`` and denominator ``l = sum exp(score -
    m)``.  An empty range gives ``out = 0, m = -1e30, l = 0``."""
    B, H, M, K = qlut.shape
    G = codes.shape[2]
    R = H // G
    Dv = v.shape[-1]
    start = int(start)
    n = max(int(valid_len) - start, 0)
    if n == 0:
        z = torch.zeros((B, H), dtype=torch.float32, device=qlut.device)
        return (torch.zeros((B, H, Dv), dtype=torch.float32,
                            device=qlut.device), z + NEG_INIT, z)
    table = qlut.float().reshape(B, G, R, M, K)
    idx = codes[:, start:start + n].long().clamp(0, K - 1).permute(
        0, 2, 3, 1)                                                  # B,G,M,n
    idx = idx[:, :, None].expand(B, G, R, M, n)
    scores = torch.gather(table, 4, idx).sum(dim=3) * scale       # B,G,R,n
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    l = e.sum(dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", e,
                       v[:, start:start + n].float())
    out = out / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Dv), m.reshape(B, H), l.reshape(B, H)
