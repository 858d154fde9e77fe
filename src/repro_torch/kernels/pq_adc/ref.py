"""Plain PyTorch versions of the PQ-ADC kernels: gathers summed over the
subspaces in the kernels' order (``acc = 0; acc += table[m, ...]``)."""

from __future__ import annotations

import torch

__all__ = ["adc_sym_cdist_ref", "adc_lookup_ref"]


def adc_sym_cdist_ref(codes_a: torch.Tensor, codes_b: torch.Tensor,
                      lut: torch.Tensor) -> torch.Tensor:
    """``(Na, M) x (Nb, M)`` codes, ``lut (M, K, K)`` -> ``(Na, Nb)``."""
    ca, cb = codes_a.long(), codes_b.long()
    lut = lut.to(torch.float32)
    acc = torch.zeros((ca.shape[0], cb.shape[0]), dtype=torch.float32,
                      device=lut.device)
    for m in range(lut.shape[0]):
        acc = acc + lut[m][ca[:, m, None], cb[None, :, m]]
    return torch.sqrt(torch.clamp(acc, min=0.0))


def adc_lookup_ref(codes: torch.Tensor, qlut: torch.Tensor) -> torch.Tensor:
    """``codes (N, M)`` against ``qlut (M, K)`` -> ``(N,)``, or against a
    batch of query tables ``(Nq, M, K)`` -> ``(Nq, N)``."""
    c = codes.long()
    q = qlut.to(torch.float32)
    single = q.dim() == 2
    if single:
        q = q[None]
    acc = torch.zeros((q.shape[0], c.shape[0]), dtype=torch.float32,
                      device=q.device)
    for m in range(q.shape[1]):
        acc = acc + q[:, m, :][:, c[:, m]]
    out = torch.sqrt(torch.clamp(acc, min=0.0))
    return out[0] if single else out
