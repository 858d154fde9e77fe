"""Plain PyTorch versions of the PQ-ADC kernels: gathers summed over the
subspaces in the kernels' order (``acc = 0; acc += table[m, ...]``).  The
quantised versions dequantise the table first, then gather; the kernels
apply the same affine to each selected entry, which gives the same
float32 values."""

from __future__ import annotations

import torch

from ...core.measures import fma, sqrt_rn

__all__ = ["adc_sym_cdist_ref", "adc_lookup_ref", "dequantize",
           "adc_sym_cdist_quant_ref", "adc_lookup_quant_ref"]


def adc_sym_cdist_ref(codes_a: torch.Tensor, codes_b: torch.Tensor,
                      lut: torch.Tensor) -> torch.Tensor:
    """``(Na, M) x (Nb, M)`` codes, ``lut (M, K, K)`` -> ``(Na, Nb)``."""
    ca, cb = codes_a.long(), codes_b.long()
    lut = lut.to(torch.float32)
    acc = torch.zeros((ca.shape[0], cb.shape[0]), dtype=torch.float32,
                      device=lut.device)
    for m in range(lut.shape[0]):
        acc = acc + lut[m][ca[:, m, None], cb[None, :, m]]
    return sqrt_rn(torch.clamp(acc, min=0.0))


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
    out = sqrt_rn(torch.clamp(acc, min=0.0))
    return out[0] if single else out


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               zero: torch.Tensor) -> torch.Tensor:
    """``q * scale + zero`` back to float32, with one rounding (the
    reference's compiler contracts it into a fused multiply-add).
    ``scale``/``zero`` have the shape of ``q`` up to its last axis (or
    last two, for a ``(M, K, K)`` table) with a trailing 1."""
    sc = scale.to(torch.float32)
    zp = zero.to(torch.float32)
    while sc.dim() < q.dim():
        sc, zp = sc[..., None], zp[..., None]
    return fma(q.to(torch.float32), sc, zp)


def adc_sym_cdist_quant_ref(codes_a: torch.Tensor, codes_b: torch.Tensor,
                            q: torch.Tensor, scale: torch.Tensor,
                            zero: torch.Tensor) -> torch.Tensor:
    """Symmetric ADC over a quantised ``(M, K, K)`` table with ``scale``/
    ``zero (M, 1)``."""
    return adc_sym_cdist_ref(codes_a, codes_b, dequantize(q, scale, zero))


def adc_lookup_quant_ref(codes: torch.Tensor, q: torch.Tensor,
                         scale: torch.Tensor,
                         zero: torch.Tensor) -> torch.Tensor:
    """Asymmetric scan over a quantised ``(M, K)`` table (``scale``/``zero
    (M, 1)``) or a batch ``(Nq, M, K)`` (``(Nq, M, 1)``)."""
    return adc_lookup_ref(codes, dequantize(q, scale, zero))
