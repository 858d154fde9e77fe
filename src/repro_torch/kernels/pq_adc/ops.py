"""Wrappers of the PQ-ADC CUDA kernels (``csrc/pq_adc.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  Codes are int32 and are bounds-checked here, since
the kernels gather with them unchecked: one ``aminmax`` per codes tensor
and a single device-to-host read for the whole call.
:func:`launch_adc_sym` and :func:`launch_adc_lookup` are the launches
alone, on inputs the wrappers have checked.

Quantised tables (:func:`quantize_lut`, the reference's per-subspace
affine int8 or plain bfloat16) go through :func:`adc_sym_cdist_quant` and
:func:`adc_lookup_quant`, the kernels' templated forms over the table's
type, counted as ``adc_sym_quant`` and ``adc_lookup_quant``.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import (adc_lookup_quant_ref, adc_lookup_ref,
                  adc_sym_cdist_quant_ref, adc_sym_cdist_ref)

__all__ = ["adc_sym_cdist", "adc_lookup", "launch_adc_sym",
           "launch_adc_lookup", "quantize_lut", "adc_sym_cdist_quant",
           "adc_lookup_quant", "launch_adc_sym_quant",
           "launch_adc_lookup_quant"]

_MAX_GRID_Y = 65535
_SMEM_MAX = 227 * 1024
_LOOKUP_THREADS = 256
# the kernels' table types (pq_adc.cu: kInt8, kBF16)
_QUANT_TYPES = {torch.int8: 0, torch.bfloat16: 1}
# 1/254 as float32: the reference's compiler turns its division by the
# constant 254.0 into this product
_INV_254 = torch.tensor(1.0 / 254.0, dtype=torch.float32)


def _codes(c: torch.Tensor, name: str, M: int) -> torch.Tensor:
    if c.dim() != 2 or c.shape[1] != M:
        raise ValueError(f"{name} must be (rows, {M}), got {tuple(c.shape)}")
    return c.to(torch.int32).contiguous()


def _check_range(K: int, **codes: torch.Tensor) -> None:
    """Raise if any codes tensor holds a code outside ``[0, K)``; reads the
    extremes of all of them back in one transfer."""
    codes = {name: c for name, c in codes.items() if c.numel()}
    if not codes:
        return
    ext = torch.stack([torch.stack(torch.aminmax(c))
                       for c in codes.values()]).tolist()
    for name, (lo, hi) in zip(codes, ext):
        if lo < 0 or hi >= K:
            raise ValueError(f"{name} holds codes outside [0, {K})")


def _table(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def launch_adc_sym(ca: torch.Tensor, cb: torch.Tensor, lut: torch.Tensor,
                   out: torch.Tensor) -> None:
    """Launch the symmetric kernel into ``out (Na, Nb)``: contiguous int32
    codes in range, a contiguous float32 LUT, all on one CUDA device."""
    (Na, M), Nb, K = ca.shape, cb.shape[0], lut.shape[1]
    grid_y = min(-(-Na // 8), _MAX_GRID_Y)
    status = _build.lib().pq_adc_sym(
        ca.data_ptr(), cb.data_ptr(), lut.data_ptr(), out.data_ptr(),
        Na, Nb, M, K, grid_y, _build.stream(out.device))
    _build.check(status, "adc_sym")
    _build.count_launch("adc_sym")


def launch_adc_lookup(c: torch.Tensor, q: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Launch the lookup kernel into ``out (Nq, N)``: contiguous int32 codes
    in range, contiguous float32 tables ``(Nq, M, K)``, one CUDA device."""
    (Nq, M, K), N = q.shape, c.shape[0]
    blocks_n = -(-N // _LOOKUP_THREADS)
    grid_x = min(blocks_n, max(1, 4096 // Nq))
    grid_y = min(Nq, _MAX_GRID_Y)
    status = _build.lib().pq_adc_lookup(
        q.data_ptr(), c.data_ptr(), out.data_ptr(), Nq, N, M, K,
        _LOOKUP_THREADS, grid_x, grid_y, _build.stream(out.device))
    _build.check(status, "adc_lookup")
    _build.count_launch("adc_lookup")


def adc_sym_cdist(codes_a: torch.Tensor, codes_b: torch.Tensor,
                  lut: torch.Tensor) -> torch.Tensor:
    """Symmetric PQ distances ``sqrt(max(0, sum_m LUT[m, a^m, b^m]))``:
    ``(Na, M) x (Nb, M)`` codes, ``lut (M, K, K)`` -> ``(Na, Nb)``."""
    if lut.dim() != 3 or lut.shape[1] != lut.shape[2]:
        raise ValueError(f"lut must be (M, K, K), got {tuple(lut.shape)}")
    M, K = lut.shape[0], lut.shape[1]
    ca = _codes(codes_a, "codes_a", M)
    cb = _codes(codes_b, "codes_b", M)
    lut = _table(lut)
    dev = _build.kernel_device(ca, cb, lut)
    _check_range(K, codes_a=ca, codes_b=cb)
    if dev is None:
        return adc_sym_cdist_ref(ca, cb, lut)
    out = torch.empty((ca.shape[0], cb.shape[0]), dtype=torch.float32,
                      device=dev)
    if out.numel():
        launch_adc_sym(ca, cb, lut, out)
    return out


def adc_lookup(codes: torch.Tensor, qlut: torch.Tensor) -> torch.Tensor:
    """Asymmetric scan ``sqrt(max(0, sum_m qlut[m, c_n^m]))``: ``codes
    (N, M)`` against ``qlut (M, K)`` -> ``(N,)``, or against a batch of
    query tables ``(Nq, M, K)`` -> ``(Nq, N)`` in one launch."""
    if qlut.dim() not in (2, 3):
        raise ValueError(f"qlut must be (M, K) or (Nq, M, K), got "
                         f"{tuple(qlut.shape)}")
    single = qlut.dim() == 2
    q = _table(qlut[None] if single else qlut)
    Nq, M, K = q.shape
    c = _codes(codes, "codes", M)
    dev = _build.kernel_device(c, q)
    _check_range(K, codes=c)
    if dev is None:
        return adc_lookup_ref(c, qlut if single else q)
    if M * K * 4 > _SMEM_MAX:
        raise ValueError(f"a ({M}, {K}) query table exceeds shared memory")
    out = torch.empty((Nq, c.shape[0]), dtype=torch.float32, device=dev)
    if out.numel():
        launch_adc_lookup(c, q, out)
    return out[0] if single else out


def quantize_lut(lut: torch.Tensor, dtype: str = "int8"):
    """Per-subspace affine quantisation of an ADC table, the reference's
    to the bit.

    ``lut (M, K, K)`` or ``(M, K)`` -> ``(q, scale, zero)``: ``q`` int8 with
    ``v ~ q * scale_m + zero_m`` over the subspace's range (codes in
    ``[-127, 127]``, rounded half to even), or bfloat16 with ``scale = 1``
    and ``zero = 0``; ``scale``/``zero`` are ``(M, 1)`` float32.

    >>> q, scale, zero = quantize_lut(torch.tensor([[0.0, 1.0, 2.0]]))
    >>> q.tolist(), float(zero[0, 0])
    ([[-127, 0, 127]], 1.0)
    """
    lut = lut.to(torch.float32)
    M = lut.shape[0]
    if dtype in ("bf16", "bfloat16"):
        return (lut.to(torch.bfloat16),
                torch.ones((M, 1), dtype=torch.float32, device=lut.device),
                torch.zeros((M, 1), dtype=torch.float32, device=lut.device))
    if dtype != "int8":
        raise ValueError(f"unsupported LUT quantization dtype: {dtype!r}")
    flat = lut.reshape(M, -1)
    lo = flat.amin(dim=1, keepdim=True)
    hi = flat.amax(dim=1, keepdim=True)
    zero = (hi + lo) * 0.5
    scale = torch.clamp(hi - lo, min=1e-12) * _INV_254.to(lut.device)
    q = torch.clamp(torch.round((flat - zero) / scale), -127, 127)
    return q.to(torch.int8).reshape(lut.shape), scale, zero


def _quant_table(q: torch.Tensor) -> torch.Tensor:
    if q.dtype not in _QUANT_TYPES:
        raise ValueError(f"a quantised table is int8 or bfloat16, got "
                         f"{q.dtype}")
    return q.contiguous()


def _affine(t: torch.Tensor, name: str, rows: int) -> torch.Tensor:
    """``scale``/``zero`` as contiguous float32 ``(rows,)``."""
    if t.numel() != rows:
        raise ValueError(f"{name} must hold one value per table row "
                         f"({rows}), got shape {tuple(t.shape)}")
    return t.to(torch.float32).reshape(rows).contiguous()


def launch_adc_sym_quant(ca: torch.Tensor, cb: torch.Tensor, q: torch.Tensor,
                         scale: torch.Tensor, zero: torch.Tensor,
                         out: torch.Tensor) -> None:
    """Launch the quantised symmetric kernel into ``out (Na, Nb)``:
    checked codes, an int8/bf16 ``(M, K, K)`` table, ``scale``/``zero
    (M,)`` float32, all on one CUDA device."""
    (Na, M), Nb, K = ca.shape, cb.shape[0], q.shape[1]
    grid_y = min(-(-Na // 8), _MAX_GRID_Y)
    status = _build.lib().pq_adc_sym_quant(
        ca.data_ptr(), cb.data_ptr(), q.data_ptr(), scale.data_ptr(),
        zero.data_ptr(), out.data_ptr(), Na, Nb, M, K,
        _QUANT_TYPES[q.dtype], grid_y, _build.stream(out.device))
    _build.check(status, "adc_sym_quant")
    _build.count_launch("adc_sym_quant")


def launch_adc_lookup_quant(c: torch.Tensor, q: torch.Tensor,
                            scale: torch.Tensor, zero: torch.Tensor,
                            out: torch.Tensor) -> None:
    """Launch the quantised lookup kernel into ``out (Nq, N)``: checked
    codes, int8/bf16 tables ``(Nq, M, K)``, ``scale``/``zero (Nq * M,)``
    float32, all on one CUDA device."""
    (Nq, M, K), N = q.shape, c.shape[0]
    blocks_n = -(-N // _LOOKUP_THREADS)
    grid_x = min(blocks_n, max(1, 4096 // Nq))
    grid_y = min(Nq, _MAX_GRID_Y)
    status = _build.lib().pq_adc_lookup_quant(
        q.data_ptr(), scale.data_ptr(), zero.data_ptr(), c.data_ptr(),
        out.data_ptr(), Nq, N, M, K, _QUANT_TYPES[q.dtype],
        _LOOKUP_THREADS, grid_x, grid_y, _build.stream(out.device))
    _build.check(status, "adc_lookup_quant")
    _build.count_launch("adc_lookup_quant")


def adc_sym_cdist_quant(codes_a: torch.Tensor, codes_b: torch.Tensor,
                        q: torch.Tensor, scale: torch.Tensor,
                        zero: torch.Tensor) -> torch.Tensor:
    """Symmetric PQ distances over a table from :func:`quantize_lut`:
    ``q (M, K, K)`` int8/bf16 with ``scale``/``zero (M, 1)`` ->
    ``(Na, Nb)``; each selected entry is dequantised as
    ``scale_m * q + zero_m`` and summed over ``m`` in order."""
    if q.dim() != 3 or q.shape[1] != q.shape[2]:
        raise ValueError(f"q must be (M, K, K), got {tuple(q.shape)}")
    M, K = q.shape[0], q.shape[1]
    q = _quant_table(q)
    scale, zero = _affine(scale, "scale", M), _affine(zero, "zero", M)
    ca = _codes(codes_a, "codes_a", M)
    cb = _codes(codes_b, "codes_b", M)
    dev = _build.kernel_device(ca, cb, q, scale, zero)
    _check_range(K, codes_a=ca, codes_b=cb)
    if dev is None:
        return adc_sym_cdist_quant_ref(ca, cb, q, scale[:, None],
                                       zero[:, None])
    out = torch.empty((ca.shape[0], cb.shape[0]), dtype=torch.float32,
                      device=dev)
    if out.numel():
        launch_adc_sym_quant(ca, cb, q, scale, zero, out)
    return out


def adc_lookup_quant(codes: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """Asymmetric scan over quantised query tables: ``q (M, K)`` with
    ``scale``/``zero (M, 1)`` -> ``(N,)``, or a batch ``q (Nq, M, K)``
    with ``(Nq, M, 1)`` (each query's table quantised on its own) ->
    ``(Nq, N)`` in one launch."""
    if q.dim() not in (2, 3):
        raise ValueError(f"q must be (M, K) or (Nq, M, K), got "
                         f"{tuple(q.shape)}")
    single = q.dim() == 2
    qb = _quant_table(q[None] if single else q)
    Nq, M, K = qb.shape
    scale = _affine(scale, "scale", Nq * M)
    zero = _affine(zero, "zero", Nq * M)
    c = _codes(codes, "codes", M)
    dev = _build.kernel_device(c, qb, scale, zero)
    _check_range(K, codes=c)
    if dev is None:
        out = adc_lookup_quant_ref(c, qb, scale.reshape(Nq, M, 1),
                                   zero.reshape(Nq, M, 1))
        return out[0] if single else out
    if M * K * qb.element_size() + 2 * M * 4 > _SMEM_MAX:
        raise ValueError(f"a ({M}, {K}) query table exceeds shared memory")
    out = torch.empty((Nq, c.shape[0]), dtype=torch.float32, device=dev)
    if out.numel():
        launch_adc_lookup_quant(c, qb, scale, zero, out)
    return out[0] if single else out
