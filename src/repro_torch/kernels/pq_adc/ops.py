"""Wrappers of the PQ-ADC CUDA kernels (``csrc/pq_adc.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  Codes are int32 and are bounds-checked here, since
the kernels gather with them unchecked: one ``aminmax`` per codes tensor
and a single device-to-host read for the whole call.
:func:`launch_adc_sym` and :func:`launch_adc_lookup` are the launches
alone, on inputs the wrappers have checked.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import adc_lookup_ref, adc_sym_cdist_ref

__all__ = ["adc_sym_cdist", "adc_lookup", "launch_adc_sym",
           "launch_adc_lookup"]

_MAX_GRID_Y = 65535
_SMEM_MAX = 227 * 1024
_LOOKUP_THREADS = 256


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
