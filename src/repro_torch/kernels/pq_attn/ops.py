"""Wrappers of the PQ attention CUDA kernel (``csrc/pq_attn.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises; meta tensors get the outputs' shapes (the op is
registered with PyTorch's dispatcher as ``repro_torch::pq_attn``).
:func:`pq_attn` is the kernel's own interface (a
query table, codes, values, the range ``[start, valid_len)``: ``start > 0``
is a sliding window's first position) and returns the running max and
denominator beside the output, so a caller can merge another softmax piece
(the PQ-KV cache's exact ring).  :func:`pq_attn_decode` keeps the
reference's signature (a query and codebooks) and builds the float32 table
itself.  :func:`launch_pq_attn` is the launch alone, on checked inputs;
it counts as ``pq_attn``, and with ``start > 0`` also as
``pq_attn[window]``.

The kernel splits the range over CTAs (:func:`split_geometry` of its
length, from the shapes alone) and merges the splits inside the same launch: one launch
per call.  The merge's workspace (:func:`workspace_floats`) is allocated
per call; its tickets are an int32 counter per (row, group), which every
launch leaves at 0.  The counters are kept per ``(device, stream)``
(:func:`counter_key`): launches in flight at once on two streams never
draw from the same tickets, and launches on one stream run in order, so
they may share theirs.  A CUDA graph keeps the counters of the stream it
was captured on (their address is in the captured launch); make them on
that stream before the capture, by one eager call, so that the capture
does not record their zeroing.

The kernel reads the table as float32 or bf16, codes as uint8 or int32,
values as float32 or bf16, each in the type given.  Codes must lie in
``[0, K)`` (the kernel clamps, so a bad code gives a wrong score, never a
fault); they come from :func:`encode_keys` or the cache, so they are not
read back to check.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .. import _build
from .ref import pq_attn_lut_ref

__all__ = ["build_qlut", "encode_keys", "pq_attn", "launch_pq_attn",
           "pq_attn_decode", "split_geometry", "workspace_floats",
           "value_vector", "counter_key"]

_SMEM_MAX = 227 * 1024
_MAX_REPS = 8        # heads per KV group (pq_attn.cu: kMaxR)
_TABLE_TYPES = (torch.float32, torch.bfloat16)
_CODE_TYPES = (torch.uint8, torch.int32)
_VALUE_TYPES = (torch.float32, torch.bfloat16)
_TARGET_CTAS = 4 * 132   # about 4 CTAs on each of the H100's 132 SMs
_CHUNK_STEP = 64         # positions: a chunk is a multiple of this
_CHUNK_MAX = 1024
_MAX_SPLITS = 65535      # the grid's y extent
_COUNTERS: Dict[Tuple[str, int], torch.Tensor] = {}


def split_geometry(valid_len: int, rows: int) -> Tuple[int, int]:
    """``(chunk, n_split)`` for ``valid_len`` positions in each of ``rows =
    B * G`` (row, group) pairs: chunks of a multiple of 64 positions (at
    most 1024 unless more than 65535 splits would be needed), sized so that
    ``rows * n_split`` comes near 4 CTAs a SM; ``n_split = ceil(valid_len /
    chunk)``, so no split is empty and none lies beyond ``valid_len``.  An
    empty prefix takes one split, which writes the empty result.

    >>> split_geometry(1921, 64), split_geometry(77, 6), split_geometry(0, 8)
    ((256, 8), (64, 2), (64, 1))
    """
    valid_len, rows = int(valid_len), max(1, int(rows))
    if valid_len <= 0:
        return _CHUNK_STEP, 1
    per_cta = -(-valid_len * rows // _TARGET_CTAS)
    chunk = min(max(-(-per_cta // _CHUNK_STEP) * _CHUNK_STEP, _CHUNK_STEP),
                _CHUNK_MAX)
    least = -(-valid_len // _MAX_SPLITS)
    chunk = max(chunk, -(-least // _CHUNK_STEP) * _CHUNK_STEP)
    return chunk, -(-valid_len // chunk)


def workspace_floats(rows: int, n_split: int, reps: int, Dv: int) -> int:
    """float32 elements of the merge's workspace: each split's ``acc (R,
    Dv)`` and ``(m, l)`` per head, none with a single split.

    >>> workspace_floats(64, 8, 2, 128), workspace_floats(64, 1, 2, 128)
    (133120, 0)
    """
    return 0 if n_split <= 1 else rows * n_split * reps * (Dv + 2)


def value_vector(v: torch.Tensor) -> int:
    """Values per load: 8 (16 bytes) for bf16 values whose width divides by
    8 and whose storage is 16-byte aligned, else 4 (16 bytes of float32, 8
    of bf16)."""
    ok8 = (v.dtype == torch.bfloat16 and v.shape[-1] % 8 == 0
           and v.data_ptr() % 16 == 0)
    return 8 if ok8 else 4


def counter_key(device: torch.device, stream: int) -> Tuple[str, int]:
    """The key of a launch's ticket counters: its device and the handle of
    the stream it is launched on (``torch.cuda.Stream.cuda_stream``).

    >>> counter_key(torch.device("cuda", 1), 0), counter_key("cuda:0", 77)
    (('cuda:1', 0), ('cuda:0', 77))
    """
    return str(torch.device(device)), int(stream)


def _counters(device: torch.device, stream: int,
              rows: int) -> torch.Tensor:
    """The merge's ticket counters of ``stream`` on ``device``: at least
    ``rows`` int32, zeroed when made (every launch leaves them at 0).  Made
    on that stream, so they are zero before its next launch."""
    key = counter_key(device, stream)
    t = _COUNTERS.get(key)
    if t is None or t.numel() < rows:
        size = max(rows, 2 * t.numel() if t is not None else rows)
        t = torch.zeros(size, dtype=torch.int32, device=device)
        _COUNTERS[key] = t
    return t


def build_qlut(q: torch.Tensor, k_books: torch.Tensor) -> torch.Tensor:
    """ADC tables: ``q (..., H, D)``, ``k_books (G, M, K, D/M)`` ->
    ``(..., H, M, K)`` with ``qlut[h, m, k] = q[h, m-th slice] .
    k_books[group(h), m, k]``."""
    G, M, K, Ds = k_books.shape
    *lead, H, D = q.shape
    qr = q.reshape(*lead, G, H // G, M, Ds)
    return torch.einsum("...grmd,gmkd->...grmk", qr,
                        k_books).reshape(*lead, H, M, K)


def encode_keys(k: torch.Tensor, k_books: torch.Tensor) -> torch.Tensor:
    """Quantise keys: ``k (S, G, D)``, books ``(G, M, K, D/M)`` ->
    ``(S, G, M)`` int32, the Euclidean nearest codeword per subspace
    (first index on ties)."""
    S, G, D = k.shape
    _, M, K, Ds = k_books.shape
    ks = k.reshape(S, G, M, Ds)
    d2 = ((ks ** 2).sum(-1)[..., None]
          - 2.0 * torch.einsum("sgmd,gmkd->sgmk", ks, k_books)
          + (k_books ** 2).sum(-1)[None])
    return torch.argmin(d2, dim=-1).to(torch.int32)


def _check(qlut, codes, v, valid_len, start):
    if qlut.dim() != 4 or codes.dim() != 4 or v.dim() != 4:
        raise ValueError("pq_attn takes qlut (B, H, M, K), codes (B, S, G, "
                         "M) and v (B, S, G, Dv)")
    B, H, M, K = qlut.shape
    _, S, G, _ = codes.shape
    if (codes.shape[0] != B or codes.shape[3] != M or v.shape[:3] != (B, S, G)
            or H % G):
        raise ValueError(f"pq_attn shapes disagree: qlut {tuple(qlut.shape)}, "
                         f"codes {tuple(codes.shape)}, v {tuple(v.shape)}")
    if not 0 <= valid_len <= S:
        raise ValueError(f"valid_len={valid_len} outside [0, {S}]")
    if not 0 <= start <= S:
        raise ValueError(f"start={start} outside [0, {S}]")


def launch_pq_attn(qlut: torch.Tensor, codes: torch.Tensor, v: torch.Tensor,
                   valid_len: int, scale: float, out: torch.Tensor,
                   m: torch.Tensor, l: torch.Tensor, start: int = 0) -> None:
    """Launch the kernel over positions ``[start, valid_len)`` into ``out
    (B, H, Dv)``, ``m, l (B, H)`` float32: contiguous inputs of the
    kernel's types on one CUDA device, checked by :func:`pq_attn`."""
    B, H, M, K = qlut.shape
    _, S, G, _ = codes.shape
    Dv, R = v.shape[-1], H // G
    chunk, n_split = split_geometry(valid_len - start, B * G)
    n_ws = workspace_floats(B * G, n_split, R, Dv)
    ws = (torch.empty(n_ws, dtype=torch.float32, device=out.device)
          if n_ws else None)
    stream = _build.stream(out.device)
    counters = _counters(out.device, stream, B * G) if n_ws else None
    status = _build.lib().pq_attn(
        qlut.data_ptr(), codes.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), _build.ptr(ws), _build.ptr(counters),
        B, S, G, R, M, K, Dv, int(start), int(valid_len), chunk, n_split,
        value_vector(v), float(scale), int(qlut.dtype == torch.bfloat16),
        int(codes.dtype == torch.uint8), int(v.dtype == torch.bfloat16),
        stream)
    _build.check(status, "pq_attn")
    _build.count_launch("pq_attn")
    if start > 0:
        _build.count_launch("pq_attn[window]")


def pq_attn(qlut: torch.Tensor, codes: torch.Tensor, v: torch.Tensor,
            valid_len: int, scale: float, start: int = 0):
    """Softmax attention of the table's heads over the coded positions
    ``[start, valid_len)``: ``qlut (B, H, M, K)``, ``codes (B, S, G, M)``,
    ``v (B, S, G, Dv)`` -> ``(out (B, H, Dv), m (B, H), l (B, H))``
    float32, ``m`` the largest score and ``l = sum exp(score - m)``.  An
    empty range (``start >= valid_len``) gives ``valid_len = 0``'s result.
    One call is one op of PyTorch's dispatcher (``repro_torch::pq_attn``),
    so a ``TorchDispatchMode`` sees it whole and meta tensors get its
    outputs' shapes."""
    valid_len, start = int(valid_len), int(start)
    _check(qlut, codes, v, valid_len, start)
    return tuple(torch.ops.repro_torch.pq_attn.default(
        qlut, codes, v, valid_len, float(scale), start))


def _pq_attn_op(qlut: torch.Tensor, codes: torch.Tensor, v: torch.Tensor,
                valid_len: int, scale: float, start: int):
    """:func:`pq_attn` on checked arguments: the plain version on the
    CPU, the kernel on the card."""
    dev = _build.kernel_device(qlut, codes, v)
    if dev is None:
        return pq_attn_lut_ref(qlut, codes, v, valid_len, scale, start)
    if (qlut.dtype not in _TABLE_TYPES or codes.dtype not in _CODE_TYPES
            or v.dtype not in _VALUE_TYPES):
        raise ValueError(f"pq_attn kernel takes float32/bf16 tables, "
                         f"uint8/int32 codes and float32/bf16 values, got "
                         f"{qlut.dtype}, {codes.dtype}, {v.dtype}")
    B, H, M, K = qlut.shape
    G, Dv = codes.shape[2], v.shape[-1]
    if H // G > _MAX_REPS or Dv % 4 or not 4 <= Dv <= 512:
        raise ValueError(f"pq_attn kernel takes at most {_MAX_REPS} heads "
                         f"per group and a value width in [4, 512] divisible "
                         f"by 4, got {H // G} and {Dv}")
    qlut, codes, v = qlut.contiguous(), codes.contiguous(), v.contiguous()
    if v.data_ptr() % (4 * v.element_size()):
        raise ValueError("pq_attn reads values 4 at a time: their storage "
                         "must be aligned to 4 elements")
    chunk, _ = split_geometry(valid_len - start, B * G)
    smem = _build.lib().pq_attn_smem_bytes(
        H // G, M, K, Dv, chunk, value_vector(v),
        int(qlut.dtype == torch.bfloat16))
    if smem > _SMEM_MAX:
        raise ValueError(f"pq_attn needs {smem} bytes of shared memory per "
                         f"block, over the card's {_SMEM_MAX}")
    out, m, l = _pq_attn_shapes(qlut, codes, v, valid_len, scale, start)
    if B * G:
        launch_pq_attn(qlut, codes, v, valid_len, scale, out, m, l, start)
    return out, m, l


def _pq_attn_shapes(qlut, codes, v, valid_len, scale, start):
    """The outputs, unwritten (on meta tensors, all the op does)."""
    B, H, Dv = qlut.shape[0], qlut.shape[1], v.shape[-1]
    f32 = dict(dtype=torch.float32, device=qlut.device)
    return (torch.empty((B, H, Dv), **f32), torch.empty((B, H), **f32),
            torch.empty((B, H), **f32))


# a plain registration (no autograd or schema-inference wrappers): the
# decode path calls it once a layer a step
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("pq_attn(Tensor qlut, Tensor codes, Tensor v, int valid_len, "
            "float scale, int start) -> (Tensor, Tensor, Tensor)")
for _key, _impl in (("CPU", _pq_attn_op), ("CUDA", _pq_attn_op),
                    ("Meta", _pq_attn_shapes)):
    _LIB.impl("pq_attn", _impl, _key)


def pq_attn_decode(q: torch.Tensor, k_codes: torch.Tensor,
                   k_books: torch.Tensor, v: torch.Tensor,
                   valid_len: Optional[int] = None,
                   return_stats: bool = False):
    """Approximate decode attention against a PQ-compressed key cache.

    ``q ([B,] H, D)``, ``k_codes ([B,] S, G, M)`` (uint8 or int32),
    ``k_books (G, M, K, D/M)``, ``v ([B,] S, G, Dv)``; ``valid_len`` real
    cache entries (default ``S``).  Returns ``([B,] H, Dv)`` float32 and,
    with ``return_stats``, the running max and denominator ``([B,] H)``.
    The query table is built in float32."""
    batched = q.dim() == 3
    if not batched:
        q, k_codes, v = q[None], k_codes[None], v[None]
    D = q.shape[-1]
    S = k_codes.shape[1]
    qlut = build_qlut(q.float(), k_books.float())
    codes = (k_codes if k_codes.dtype in _CODE_TYPES
             else k_codes.to(torch.int32))
    out, m, l = pq_attn(qlut, codes, v, S if valid_len is None else valid_len,
                        1.0 / (D ** 0.5))
    if not batched:
        out, m, l = out[0], m[0], l[0]
    return (out, m, l) if return_stats else out
