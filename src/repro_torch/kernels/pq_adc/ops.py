"""Wrappers of the PQ-ADC CUDA kernels (``csrc/pq_adc.cu``).

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel or raises.  Codes are int32.  The kernels gather with them
unchecked, and a launch reads nothing back: codes are checked once where
they enter the program from outside (:func:`check_codes`, one
:class:`CodeRangeError`; the public ``pq`` functions, IVF ingest,
snapshot load), and the plain versions check the CPU tensors they get.
:func:`launch_adc_sym` and :func:`launch_adc_lookup` are the launches
alone, on inputs the wrappers have checked.

Quantised tables (:func:`quantize_lut`, the reference's per-subspace
affine int8 or plain bfloat16) go through :func:`adc_sym_cdist_quant` and
:func:`adc_lookup_quant`, the kernels' templated forms over the table's
type, counted as ``adc_sym_quant`` and ``adc_lookup_quant``.

Each scan has two forms, picked from the shapes alone by
:func:`sym_geometry` and :func:`lookup_geometry`: the row-staged form (one
kernel body for both scans: each query's table rows in shared memory, a
lane per query) wherever a tile of 8 queries' rows fits (and, for the
lookup, from :data:`LOOKUP_ROWS_MIN_NQ` queries on, 128-224 by the
table's type), else the symmetric thread form (an output a thread,
gathering from the LUT in L1/L2) or the lookup's table form (an output a
thread, one query's whole table staged a block).  Both forms of a scan
give the same bits and count under the same name.  Where the row-staged
form is picked, its tile comes from the tuning table (:mod:`..tune`,
``adc_sym`` / ``adc_lookup``'s ``ta``; the selector's tile by default).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build, tune
from .ref import (adc_lookup_quant_ref, adc_lookup_ref,
                  adc_sym_cdist_quant_ref, adc_sym_cdist_ref)

__all__ = ["adc_sym_cdist", "adc_lookup", "launch_adc_sym",
           "launch_adc_lookup", "quantize_lut", "adc_sym_cdist_quant",
           "adc_lookup_quant", "launch_adc_sym_quant",
           "launch_adc_lookup_quant", "check_codes", "note_codes",
           "CodeRangeError",
           "ScanGeometry", "sym_geometry",
           "sym_thread_geometry", "lookup_geometry", "lookup_table_geometry",
           "row_pitch", "rows_smem_bytes", "TABLE_TYPES", "ROWS_TA",
           "ROWS_WARPS", "GROUP_ROWS", "LOOKUP_ROWS_MIN_NQ"]

_MAX_GRID_Y = 65535
_SMEM_MAX = 227 * 1024
_LOOKUP_THREADS = 256
# the kernels' table types (pq_adc.cu: kInt8, kBF16, kF32)
_QUANT_TYPES = {torch.int8: 0, torch.bfloat16: 1}
TABLE_TYPES = {**_QUANT_TYPES, torch.float32: 2}
# the row-staged form (pq_adc.cu: adc_rows_kernel): queries a tile,
# largest first; warps a block; code rows a warp takes at once
ROWS_TA = (32, 16, 8)
ROWS_WARPS = 32
GROUP_ROWS = 16
# the thread form's tile (pq_adc.cu: kTileJ x kTileI outputs a block)
_TILE_J, _TILE_I = 32, 8
# the H100's SMs
_SMS = 132
# the staged table rows of all chunks stay within this share of the
# output's bytes (each chunk restages Na * M * K entries from L2)
_RESTAGE_SHARE = 0.75
# the lookup takes the row-staged form from this many queries on, by the
# table's item size (fewer leave most of a tile's lanes idle; the
# crossover on the H100, see lookup_geometry)
LOOKUP_ROWS_MIN_NQ = {4: 224, 2: 192, 1: 128}


class ScanGeometry(NamedTuple):
    """A launch of an ADC scan: ``form`` ``"rows"`` (row-staged),
    ``"thread"`` (the symmetric scan's output a thread) or ``"table"``
    (the lookup's output a thread, a query's table a block); ``ta``
    queries a tile and ``pitch`` the staged rows' pitch in 4-byte words (0
    for the other forms); ``chunk`` code rows a block (the thread form:
    its tile's 32; the table form: its block's 256 threads); ``smem`` bytes
    of shared memory a block; ``grid`` ``(x, y)`` blocks."""
    form: str
    ta: int
    pitch: int
    chunk: int
    smem: int
    grid: Tuple[int, int]


def row_pitch(K: int, itemsize: int, ta: int) -> int:
    """The staged rows' pitch in 4-byte words: a row's ``K`` entries
    rounded up to 32 words, plus ``32 // ta``, so that lane ``(i, s)``
    reading column word ``c`` of query ``i``'s row hits bank ``(32 // ta)
    i + c (mod 32)``: the ``ta`` queries of one codes_b row fall in ``ta``
    different banks (at ``ta = 32``, pitch = 1 (mod 32): a conflict-free
    warp).

    >>> row_pitch(256, 4, 16), row_pitch(256, 1, 32), row_pitch(256, 2, 32)
    (258, 65, 129)
    """
    words = -(-int(K) * int(itemsize) // 4)
    return -(-words // 32) * 32 + 32 // int(ta)


def rows_smem_bytes(ta: int, M: int, K: int, itemsize: int,
                    lookup: bool = False) -> int:
    """Shared memory a block of the row-staged form takes: the tile's ``M
    x ta`` table rows, each warp's code offsets (16 rows x ``M``) and
    output tile (``ta x (16 + 32 // ta)``), and a quantised table's
    ``scale``/``zero``: ``M`` of each, or in the lookup ``ta x M`` (one a
    query and subspace).  ``pq_adc_sym_rows_smem_bytes`` and
    ``pq_adc_lookup_rows_smem_bytes`` in the kernel library compute the
    same.

    >>> rows_smem_bytes(16, 8, 256, 4), rows_smem_bytes(32, 8, 256, 1)
    (185344, 152640)
    >>> rows_smem_bytes(32, 8, 256, 1, lookup=True)
    154624
    """
    warp_words = GROUP_ROWS * M + ta * (GROUP_ROWS + 32 // ta)
    quant = 2 * M * (ta if lookup else 1) if itemsize != 4 else 0
    return 4 * (M * ta * row_pitch(K, itemsize, ta)
                + ROWS_WARPS * warp_words + quant)


def sym_thread_geometry(Na: int, Nb: int, M: int, itemsize: int
                        ) -> ScanGeometry:
    """The thread form: a 32 x 8 block of outputs, the codes of its tile
    in shared memory at an odd pitch, the grid's y walking ``Na``
    grid-stride beyond 65535 blocks.

    >>> sym_thread_geometry(768, 6144, 8, 4).grid
    (192, 96)
    """
    pitch = M + 1 if M % 2 == 0 else M
    smem = (_TILE_I + _TILE_J) * pitch * 4 + (8 * M if itemsize != 4 else 0)
    return ScanGeometry("thread", 0, 0, _TILE_J, smem,
                        (-(-Nb // _TILE_J),
                         max(1, min(-(-Na // _TILE_I), _MAX_GRID_Y))))


def _rows_geometry(Na: int, Nb: int, M: int, K: int, itemsize: int,
                   ta: Optional[int], lookup: bool
                   ) -> Optional[ScanGeometry]:
    """The row-staged form's launch for ``Na`` queries against ``Nb`` code
    rows, or ``None`` where no tile's rows fit the card's 227 KB a block
    (a row of ``K`` entries a whole number of 4-byte words): the largest
    of :data:`ROWS_TA` that fits, or ``ta`` (raises if it does not fit).
    ``Nb`` is cut into ``n`` chunks, a block a (tile, chunk): the least
    ``n`` that gives the SM with the most work, ``ceil(tiles n / SMs) /
    n`` tiles, within 5% of the least such work, with the restaged rows of
    all chunks within three quarters of the output's bytes; a chunk is a
    whole number of 16 rows."""
    sizes = ROWS_TA if ta is None else (int(ta),)
    fits = [t for t in sizes
            if (K * itemsize) % 4 == 0
            and rows_smem_bytes(t, M, K, itemsize, lookup) <= _SMEM_MAX]
    if not fits:
        if ta is not None:
            raise ValueError(f"a tile of {ta} queries' ({M}, {K}) table rows "
                             "does not fit in shared memory")
        return None
    ta = fits[0]
    smem = rows_smem_bytes(ta, M, K, itemsize, lookup)
    tiles = -(-Na // ta)
    cap = int(_RESTAGE_SHARE * Nb * 4) // (M * K * itemsize)
    work = {n: -(-tiles * n // _SMS) / n
            for n in range(1, max(1, min(cap, -(-Nb // GROUP_ROWS))) + 1)}
    least = min(work.values())
    n = min(n for n, w in work.items() if w <= 1.05 * least)
    chunk = -(-(-(-Nb // n)) // GROUP_ROWS) * GROUP_ROWS
    return ScanGeometry("rows", ta, row_pitch(K, itemsize, ta), chunk, smem,
                        (-(-Nb // chunk), min(tiles, _MAX_GRID_Y)))


def sym_geometry(Na: int, Nb: int, M: int, K: int, itemsize: int,
                 ta: Optional[int] = None) -> ScanGeometry:
    """The symmetric scan's form and launch for ``(Na, M) x (Nb, M)``
    codes over an ``(M, K, K)`` table of ``itemsize``-byte entries, from
    the shapes alone: the row-staged form wherever a tile's rows fit (the
    tile and chunks as :func:`_rows_geometry` picks them), else the thread
    form (:func:`sym_thread_geometry`).  A ``ta`` that does not fit
    raises.

    >>> sym_geometry(768, 6144, 8, 256, 4)
    ScanGeometry(form='rows', ta=16, pitch=258, chunk=3072, smem=185344, grid=(2, 48))
    >>> sym_geometry(768, 6144, 8, 256, 1).grid
    (5, 24)
    >>> sym_geometry(768, 6144, 8, 1024, 4).form
    'thread'
    """
    return (_rows_geometry(Na, Nb, M, K, itemsize, ta, lookup=False)
            or sym_thread_geometry(Na, Nb, M, itemsize))


def lookup_table_geometry(Nq: int, N: int, M: int, K: int, itemsize: int
                          ) -> ScanGeometry:
    """The lookup's table form: 256 threads a block, an output a thread,
    the block's query's whole ``(M, K)`` table (and a quantised table's
    ``scale``/``zero``) in shared memory; ``grid`` ``(x, y)`` with ``y``
    walking the queries grid-stride beyond 65535 and ``x`` cut so that
    the grid holds about 4096 blocks.

    >>> lookup_table_geometry(768, 6144, 8, 256, 4).grid
    (5, 768)
    """
    smem = -(-M * K * itemsize // 4) * 4 + (8 * M if itemsize != 4 else 0)
    return ScanGeometry("table", 0, 0, _LOOKUP_THREADS, smem,
                        (min(-(-N // _LOOKUP_THREADS), max(1, 4096 // Nq)),
                         min(Nq, _MAX_GRID_Y)))


def lookup_geometry(Nq: int, N: int, M: int, K: int, itemsize: int,
                    ta: Optional[int] = None) -> ScanGeometry:
    """The lookup's form and launch for ``(N, M)`` codes against ``(Nq, M,
    K)`` query tables of ``itemsize``-byte entries, from the shapes alone:
    the row-staged form (the tile and chunks as :func:`_rows_geometry`
    picks them for the symmetric scan; a quantised table's affine is ``ta
    x M`` floats more) from ``LOOKUP_ROWS_MIN_NQ[itemsize]`` queries on
    wherever a tile's rows fit, else the table form
    (:func:`lookup_table_geometry`).  A ``ta`` forces the row-staged form
    (raises if it does not fit).

    The threshold is the crossover measured on an NVIDIA H100 80GB HBM3
    at 700 W (``chip_smoke.py``'s ``crossover_device_ms``, 6144 codes, M
    = 8, K = 256, device ms, table form / row-staged form): a row-staged
    block's work does not shrink with ``Nq``, so its time stays near
    0.015-0.023 ms while the table form's grows with ``Nq``.  f32: 128
    queries 0.0154 / 0.0219, 256 0.0251 / 0.0219; int8: 64 0.0098 /
    0.0150, 128 0.0163 / 0.0151; bf16: 128 0.0172 / 0.0233, 256 0.0290 /
    0.0234 (PERF.md §6).

    >>> lookup_geometry(768, 6144, 8, 256, 4)
    ScanGeometry(form='rows', ta=16, pitch=258, chunk=3072, smem=185344, grid=(2, 48))
    >>> lookup_geometry(768, 6144, 8, 256, 1).grid
    (5, 24)
    >>> lookup_geometry(1, 6144, 8, 256, 4).form
    'table'
    """
    geo = None
    if ta is not None or Nq >= LOOKUP_ROWS_MIN_NQ[itemsize]:
        geo = _rows_geometry(Nq, N, M, K, itemsize, ta, lookup=True)
    return geo or lookup_table_geometry(Nq, N, M, K, itemsize)


# 1/254 as float32: the reference's compiler turns its division by the
# constant 254.0 into this product
_INV_254 = torch.tensor(1.0 / 254.0, dtype=torch.float32)


def _codes(c: torch.Tensor, name: str, M: int) -> torch.Tensor:
    if c.dim() != 2 or c.shape[1] != M:
        raise ValueError(f"{name} must be (rows, {M}), got {tuple(c.shape)}")
    return c.to(torch.int32).contiguous()


class CodeRangeError(ValueError):
    """A PQ code outside ``[0, K)``: the one error the port raises for
    codes that enter the program from outside it."""


# codes known to lie in [0, K): made by the program (``note_codes``) or
# checked once already; tensor -> (K, its version counter then)
_KNOWN = WeakIdKeyDictionary()


def _version(t: torch.Tensor) -> Optional[int]:
    try:
        return t._version
    except RuntimeError:                # an inference tensor has none
        return None


def note_codes(codes: torch.Tensor, K: int) -> torch.Tensor:
    """Record that ``codes`` lie in ``[0, K)`` (the program made them, as
    ``pq.encode`` does): :func:`check_codes` then reads nothing back for
    them until they are written in place.  Returns ``codes``."""
    _KNOWN[codes] = (K, _version(codes))
    return codes


def _known(c: torch.Tensor, K: int) -> bool:
    seen = _KNOWN.get(c)
    return seen is not None and seen[0] <= K and seen[1] == _version(c)


def check_codes(K: int, **codes) -> None:
    """Raise :class:`CodeRangeError` naming the first of ``codes`` (tensors
    or numpy arrays) that holds a code outside ``[0, K)``.

    Codes are checked where they enter from outside the program (the
    public ``pq`` functions that take a caller's codes, IVF ingest,
    snapshot load) or where a wrapper's plain version reads CPU tensors;
    the ADC kernels read codes the program checked or made itself, so a
    launch on the card reads nothing back for them.  A tensor is checked
    once: codes the program made (:func:`note_codes`) or checked before
    pass without a read until they are written in place.  The other
    device tensors' extremes come back in one transfer."""
    bounds = {}
    dev = {n: c for n, c in codes.items()
           if isinstance(c, torch.Tensor) and c.numel() and not _known(c, K)}
    if dev:
        ext = torch.stack([torch.stack(torch.aminmax(c))
                           for c in dev.values()])
        # repro: ignore[RS101] codes from outside the program, checked once where they enter, never per ADC launch
        bounds.update(zip(dev, ext.tolist()))
    host = {n: np.asarray(c) for n, c in codes.items()
            if not isinstance(c, torch.Tensor)}
    host = {n: c for n, c in host.items() if c.size}
    # repro: ignore[RS101] numpy arrays on the host (snapshot load, IVF ingest): nothing on a device
    bounds.update((n, (int(c.min()), int(c.max()))) for n, c in host.items())
    for name in codes:
        lo, hi = bounds.get(name, (0, 0))
        if lo < 0 or hi >= K:
            raise CodeRangeError(f"{name} holds codes outside [0, {K})")
    for name in dev:
        note_codes(codes[name], K)


def _table(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _type_tag(table: torch.Tensor) -> str:
    """The tuning key's measure slot of an ADC scan: its table's type."""
    return {torch.int8: "int8", torch.bfloat16: "bf16"}.get(table.dtype,
                                                            "f32")


def _tuned_ta(op: str, geo: ScanGeometry, K: int, table: torch.Tensor,
              out: torch.Tensor, launch, fits) -> int:
    """The row-staged form's tile from the tuning table (``op``'s ``ta``,
    keyed by ``K`` and the table's type), the selector's as the default;
    ``launch(ta, out)`` runs the scan at tile ``ta`` into ``out``,
    ``fits(ta)`` raises ``ValueError`` where the call's shapes (``M``
    too, which the key lacks) leave no room for tile ``ta``."""
    def runner(params):
        fresh = torch.empty_like(out)
        launch(params["ta"], fresh)
        return (fresh,)
    return tune.tuned(op, "ta", length=K, window=None,
                      measure=_type_tag(table), default=geo.ta,
                      runner=runner, device=out.device, check=fits)


def _launch_sym(name: str, ca: torch.Tensor, cb: torch.Tensor,
                table: torch.Tensor, scale: Optional[torch.Tensor],
                zero: Optional[torch.Tensor], out: torch.Tensor,
                ta: Optional[int] = None) -> None:
    """Launch the symmetric scan in the form :func:`sym_geometry` picks;
    the row-staged form at tile ``ta`` if given, else at the tuned tile
    (:mod:`..tune`, ``adc_sym``)."""
    (Na, M), Nb, K = ca.shape, cb.shape[0], table.shape[1]
    geo = sym_geometry(Na, Nb, M, K, table.element_size(), ta)
    if geo.form == "rows" and ta is None:
        best = _tuned_ta("adc_sym", geo, K, table, out, lambda t, o:
                         _launch_sym(name, ca, cb, table, scale, zero, o, t),
                         lambda t: sym_geometry(Na, Nb, M, K,
                                                table.element_size(), t))
        if best != geo.ta:
            geo = sym_geometry(Na, Nb, M, K, table.element_size(), best)
    lib, stream = _build.lib(), _build.stream(out.device)
    if geo.form == "rows":
        status = lib.pq_adc_sym_rows(
            ca.data_ptr(), cb.data_ptr(), table.data_ptr(), _build.ptr(scale),
            _build.ptr(zero), out.data_ptr(), Na, Nb, M, K,
            TABLE_TYPES[table.dtype], geo.ta, geo.pitch, geo.chunk,
            geo.grid[1], stream)
    elif scale is None:
        status = lib.pq_adc_sym(
            ca.data_ptr(), cb.data_ptr(), table.data_ptr(), out.data_ptr(),
            Na, Nb, M, K, geo.grid[1], stream)
    else:
        status = lib.pq_adc_sym_quant(
            ca.data_ptr(), cb.data_ptr(), table.data_ptr(), scale.data_ptr(),
            zero.data_ptr(), out.data_ptr(), Na, Nb, M, K,
            _QUANT_TYPES[table.dtype], geo.grid[1], stream)
    _build.check(status, name)
    _build.count_launch(name)


def launch_adc_sym(ca: torch.Tensor, cb: torch.Tensor, lut: torch.Tensor,
                   out: torch.Tensor) -> None:
    """Launch the symmetric kernel into ``out (Na, Nb)``: contiguous int32
    codes in range, a contiguous float32 LUT, all on one CUDA device."""
    _launch_sym("adc_sym", ca, cb, lut, None, None, out)


def _launch_lookup(name: str, c: torch.Tensor, q: torch.Tensor,
                   scale: Optional[torch.Tensor],
                   zero: Optional[torch.Tensor], out: torch.Tensor,
                   ta: Optional[int] = None) -> None:
    """Launch the lookup in the form :func:`lookup_geometry` picks; the
    row-staged form at tile ``ta`` if given, else (where the selector
    picks that form) at the tuned tile (:mod:`..tune`, ``adc_lookup``)."""
    (Nq, M, K), N = q.shape, c.shape[0]
    geo = lookup_geometry(Nq, N, M, K, q.element_size(), ta)
    if geo.form == "rows" and ta is None:
        best = _tuned_ta("adc_lookup", geo, K, q, out, lambda t, o:
                         _launch_lookup(name, c, q, scale, zero, o, t),
                         lambda t: lookup_geometry(Nq, N, M, K,
                                                   q.element_size(), t))
        if best != geo.ta:
            geo = lookup_geometry(Nq, N, M, K, q.element_size(), best)
    lib, stream = _build.lib(), _build.stream(out.device)
    if geo.form == "rows":
        status = lib.pq_adc_lookup_rows(
            q.data_ptr(), _build.ptr(scale), _build.ptr(zero), c.data_ptr(),
            out.data_ptr(), Nq, N, M, K, TABLE_TYPES[q.dtype], geo.ta,
            geo.pitch, geo.chunk, geo.grid[1], stream)
    elif scale is None:
        status = lib.pq_adc_lookup(
            q.data_ptr(), c.data_ptr(), out.data_ptr(), Nq, N, M, K,
            geo.chunk, *geo.grid, stream)
    else:
        status = lib.pq_adc_lookup_quant(
            q.data_ptr(), scale.data_ptr(), zero.data_ptr(), c.data_ptr(),
            out.data_ptr(), Nq, N, M, K, _QUANT_TYPES[q.dtype], geo.chunk,
            *geo.grid, stream)
    _build.check(status, name)
    _build.count_launch(name)


def launch_adc_lookup(c: torch.Tensor, q: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Launch the lookup kernel into ``out (Nq, N)``: contiguous int32 codes
    in range, contiguous float32 tables ``(Nq, M, K)``, one CUDA device."""
    _launch_lookup("adc_lookup", c, q, None, None, out)


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
    if dev is None:
        check_codes(K, codes_a=ca, codes_b=cb)
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
    if dev is None:
        check_codes(K, codes=c)
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
    # a CPU scalar: a CUDA product reads it on the host, no upload
    scale = torch.clamp(hi - lo, min=1e-12) * _INV_254
    q = torch.clamp(torch.round((flat - zero) / scale), -127, 127)
    return q.to(torch.int8).reshape(lut.shape), scale, zero


def _quant_table(q: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 4-byte-aligned address (the row-staged form copies
    the table in 4-byte words): a view at an odd offset is copied."""
    if q.dtype not in _QUANT_TYPES:
        raise ValueError(f"a quantised table is int8 or bfloat16, got "
                         f"{q.dtype}")
    q = q.contiguous()
    return q.clone() if q.data_ptr() % 4 else q


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
    checked codes, an int8/bf16 ``(M, K, K)`` table at a 4-byte-aligned
    address, ``scale``/``zero (M,)`` float32, all on one CUDA device."""
    _launch_sym("adc_sym_quant", ca, cb, q, scale, zero, out)


def launch_adc_lookup_quant(c: torch.Tensor, q: torch.Tensor,
                            scale: torch.Tensor, zero: torch.Tensor,
                            out: torch.Tensor) -> None:
    """Launch the quantised lookup kernel into ``out (Nq, N)``: checked
    codes, int8/bf16 tables ``(Nq, M, K)`` at a 4-byte-aligned address,
    ``scale``/``zero (Nq * M,)`` float32, all on one CUDA device."""
    _launch_lookup("adc_lookup_quant", c, q, scale, zero, out)


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
    if dev is None:
        check_codes(K, codes_a=ca, codes_b=cb)
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
    if dev is None:
        check_codes(K, codes=c)
        out = adc_lookup_quant_ref(c, qb, scale.reshape(Nq, M, 1),
                                   zero.reshape(Nq, M, 1))
        return out[0] if single else out
    if M * K * qb.element_size() + 2 * M * 4 > _SMEM_MAX:
        raise ValueError(f"a ({M}, {K}) query table exceeds shared memory")
    out = torch.empty((Nq, c.shape[0]), dtype=torch.float32, device=dev)
    if out.numel():
        launch_adc_lookup_quant(c, qb, scale, zero, out)
    return out[0] if single else out
