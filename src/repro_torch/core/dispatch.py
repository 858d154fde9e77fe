"""Dispatch for every elastic / ADC hot path of the port (counterpart of
:mod:`repro.core.dispatch`, with the reference's op names):

    elastic_pairwise(A, B, window)   zipped pairs          -> (N,)
    elastic_cdist(A, B, window)      all pairs             -> (N, M)
    adc_cdist(codes_a, codes_b, lut) symmetric ADC         -> (Na, Nb)
    adc_lookup(codes, qlut)          asymmetric scan       -> (N,) / (Nq, N)
    prealign_encode(X, centroids)    fused MODWT prealign
                                     + elastic-1NN encode  -> (N, M) codes

The route follows the tensors' device, with no environment variable:
CUDA tensors launch the hand-written kernels (route ``"cuda"``), CPU
tensors take their plain PyTorch versions (route ``"torch"``).  The
:data:`stats` / :data:`totals` ledgers count ``(op, route)`` and, for
measure-parameterised ops, ``(op[measure], route)`` per call;
:func:`reset_stats` clears :data:`stats` only.

Not ported yet (later slices): ``band="adaptive"``, quantised LUTs
(``lut_dtype != "float32"``), ``lb_refine`` and ``two_level_coarse``.

Window contract: ``window=None`` means unbanded, i.e. a band of ``L - 1``;
:func:`effective_window` clamps every materialised window to
``[0, L - 1]``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import measures
from .measures import MeasureArg, MeasureSpec

__all__ = [
    "elastic_pairwise", "elastic_cdist", "adc_cdist", "adc_lookup",
    "prealign_encode", "lb_refine", "two_level_coarse", "stats", "totals",
    "reset_stats", "effective_window",
]

stats: Dict[Tuple[str, str], int] = {}
totals: Dict[Tuple[str, str], int] = {}


def effective_window(length: int, window: Optional[int]) -> int:
    """``None`` -> ``length - 1``; everything clamped to ``[0, length-1]``.

    >>> effective_window(128, None), effective_window(128, 500)
    (127, 127)
    """
    w = length - 1 if window is None else int(window)
    return max(0, min(w, length - 1))


def reset_stats() -> None:
    """Clear the per-run :data:`stats` ledger (:data:`totals` stays)."""
    stats.clear()


def _route(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else "torch"


def _count(op: str, route: str,
           measure: Optional[MeasureSpec] = None) -> None:
    keys = [(op, route)]
    if measure is not None:
        keys.append((f"{op}[{measure.name}]", route))
    for key in keys:
        stats[key] = stats.get(key, 0) + 1
        totals[key] = totals.get(key, 0) + 1


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet")


def elastic_pairwise(A: torch.Tensor, B: torch.Tensor,
                     window: Optional[int] = None, *,
                     measure: MeasureArg = None,
                     band: str = "static") -> torch.Tensor:
    """Elastic cost over zipped pairs: ``(N, L) x (N, L) -> (N,)``."""
    from ..kernels.dtw_band.ops import dtw_band
    if band != "static":
        raise _not_ported(f"band={band!r}")
    spec = measures.resolve(measure)
    _count("elastic_pairwise", _route(A), spec)
    return dtw_band(A, B, window, spec)


def elastic_cdist(A: torch.Tensor, B: torch.Tensor,
                  window: Optional[int] = None, *,
                  measure: MeasureArg = None) -> torch.Tensor:
    """All-pairs elastic cost: ``(N, L) x (M, L) -> (N, M)``."""
    from ..kernels.dtw_band.ops import dtw_band_cdist
    spec = measures.resolve(measure)
    _count("elastic_cdist", _route(A), spec)
    return dtw_band_cdist(A, B, window, spec)


def adc_cdist(codes_a: torch.Tensor, codes_b: torch.Tensor,
              lut: torch.Tensor, *,
              lut_dtype: str = "float32") -> torch.Tensor:
    """Symmetric PQ distance matrix ``sqrt(sum_m LUT[m, a^m, b^m])``."""
    from ..kernels.pq_adc.ops import adc_sym_cdist
    if lut_dtype != "float32":
        raise _not_ported(f"lut_dtype={lut_dtype!r}")
    _count("adc_cdist", _route(lut))
    return adc_sym_cdist(codes_a, codes_b, lut)


def adc_lookup(codes: torch.Tensor, qlut: torch.Tensor, *,
               lut_dtype: str = "float32") -> torch.Tensor:
    """Asymmetric ADC scan: ``codes (N, M)`` against ``qlut (M, K)`` ->
    ``(N,)``, or against ``(Nq, M, K)`` query tables -> ``(Nq, N)``."""
    from ..kernels.pq_adc.ops import adc_lookup as _adc_lookup
    if lut_dtype != "float32":
        raise _not_ported(f"lut_dtype={lut_dtype!r}")
    _count("adc_lookup", _route(qlut))
    return _adc_lookup(codes, qlut)


def prealign_encode(X: torch.Tensor, centroids: torch.Tensor, *,
                    level: int, tail: int, window: Optional[int] = None,
                    measure: MeasureArg = None) -> torch.Tensor:
    """Fused MODWT prealign + exact elastic-1NN encode: ``X (N, D)``
    against ``centroids (M, K, S)`` -> codes ``(N, M)`` int32."""
    from ..kernels.prealign_encode.ops import (
        prealign_encode as _prealign_encode)
    spec = measures.resolve(measure)
    _count("prealign_encode", _route(X), spec)
    return _prealign_encode(X, centroids, level, tail, window, spec)


def lb_refine(*args, **kwargs):
    """Fused LB cascade + conditional refine: a later slice."""
    raise _not_ported("lb_refine")


def two_level_coarse(*args, **kwargs):
    """Hierarchical IVF coarse stage: a later slice."""
    raise _not_ported("two_level_coarse")
