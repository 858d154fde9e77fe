"""Dispatch for every elastic / ADC hot path of the port (counterpart of
:mod:`repro.core.dispatch`, with the reference's op names):

    elastic_pairwise(A, B, window)   zipped pairs          -> (N,)
    elastic_cdist(A, B, window)      all pairs             -> (N, M)
    adc_cdist(codes_a, codes_b, lut) symmetric ADC         -> (Na, Nb)
    adc_lookup(codes, qlut)          asymmetric scan       -> (N,) / (Nq, N)
    prealign_encode(X, centroids)    fused MODWT prealign
                                     + elastic-1NN encode  -> (N, M) codes
    lb_refine(A, B, up, lo, thresh)  fused LB cascade +
                                     conditional DTW refine -> (N,), (N,)
    lb_filter(segs, centroids, up, lo, T)
                                     the encode's LB filter:
                                     bounds + stable top-T -> (N, M, T),
                                                              (N, M)
    two_level_coarse(Q, top, coarse, child_idx, child_valid)
                                     hierarchical coarse
                                     rank + child fan-out  -> (Nq, n_lists)

The route follows the tensors' device, with no environment variable:
CUDA tensors launch the hand-written kernels (route ``"cuda"``), CPU
tensors take their plain PyTorch versions (route ``"torch"``).  The
:data:`stats` / :data:`totals` ledgers count ``(op, route)`` and, for
measure-parameterised ops, ``(op[measure], route)`` per call;
:func:`reset_stats` clears :data:`stats` only.  Every count is mirrored
into the observability registry as a persistent ``dispatch_total``
counter labeled ``kind="call"``: the port runs eagerly and counts each
call, where the reference counts each *trace* (``kind="trace"``).

Opt-in layers, ledgered under their own names: ``band="adaptive"``
(``elastic_pairwise_adaptive``, ``lb_refine_adaptive``) sweeps per-pair
corridors from :mod:`.corridor`, an approximate upper bound of the static
cost that is exact where the corridor holds the static optimal path;
``lut_dtype="int8"`` / ``"bfloat16"`` (``adc_cdist_quant``,
``adc_lookup_quant``) scans quantised tables from
:func:`repro_torch.kernels.pq_adc.ops.quantize_lut`.  The adaptive
register width is the reference's lane-8 width on every device
(:func:`repro_torch.kernels.tune.adaptive_width`): a clipped corridor
depends on it.

Window contract: ``window=None`` means unbanded, i.e. a band of ``L - 1``;
:func:`effective_window` clamps every materialised window to
``[0, L - 1]``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from ..obs import registry as _obs_registry
from . import measures
from .measures import MeasureArg, MeasureSpec
from .topk import smallest_k

__all__ = [
    "elastic_pairwise", "elastic_cdist", "adc_cdist", "adc_lookup",
    "prealign_encode", "lb_refine", "lb_filter", "two_level_coarse",
    "stats", "totals", "reset_stats", "effective_window",
]

stats: Dict[Tuple[str, str], int] = {}
totals: Dict[Tuple[str, str], int] = {}
_count_lock = threading.Lock()


def effective_window(length: int, window: Optional[int]) -> int:
    """``None`` -> ``length - 1``; everything clamped to ``[0, length-1]``.

    >>> effective_window(128, None), effective_window(128, 500)
    (127, 127)
    """
    w = length - 1 if window is None else int(window)
    return max(0, min(w, length - 1))


def reset_stats() -> None:
    """Clear the per-run :data:`stats` ledger (:data:`totals` stays)."""
    with _count_lock:
        stats.clear()


def _route(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else "torch"


def _count(op: str, route: str,
           measure: Optional[MeasureSpec] = None) -> None:
    keys = [(op, route)]
    if measure is not None:
        keys.append((f"{op}[{measure.name}]", route))
    labels = {"op": op, "backend": route, "kind": "call"}
    if measure is not None:
        labels["measure"] = measure.name
    counter = _obs_registry.REGISTRY.counter("dispatch_total",
                                             persistent=True, **labels)
    # a server's threads dispatch concurrently: the read-modify-writes of
    # the ledgers and the counter must not interleave
    with _count_lock:
        for key in keys:
            # repro: ignore[RS104] the routing ledger counts every eager call
            stats[key] = stats.get(key, 0) + 1
            # repro: ignore[RS104] ... and its process-lifetime totals
            totals[key] = totals.get(key, 0) + 1
        counter.inc()


def _bad_band(band: str):
    return ValueError(f"unknown band mode {band!r}; "
                      "expected 'static' or 'adaptive'")


def _adaptive_corridor(A: torch.Tensor, B: torch.Tensor,
                       window: Optional[int], spec: MeasureSpec,
                       corridor, width: Optional[int], factor: int,
                       radius: int):
    """The clipped corridor ``(lo, hi)`` and the register width of an
    adaptive sweep: the corridor is built from a coarse pass unless given,
    the width is the tuned lane-8 cap unless given."""
    from ..kernels import tune
    from . import corridor as corr
    if width is None:
        width = tune.adaptive_width(A.shape[-1], window, 8,
                                    measure=spec.name, backend=_route(A),
                                    factor=factor, radius=radius)
    if corridor is None:
        corridor = corr.build_corridor(A, B, window, factor=factor,
                                       radius=radius)
    return corr.clip_to_width(*corridor, width), width


def elastic_pairwise(A: torch.Tensor, B: torch.Tensor,
                     window: Optional[int] = None, *,
                     measure: MeasureArg = None,
                     band: str = "static",
                     corridor: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                     corridor_factor: int = 8, corridor_radius: int = 2,
                     width: Optional[int] = None) -> torch.Tensor:
    """Elastic cost over zipped pairs: ``(N, L) x (N, L) -> (N,)``.

    ``band="adaptive"`` sweeps each pair's own corridor (built here from a
    coarse PAA pass unless ``corridor=(lo, hi)`` is given): bit-identical
    to the static band where the corridor contains the static optimal
    path, a documented approximate upper bound elsewhere.

    >>> A, B = torch.zeros(2, 8), torch.ones(2, 8)
    >>> elastic_pairwise(A, B, 2).tolist()              # 8 unit squares
    [8.0, 8.0]
    >>> elastic_pairwise(A, B, 2, band="adaptive").tolist()
    [8.0, 8.0]
    """
    from ..kernels.dtw_band.ops import dtw_band, dtw_band_adaptive
    spec = measures.resolve(measure)
    if band == "static":
        _count("elastic_pairwise", _route(A), spec)
        return dtw_band(A, B, window, spec)
    if band != "adaptive":
        raise _bad_band(band)
    _count("elastic_pairwise_adaptive", _route(A), spec)
    cor, width = _adaptive_corridor(A, B, window, spec, corridor, width,
                                    corridor_factor, corridor_radius)
    return dtw_band_adaptive(A, B, cor, width, window, spec)


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
    """Symmetric PQ distance matrix ``sqrt(sum_m LUT[m, a^m, b^m])``.

    ``lut_dtype="int8"`` / ``"bfloat16"`` quantises the table per subspace
    (:func:`~repro_torch.kernels.pq_adc.ops.quantize_lut`) and scans it;
    the result stays within the quantisation step of float32.

    >>> codes = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    >>> lut = torch.stack([1.0 - torch.eye(2)] * 2)   # (M=2, K=2, K=2)
    >>> [round(x, 3) for x in adc_cdist(codes, codes, lut).flatten().tolist()]
    [0.0, 1.414, 1.414, 0.0]
    >>> Dq = adc_cdist(codes, codes, lut, lut_dtype="int8")
    >>> [round(x, 2) for x in Dq.flatten().tolist()]
    [0.0, 1.41, 1.41, 0.0]
    """
    from ..kernels.pq_adc.ops import (adc_sym_cdist, adc_sym_cdist_quant,
                                      quantize_lut)
    if lut_dtype != "float32":
        _count("adc_cdist_quant", _route(lut))
        q, scale, zero = quantize_lut(lut, lut_dtype)
        return adc_sym_cdist_quant(codes_a, codes_b, q, scale, zero)
    _count("adc_cdist", _route(lut))
    return adc_sym_cdist(codes_a, codes_b, lut)


def adc_lookup(codes: torch.Tensor, qlut: torch.Tensor, *,
               lut_dtype: str = "float32") -> torch.Tensor:
    """Asymmetric ADC scan: ``codes (N, M)`` against ``qlut (M, K)`` ->
    ``(N,)``, or against ``(Nq, M, K)`` query tables -> ``(Nq, N)``.

    ``lut_dtype`` as in :func:`adc_cdist`; each query's ``(M, K)`` table
    is quantised on its own, as the reference quantises one query's.
    """
    from ..kernels.pq_adc.ops import adc_lookup as _adc_lookup
    from ..kernels.pq_adc.ops import adc_lookup_quant, quantize_lut
    if lut_dtype != "float32":
        _count("adc_lookup_quant", _route(qlut))
        if qlut.dim() == 3:
            Nq, M, K = qlut.shape
            q, scale, zero = quantize_lut(qlut.reshape(Nq * M, K), lut_dtype)
            q = q.reshape(Nq, M, K)
            scale, zero = scale.reshape(Nq, M, 1), zero.reshape(Nq, M, 1)
        else:
            q, scale, zero = quantize_lut(qlut, lut_dtype)
        return adc_lookup_quant(codes, q, scale, zero)
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


def lb_refine(A: torch.Tensor, B: torch.Tensor, upper: torch.Tensor,
              lower: torch.Tensor, thresh: torch.Tensor,
              window: Optional[int] = None, *,
              measure: MeasureArg = None,
              band: str = "static",
              corridor: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              corridor_factor: int = 8, corridor_radius: int = 2,
              width: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused cascade bound + conditional banded refine over zipped pairs:
    ``A (N, L)`` queries, ``B (N, L)`` candidates, ``upper``/``lower
    (N, L)`` Keogh envelopes of ``A``, ``thresh (N,)``.

    Returns ``(d (N,), refined (N,) bool)``: ``d`` is the exact banded
    elastic cost where ``max(LB_Kim, LB_Keogh) < thresh`` and the (valid)
    lower bound elsewhere.  On the card a pruned pair never sweeps its
    band.  Only sound for measures with ``has_keogh_lb`` (a hard error
    otherwise: :func:`repro_torch.core.lb_search.filtered_topk` takes the
    exact dense path for them before reaching here).

    ``band="adaptive"`` refines inside each pair's corridor (built here
    unless ``corridor=(lo, hi)`` is given): the bound is unchanged, the
    refined value is the corridor-restricted cost, an upper bound of the
    static cost, so the adaptive cascade is approximate (ledgered as
    ``lb_refine_adaptive``).

    >>> A, B = torch.zeros(2, 8), torch.ones(2, 8)
    >>> env = torch.zeros(2, 8)                    # degenerate envelopes
    >>> d, refined = lb_refine(A, B, env, env, torch.tensor([100.0, 0.0]),
    ...                        window=2)
    >>> refined.tolist(), float(d[0])              # row 1 pruned by bound
    ([True, False], 8.0)
    """
    from ..kernels.lb_cascade.ops import lb_refine as _lb_refine
    spec = measures.resolve(measure)
    if not spec.has_keogh_lb:
        raise ValueError(
            f"measure {spec.name!r} has no sound Keogh/Kim lower bound; "
            "lb_refine would prune incorrectly — use the exact dense path")
    if band == "static":
        _count("lb_refine", _route(A), spec)
        return _lb_refine(A, B, upper, lower, thresh, window, spec)
    if band != "adaptive":
        raise _bad_band(band)
    _count("lb_refine_adaptive", _route(A), spec)
    cor, width = _adaptive_corridor(A, B, window, spec, corridor, width,
                                    corridor_factor, corridor_radius)
    return _lb_refine(A, B, upper, lower, thresh, window, spec,
                      corridor=cor, width=width)


def lb_filter(segs: torch.Tensor, centroids: torch.Tensor,
              upper: torch.Tensor, lower: torch.Tensor, refine_t: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encode's LB filter: ``segs (N, M, S)`` against ``centroids (M,
    K, S)`` with their Keogh envelopes ``upper``/``lower (M, K, S)``.

    Returns ``(cand (N, M, T) int64, next_lb (N, M) float32)``: per series
    and subspace the ``T = refine_t`` centroids of smallest
    ``max(LB_Kim, LB_Keogh)``, lower index first among equal bounds (a
    stable sort's order, as ``jax.lax.top_k``), and the (T+1)-th smallest
    bound, which the encode's soundness certificate reads.  On the card
    one launch of ``lb_filter_topk_kernel``.

    >>> segs = torch.tensor([[[0.0, 0.0]]])            # (N=1, M=1, S=2)
    >>> cents = torch.tensor([[[3.0, 3.0], [1.0, 1.0], [1.0, 1.0]]])
    >>> cand, next_lb = lb_filter(segs, cents, cents, cents, 2)
    >>> cand.tolist(), next_lb.tolist()                # ties: lower first
    ([[[1, 2]]], [[18.0]])
    """
    from ..kernels.lb_cascade.ops import lb_filter as _lb_filter
    _count("lb_filter", _route(segs))
    return _lb_filter(segs, centroids, upper, lower, refine_t)


def two_level_coarse(Q: torch.Tensor, top: torch.Tensor,
                     coarse: torch.Tensor, child_idx: torch.Tensor,
                     child_valid: torch.Tensor,
                     window: Optional[int] = None, *, n_probe_top: int,
                     measure: MeasureArg = None) -> torch.Tensor:
    """Hierarchical (two-level) coarse stage for large ``n_lists``.

    ``Q (Nq, D)`` is ranked against the ``top (n_top, D)`` quantizer (one
    all-pairs launch); only the children of each query's ``n_probe_top``
    nearest top cells — ``child_idx`` / ``child_valid (n_top,
    max_children)`` into ``coarse (n_lists, D)`` — are evaluated exactly,
    as one zipped-pairs launch.  Returns ``(Nq, n_lists)`` coarse
    distances, ``+inf`` for lists outside the fan-out.  With
    ``n_probe_top == n_top`` every list is visited and the result equals
    the flat coarse cdist.

    >>> coarse = torch.arange(4, dtype=torch.float32)[:, None] * torch.ones(8)
    >>> top = torch.tensor([[0.5] * 8, [2.5] * 8])  # parents of {0,1}, {2,3}
    >>> child_idx = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    >>> dc = two_level_coarse(torch.zeros(1, 8), top, coarse, child_idx,
    ...                       torch.ones(2, 2, dtype=torch.bool),
    ...                       n_probe_top=1)
    >>> torch.isfinite(dc[0]).tolist(), float(dc[0, 0])
    ([True, True, False, False], 0.0)
    """
    n_top, C = child_idx.shape
    if not 1 <= n_probe_top <= n_top:
        raise ValueError(
            f"n_probe_top={n_probe_top} out of range: must satisfy "
            f"1 <= n_probe_top <= n_top={n_top}")
    spec = measures.resolve(measure)
    Q = Q.to(torch.float32)
    _count("two_level_coarse", _route(Q), spec)
    Nq = Q.shape[0]
    n_lists = coarse.shape[0]
    dc_top = elastic_cdist(Q, top, window, measure=spec)
    _, tops = smallest_k(dc_top, n_probe_top)
    child_idx = child_idx.long()
    cand = child_idx[tops].reshape(Nq, n_probe_top * C)
    cvalid = child_valid[tops].reshape(Nq, n_probe_top * C)
    cents = coarse[cand.reshape(-1)]
    qq = Q.repeat_interleave(n_probe_top * C, dim=0)
    d = elastic_pairwise(qq, cents, window, measure=spec)
    d = torch.where(cvalid.reshape(-1), d,
                    torch.full_like(d, float("inf"))).reshape(Nq, -1)
    dc = torch.full((Nq, n_lists), float("inf"), dtype=torch.float32,
                    device=Q.device)
    # scatter-min: a list reachable through two probed tops keeps one
    # (identical) distance; masked padding lanes are +inf no-ops
    return dc.scatter_reduce(1, cand, d, reduce="amin")
