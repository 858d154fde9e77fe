"""PQDTW — the paper's product quantizer for time series under DTW
(PyTorch counterpart of :mod:`repro.core.pq`).

Training (Alg. 1): segment -> per-subspace DBA k-means -> the M x K x K
symmetric LUT and the Keogh envelope of every centroid.

Encoding (Alg. 2): per subspace, elastic 1-NN against the K centroids,
either LB-filtered (``max(LB_Kim, LB_Keogh)`` for all K, then the exact
banded cost of the T most promising) or, with ``exact_encode``, a full
scan fused with the MODWT pre-alignment in one kernel.

Distances (§3.3): symmetric = M LUT gathers + sum; asymmetric = one
M x K elastic table per query, then gathers.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Every elastic evaluation and every ADC scan goes through
:mod:`.dispatch`, so on the card it runs in the hand-written kernels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _device
from ..kernels.pq_adc.ops import check_codes, note_codes
from ..obs import span
from . import measures as measures_mod
from .dispatch import (adc_cdist, adc_lookup, elastic_cdist,
                       elastic_pairwise, lb_filter, prealign_encode)
from .dtw import euclidean_sq
from .kmeans import dba_kmeans, euclidean_kmeans
from .lb import keogh_envelope, lb_keogh
from .lb_search import BOUND_CHUNK_BYTES
from .measures import MeasureSpec, sqrt_rn
from .modwt import fixed_segments, prealign

__all__ = ["PQConfig", "PQCodebook", "segment", "fit", "encode",
           "codebook_from_centroids", "encode_with_stats",
           "lb_filter_pairs", "query_lut", "query_lut_batch", "adc_gather",
           "cdist_sym", "cdist_asym", "cdist_sym_refined", "memory_cost",
           "uses_fused_prealign", "codebook_from_numpy", "codebook_to_numpy"]


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Hyper-parameters of the product quantizer (paper §3 + §5), the same
    fields and derived sizes as the reference's ``PQConfig``.

    >>> cfg = PQConfig(n_sub=2, codebook_size=4, use_prealign=False)
    >>> cfg.subseq_len(8), cfg.tail(8), cfg.window(8)
    (4, 1, 1)
    """
    n_sub: int = 8              # M: number of subspaces
    codebook_size: int = 256    # K
    window_frac: float = 0.1    # Sakoe-Chiba band, fraction of subseq length
    metric: str = "dtw"         # elastic measure name or "euclidean"
    measure_params: Tuple[Tuple[str, float], ...] = ()
    use_prealign: bool = True   # MODWT pre-alignment (§3.5)
    wavelet_level: int = 3      # J
    tail_frac: float = 0.15     # t, fraction of D/M
    snap_tail: Optional[int] = None  # explicit t in samples
    kmeans_iters: int = 8
    dba_iters: int = 2
    refine_frac: float = 0.125  # T/K for filter-then-refine encoding
    exact_encode: bool = False  # disable the LB filter
    fused_encode: bool = True   # exact prealigned encodes take the fused
                                # MODWT+encode kernel

    def __post_init__(self):
        params = tuple(sorted((str(k), float(v)) for k, v in
                              dict(self.measure_params or ()).items()))
        object.__setattr__(self, "measure_params", params)
        if self.metric != "euclidean":
            measures_mod.get_measure(self.metric, **dict(params))  # validate

    @property
    def is_elastic(self) -> bool:
        return self.metric != "euclidean"

    def measure(self) -> Optional[MeasureSpec]:
        """The elastic measure spec, or None under the euclidean baseline."""
        if not self.is_elastic:
            return None
        return measures_mod.get_measure(self.metric,
                                        **dict(self.measure_params))

    def subseq_len(self, D: int) -> int:
        base = D // self.n_sub
        return base + self.tail(D) if (self.use_prealign and self.is_elastic) else base

    def tail(self, D: int) -> int:
        if self.snap_tail is not None:
            return int(self.snap_tail)
        return max(1, int(round(self.tail_frac * (D // self.n_sub))))

    def window(self, D: int) -> Optional[int]:
        if not self.is_elastic:
            return None
        return max(1, int(round(self.window_frac * self.subseq_len(D))))

    def refine_t(self) -> int:
        return max(1, int(round(self.refine_frac * self.codebook_size)))

    def full_scan_encode(self) -> bool:
        """True when encoding is an exact full scan of every centroid."""
        if self.exact_encode or self.refine_t() >= self.codebook_size:
            return True
        spec = self.measure()
        return spec is not None and not spec.has_keogh_lb


class PQCodebook(NamedTuple):
    """Trained quantizer state (tensors on one device)."""
    centroids: torch.Tensor   # (M, K, S) float32
    lut: torch.Tensor         # (M, K, K) squared elastic distance
    env_upper: torch.Tensor   # (M, K, S)
    env_lower: torch.Tensor   # (M, K, S)

    @property
    def n_sub(self) -> int:
        return self.centroids.shape[0]

    @property
    def codebook_size(self) -> int:
        return self.centroids.shape[1]

    @property
    def subseq_len(self) -> int:
        return self.centroids.shape[2]


def codebook_from_numpy(cb, device: _device.DeviceArg = None) -> PQCodebook:
    """Carry a trained codebook in: any 4-sequence ``(centroids, lut,
    env_upper, env_lower)`` of arrays, e.g. the reference's ``PQCodebook``
    or :func:`codebook_to_numpy`'s result, onto ``device``."""
    return _codebook_on(cb, _device.resolve_device(device))


def codebook_to_numpy(cb: PQCodebook) -> PQCodebook:
    """The codebook's four tensors as float32 numpy arrays."""
    return PQCodebook(*(f.detach().cpu().numpy() for f in cb))


def _codebook_on(cb: PQCodebook, dev: torch.device) -> PQCodebook:
    return PQCodebook(*(_device.to_tensor(f, dev, torch.float32)
                        for f in cb))


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------

def segment(X: torch.Tensor, cfg: PQConfig) -> torch.Tensor:
    """``X (N, D)`` -> ``(N, M, S)`` subsequences (pre-aligned or fixed)."""
    D = X.shape[-1]
    if cfg.use_prealign and cfg.is_elastic:
        return prealign(X, cfg.n_sub, cfg.wavelet_level, cfg.tail(D))
    return fixed_segments(X, cfg.n_sub)


# ---------------------------------------------------------------------------
# Training (Algorithm 1)
# ---------------------------------------------------------------------------

def fit(X, cfg: PQConfig, generator: Optional[torch.Generator] = None, *,
        init_centroids=None,
        device: _device.DeviceArg = None) -> PQCodebook:
    """Learn the codebook, LUT and envelopes from training series
    ``X (N, D)``.  The initial centroids are ``init_centroids (M, K, S)``
    when given, else drawn per subspace with ``generator``.

    >>> cfg = PQConfig(n_sub=2, codebook_size=2, use_prealign=False,
    ...                kmeans_iters=1, dba_iters=1)
    >>> X = torch.arange(32, dtype=torch.float32).reshape(4, 8) / 10.0
    >>> cb = fit(X, cfg, torch.Generator().manual_seed(0), device="cpu")
    >>> tuple(cb.centroids.shape), tuple(cb.lut.shape)
    ((2, 2, 4), (2, 2, 2))
    """
    dev = _device.resolve_device(device)
    X = _device.to_tensor(X, dev, torch.float32)
    D = X.shape[-1]
    segs = segment(X, cfg)                       # (N, M, S)
    window = cfg.window(D)
    if init_centroids is not None:
        init_centroids = _device.to_tensor(init_centroids, dev,
                                           torch.float32)
    spec = cfg.measure()
    cents = []
    for m in range(cfg.n_sub):
        sub = segs[:, m, :].contiguous()
        init = None if init_centroids is None else init_centroids[m]
        if cfg.is_elastic:
            res = dba_kmeans(sub, cfg.codebook_size, iters=cfg.kmeans_iters,
                             dba_iters=cfg.dba_iters, window=window,
                             measure=spec, init=init, generator=generator)
        else:
            res = euclidean_kmeans(sub, cfg.codebook_size,
                                   iters=cfg.kmeans_iters, init=init,
                                   generator=generator)
        cents.append(res.centroids)
    return codebook_from_centroids(torch.stack(cents), cfg, D)


def codebook_from_centroids(centroids: torch.Tensor, cfg: PQConfig,
                            D: int) -> PQCodebook:
    """The codebook of trained ``centroids (M, K, S)`` for series of
    length ``D``: each subspace's symmetric LUT (the elastic cost at
    ``cfg.window(D)``, or the squared Euclidean distance) and the Keogh
    envelopes, on the centroids' device.

    >>> cfg = PQConfig(n_sub=1, codebook_size=2, use_prealign=False)
    >>> cb = codebook_from_centroids(torch.tensor([[[0.0, 1.0],
    ...                                             [1.0, 1.0]]]), cfg, 2)
    >>> cb.lut[0].tolist()
    [[0.0, 1.0], [1.0, 0.0]]
    """
    window, spec = cfg.window(D), cfg.measure()
    luts, uppers, lowers = [], [], []
    for c in centroids:
        if cfg.is_elastic:
            luts.append(elastic_cdist(c, c, window, measure=spec))
        else:
            luts.append(euclidean_sq(c, c))
        up, lo = keogh_envelope(c, window or 1)
        uppers.append(up)
        lowers.append(lo)
    return PQCodebook(centroids, torch.stack(luts), torch.stack(uppers),
                      torch.stack(lowers))


# ---------------------------------------------------------------------------
# Encoding (Algorithm 2) — filter-then-refine
# ---------------------------------------------------------------------------

def _encode_segs(segs: torch.Tensor, cb: PQCodebook, window: Optional[int],
                 refine_t: int, full_scan: bool,
                 measure: Optional[MeasureSpec]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``segs (N, M, S)`` -> codes ``(N, M)`` int32 + soundness flags.

    The LB filter (:func:`lb_filter_pairs`) keeps the T most promising
    centroids per subspace, and all of them are refined in ONE zipped-pair
    launch (the ``pq.encode.refine`` span, as is a full scan).
    """
    N, M, S = segs.shape
    dev = segs.device
    exact = torch.ones((N, M), dtype=torch.bool, device=dev)
    if measure is None:
        with span("pq.encode.refine"):
            d = torch.stack([((segs[:, m, None, :] - cb.centroids[m][None])
                              ** 2).sum(-1) for m in range(M)], dim=1)
            return torch.argmin(d, -1).to(torch.int32), exact

    if full_scan:
        with span("pq.encode.refine"):
            d = torch.stack([elastic_cdist(segs[:, m].contiguous(),
                                           cb.centroids[m], window,
                                           measure=measure)
                             for m in range(M)], dim=1)       # (N, M, K)
            return torch.argmin(d, -1).to(torch.int32), exact

    T = refine_t
    cand, next_lb, qs, cs = lb_filter_pairs(segs, cb, T)
    with span("pq.encode.refine"):
        d = elastic_pairwise(qs, cs, window, measure=measure).view(N, M, T)
        best = torch.argmin(d, -1, keepdim=True)              # (N, M, 1)
        codes = torch.gather(cand, -1, best)[..., 0].to(torch.int32)
        # Soundness certificate: the true NN is among the candidates iff
        # the best refined cost <= the smallest bound left out, the
        # (T+1)-th.
        best_d = torch.gather(d, -1, best)[..., 0]
        return codes, best_d <= next_lb


def lb_filter_pairs(segs: torch.Tensor, cb: PQCodebook, refine_t: int):
    """The LB filter of the encode: for every series and subspace, the
    ``refine_t`` centroids of smallest ``max(LB_Kim, LB_Keogh)``, lower
    index first among equal bounds (``jax.lax.top_k``'s order).  Returns
    ``(cand (N, M, T), next_lb (N, M), qs, cs)``: the candidates, the
    smallest bound left out, and the zipped ``(N*M*T, S)`` segment /
    centroid pairs to refine.  The dispatch op :func:`.dispatch.lb_filter`
    (on the card one kernel launch, on the CPU the bounds and a stable
    sort) runs in the ``pq.encode.lb_filter`` span, the pairs in
    ``pq.encode.pairs``.
    """
    N, M, S = segs.shape
    T = refine_t
    with span("pq.encode.lb_filter"):
        cand, next_lb = lb_filter(segs, cb.centroids, cb.env_upper,
                                  cb.env_lower, T)            # (N, M, T)
    with span("pq.encode.pairs"):
        m_idx = torch.arange(M, device=segs.device)[None, :, None]
        qs = segs[:, :, None, :].expand(N, M, T, S).reshape(-1, S)
        cs = cb.centroids[m_idx, cand].reshape(-1, S)
    return cand, next_lb, qs, cs


def uses_fused_prealign(cfg: PQConfig) -> bool:
    """True when :func:`encode` takes the fused prealign+encode kernel: an
    elastic metric, pre-alignment on, and an exact (full-scan) encode.

    >>> uses_fused_prealign(PQConfig()), uses_fused_prealign(
    ...     PQConfig(exact_encode=True))
    (False, True)
    """
    return (cfg.fused_encode and cfg.use_prealign and cfg.is_elastic
            and cfg.full_scan_encode())


def encode(X, cb: PQCodebook, cfg: PQConfig, *,
           device: _device.DeviceArg = None) -> torch.Tensor:
    """Encode raw series ``X (N, D)`` to PQ codes ``(N, M)`` int32."""
    codes, _ = encode_with_stats(X, cb, cfg, device=device)
    return codes


def encode_with_stats(X, cb: PQCodebook, cfg: PQConfig, *,
                      device: _device.DeviceArg = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode + per-code soundness flags (True = certified exact-NN).
    The call is the ``pq.encode`` span; pre-alignment (off the fused path)
    is ``pq.encode.prealign``."""
    with span("pq.encode"):
        dev = _device.resolve_device(device)
        X = _device.to_tensor(X, dev, torch.float32)
        cb = _codebook_on(cb, dev)
        D = X.shape[-1]
        if uses_fused_prealign(cfg):
            codes = prealign_encode(X, cb.centroids,
                                    level=cfg.wavelet_level,
                                    tail=cfg.tail(D), window=cfg.window(D),
                                    measure=cfg.measure())
            sound = torch.ones(codes.shape, dtype=torch.bool, device=dev)
        else:
            with span("pq.encode.prealign"):
                segs = segment(X, cfg)
            codes, sound = _encode_segs(segs, cb, cfg.window(D),
                                        cfg.refine_t(),
                                        cfg.full_scan_encode(),
                                        cfg.measure())
        # the program's own codes: a distance call reads nothing back for
        # them
        return note_codes(codes, cb.lut.shape[-1]), sound


# ---------------------------------------------------------------------------
# Distances (§3.3)
# ---------------------------------------------------------------------------

def cdist_sym(codes_a, codes_b, lut, *, lut_dtype: str = "float32",
              device: _device.DeviceArg = None) -> torch.Tensor:
    """Symmetric PQ distance matrix: ``(Na, M) x (Nb, M) -> (Na, Nb)``.
    ``lut_dtype`` selects the table's precision: ``"float32"`` (exact) or
    the quantised route, ``"int8"`` / ``"bfloat16"`` (see
    :func:`repro_torch.core.dispatch.adc_cdist`).

    >>> codes = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    >>> lut = torch.stack([1.0 - torch.eye(2)] * 2)
    >>> cdist_sym(codes, codes, lut, device="cpu").flatten().tolist()[:2]
    [0.0, 1.4142135381698608]
    """
    dev = _device.resolve_device(device)
    lut = _device.to_tensor(lut, dev, torch.float32)
    check_codes(lut.shape[-1], codes_a=codes_a, codes_b=codes_b)
    return adc_cdist(_device.to_tensor(codes_a, dev, torch.int32),
                     _device.to_tensor(codes_b, dev, torch.int32), lut,
                     lut_dtype=lut_dtype)


def query_lut(q_segs: torch.Tensor, cb: PQCodebook, window: Optional[int],
              euclidean: bool = False,
              measure: Optional[MeasureSpec] = None) -> torch.Tensor:
    """Asymmetric query table of one query: ``q_segs (M, S)`` -> ``(M, K)``.

    >>> cfg = PQConfig(n_sub=2, codebook_size=2, use_prealign=False,
    ...                kmeans_iters=1, dba_iters=1)
    >>> X = torch.arange(32, dtype=torch.float32).reshape(4, 8) / 10.0
    >>> cb = fit(X, cfg, torch.Generator().manual_seed(0), device="cpu")
    >>> tuple(query_lut(segment(X, cfg)[0], cb, cfg.window(8),
    ...                 measure=cfg.measure()).shape)
    (2, 2)
    """
    return query_lut_batch(q_segs[None], cb, window, euclidean, measure)[0]


def adc_gather(qlut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain ADC scan ``sqrt(max(0, sum_m qlut[m, codes[:, m]]))``: one
    table ``(M, K)`` against codes ``(N, M)`` -> ``(N,)``, or a batch of
    tables ``(B, M, K)`` against codes ``(B, N, M)`` -> ``(B, N)``.  The
    subspaces are summed in order, as the ADC kernels and the reference's
    ``_adc_gather`` sum them.  The IVF fine stage uses it on either device,
    as the reference's fine stage uses its plain gather."""
    single = qlut.dim() == 2
    if single:
        qlut, codes = qlut[None], codes[None]
    codes = codes.long()
    acc = torch.zeros(codes.shape[:-1], dtype=torch.float32,
                      device=qlut.device)
    for m in range(qlut.shape[1]):
        acc = acc + torch.gather(qlut[:, m, :], 1, codes[..., m])
    out = sqrt_rn(torch.clamp(acc, min=0.0))
    return out[0] if single else out


def query_lut_batch(q_segs: torch.Tensor, cb: PQCodebook,
                    window: Optional[int], euclidean: bool = False,
                    measure: Optional[MeasureSpec] = None) -> torch.Tensor:
    """Asymmetric tables: ``q_segs (Nq, M, S)`` -> ``(Nq, M, K)``, one
    all-pairs launch per subspace."""
    Nq, M, S = q_segs.shape
    if euclidean:
        return torch.stack([((q_segs[:, m, None, :] - cb.centroids[m][None])
                             ** 2).sum(-1) for m in range(M)], dim=1)
    return torch.stack([elastic_cdist(q_segs[:, m].contiguous(),
                                      cb.centroids[m], window,
                                      measure=measure)
                        for m in range(M)], dim=1)


def cdist_asym(Q, codes, cb: PQCodebook, cfg: PQConfig, *,
               device: _device.DeviceArg = None) -> torch.Tensor:
    """Asymmetric distances: raw queries ``Q (Nq, D)`` vs codes ``(N, M)``
    -> ``(Nq, N)``; all queries' tables go to the ADC kernel in one
    launch (the reference's ``vmap`` of ``_adc_gather``)."""
    dev = _device.resolve_device(device)
    Q = _device.to_tensor(Q, dev, torch.float32)
    cb = _codebook_on(cb, dev)
    D = Q.shape[-1]
    check_codes(cfg.codebook_size, codes=codes)
    luts = query_lut_batch(segment(Q, cfg), cb, cfg.window(D),
                           not cfg.is_elastic, cfg.measure())
    return adc_lookup(_device.to_tensor(codes, dev, torch.int32), luts)


def cdist_sym_refined(codes_a, segs_a, codes_b, segs_b, cb: PQCodebook, *,
                      device: _device.DeviceArg = None) -> torch.Tensor:
    """§4.2 clustering distance: symmetric PQ, but where two series share a
    code in subspace m (the LUT says 0), the Keogh lower bound
    ``max(lb(a^m, env(code)), lb(b^m, env(code)))`` takes its place, which
    lies between 0 and the true subspace cost.  ``codes (N, M)`` with
    their segments ``(N, M, S)`` (:func:`segment`) -> ``(Na, Nb)``.

    Plain PyTorch on either device (the reference computes it in jnp),
    built in blocks of rows of ``a`` so that no ``(Na, Nb, S)`` tensor
    beyond ``lb_search.BOUND_CHUNK_BYTES`` is formed; the subspaces are
    summed in order.

    >>> cfg = PQConfig(n_sub=2, codebook_size=2, use_prealign=False,
    ...                kmeans_iters=1, dba_iters=1)
    >>> X = torch.arange(32, dtype=torch.float32).reshape(4, 8) / 10.0
    >>> cb = fit(X, cfg, torch.Generator().manual_seed(0), device="cpu")
    >>> codes, segs = encode(X, cb, cfg, device="cpu"), segment(X, cfg)
    >>> tuple(cdist_sym_refined(codes, segs, codes, segs, cb,
    ...                         device="cpu").shape)
    (4, 4)
    """
    dev = _device.resolve_device(device)
    check_codes(cb.lut.shape[-1], codes_a=codes_a, codes_b=codes_b)
    ca = _device.to_tensor(codes_a, dev, torch.int64)
    cb_codes = _device.to_tensor(codes_b, dev, torch.int64)
    sa = _device.to_tensor(segs_a, dev, torch.float32)
    sb = _device.to_tensor(segs_b, dev, torch.float32)
    cb = _codebook_on(cb, dev)
    Na, M = ca.shape
    Nb = cb_codes.shape[0]
    S = sa.shape[-1]
    # about four (rows, Nb, S) float32 temporaries live at once
    rows = max(1, BOUND_CHUNK_BYTES // max(1, 16 * Nb * S))
    out = torch.empty((Na, Nb), dtype=torch.float32, device=dev)
    for r0 in range(0, Na, rows):
        r1 = min(Na, r0 + rows)
        d2 = torch.zeros((r1 - r0, Nb), dtype=torch.float32, device=dev)
        for m in range(M):
            am, bm = ca[r0:r1, m], cb_codes[:, m]
            up, lo = cb.env_upper[m], cb.env_lower[m]
            base = cb.lut[m][am[:, None], bm[None, :]]
            lb_a = lb_keogh(sa[r0:r1, m, None, :], up[bm][None], lo[bm][None])
            lb_b = lb_keogh(sb[None, :, m, :], up[am][:, None],
                            lo[am][:, None])
            same = am[:, None] == bm[None, :]
            d2 = d2 + torch.where(same, torch.maximum(lb_a, lb_b), base)
        out[r0:r1] = sqrt_rn(torch.clamp(d2, min=0.0))
    return out


# ---------------------------------------------------------------------------
# Memory accounting (§3.4)
# ---------------------------------------------------------------------------

def memory_cost(cfg: PQConfig, D: int, n_series: int, *,
                n_segments: int = 0, n_lists: int = 0,
                hot_capacity: int = 0, n_devices: int = 1) -> dict:
    """Bytes for raw data vs the PQ representation + auxiliary structures.

    With the segmented-index keywords the estimate also covers the
    streaming index (:mod:`repro_torch.index`): per-entry id/tombstone/
    assignment sidecars, per-segment inverted-list offset tables and the
    raw float32 hot buffer.  ``n_devices > 1`` splits it into replicated
    bytes (quantizers, list tables, hot buffer) and partitioned bytes
    (sealed codes and sidecars) for the list-sharded layout:
    ``max_device_bytes = replicated + ceil(partitioned / n_devices)``.

    >>> cost = memory_cost(PQConfig(), 128, 1000)
    >>> cost["raw_bytes"], cost["code_bytes"], cost["compression"]
    (512000, 8000, 64.0)
    """
    S = cfg.subseq_len(D)
    M, K = cfg.n_sub, cfg.codebook_size
    code_bits = max(1, int(np.ceil(np.log2(K))))
    raw = 4 * D * n_series
    codes = int(np.ceil(code_bits / 8)) * M * n_series
    codebook = 4 * M * K * S
    lut = 4 * M * K * K
    envelopes = 2 * 4 * M * K * S
    out = dict(raw_bytes=raw, code_bytes=codes, codebook_bytes=codebook,
               lut_bytes=lut, envelope_bytes=envelopes,
               aux_bytes=codebook + lut + envelopes,
               compression=raw / max(codes, 1))
    if n_segments or hot_capacity:
        # sealed sidecars: int32 id + int32 coarse assignment + bool live
        sidecar = (4 + 4 + 1) * n_series
        # per-segment inverted-list tables: int32 start + len per list
        lists = 2 * 4 * n_lists * n_segments
        # hot segment: raw float32 buffer + id/live sidecars at capacity
        hot = (4 * D + 4 + 1) * hot_capacity
        out.update(sidecar_bytes=sidecar, list_bytes=lists, hot_bytes=hot,
                   index_bytes=codes + sidecar + lists + hot,
                   total_bytes=codes + sidecar + lists + hot
                   + out["aux_bytes"])
        if n_devices > 1:
            # coarse centroids ride along with every device's probe stage
            coarse = 4 * n_lists * D
            replicated = out["aux_bytes"] + coarse + lists + hot
            partitioned = codes + sidecar
            out.update(
                n_devices=n_devices,
                coarse_bytes=coarse,
                replicated_bytes=replicated,
                partitioned_bytes=partitioned,
                max_device_bytes=replicated + -(-partitioned // n_devices))
    return out
