"""Baseline distance measures the paper compares against (§5), in PyTorch
(counterpart of :mod:`repro.core.baselines`).

Square roots are rounded once (:func:`.measures.sqrt_rn`), so the card,
the CPU route and the reference give the same bits from the same costs.
ED (one matrix product, TF32 off at package import), cDTW (the banded
all-pairs sweep of :func:`.dispatch.elastic_cdist`, so on the card the
``dtw_band_cdist`` kernel), SBD (k-Shape's shape-based distance, by FFT
cross-correlation, as the reference computes it with ``jnp.fft``) and
SAX with the classic MINDIST (numpy copies).  PQ_ED is
:mod:`.pq` with ``metric="euclidean"``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _device
from .dispatch import elastic_cdist
from .dtw import euclidean_sq
from .measures import sqrt_rn

__all__ = ["ed_cdist", "cdtw_cdist", "sbd_cdist", "sax_transform",
           "sax_mindist_cdist", "GAUSS_BREAKPOINTS"]


def _pair(A, B, device: _device.DeviceArg):
    dev = _device.resolve_device(device)
    return (_device.to_tensor(A, dev, torch.float32),
            _device.to_tensor(B, dev, torch.float32))


def ed_cdist(A, B, *, device: _device.DeviceArg = None) -> torch.Tensor:
    """Euclidean distance matrix (not squared, to match metric semantics).

    >>> ed_cdist([[0., 0.]], [[3., 4.]], device="cpu").tolist()
    [[5.0]]
    """
    A, B = _pair(A, B, device)
    return sqrt_rn(euclidean_sq(A, B))


def cdtw_cdist(A, B, window: Optional[int], *,
               device: _device.DeviceArg = None) -> torch.Tensor:
    """Constrained (Sakoe-Chiba) DTW distance matrix; ``window=None`` is
    full DTW (a band of ``L - 1``).

    >>> cdtw_cdist([[0., 1., 2.]], [[0., 2., 2.]], None,
    ...            device="cpu").tolist()
    [[1.0]]
    """
    A, B = _pair(A, B, device)
    return sqrt_rn(elastic_cdist(A, B, window))


def sbd_cdist(A, B, block: int = 64, *,
              device: _device.DeviceArg = None) -> torch.Tensor:
    """Shape-based distance: ``1 - max_w NCCc_w(a, b)`` for all pairs.

    Cross-correlation over all shifts via zero-padded FFT of ``F = 2L``
    points, in blocks of ``block`` rows of ``A`` to bound the
    ``(block, M, F)`` intermediate.

    >>> d = sbd_cdist([[0., 1., 0., 0.]], [[0., 0., 1., 0.]], device="cpu")
    >>> abs(float(d[0, 0])) < 1e-6
    True
    """
    A, B = _pair(A, B, device)
    L = A.shape[1]
    F = 2 * L
    fb = torch.conj(torch.fft.rfft(B, F, dim=1))            # (M, F/2+1)
    nb = torch.linalg.norm(B, dim=1)
    na = torch.linalg.norm(A, dim=1)
    out = torch.empty((A.shape[0], B.shape[0]), dtype=torch.float32,
                      device=A.device)
    for r0 in range(0, A.shape[0], block):
        r1 = min(A.shape[0], r0 + block)
        fa = torch.fft.rfft(A[r0:r1], F, dim=1)
        cc = torch.fft.irfft(fa[:, None, :] * fb[None, :, :], F, dim=2)
        denom = torch.clamp(na[r0:r1, None] * nb[None, :], min=1e-9)
        out[r0:r1] = 1.0 - cc.max(dim=2).values / denom
    return out


# Gaussian breakpoints for alphabet sizes 2..8 (Lin et al., SAX).
GAUSS_BREAKPOINTS = {
    2: [0.0],
    3: [-0.43, 0.43],
    4: [-0.67, 0.0, 0.67],
    5: [-0.84, -0.25, 0.25, 0.84],
    6: [-0.97, -0.43, 0.0, 0.43, 0.97],
    7: [-1.07, -0.57, -0.18, 0.18, 0.57, 1.07],
    8: [-1.15, -0.67, -0.32, 0.0, 0.32, 0.67, 1.15],
}


def sax_transform(X, n_segments: int, alphabet: int = 4) -> np.ndarray:
    """Z-normalize, PAA to ``n_segments``, discretize with Gaussian
    breakpoints (numpy, on the host).

    >>> sax_transform([[0., 1., 2., 3.]], 2).tolist()
    [[0, 3]]
    """
    X = np.asarray(_device.to_host(X), np.float64)
    mu = X.mean(1, keepdims=True)
    sd = X.std(1, keepdims=True)
    Xz = (X - mu) / np.maximum(sd, 1e-9)
    N, L = Xz.shape
    # PAA with possibly non-divisible L: average fractional-weight bins.
    idx = (np.arange(L) * n_segments) // L
    paa = np.zeros((N, n_segments))
    for s in range(n_segments):
        paa[:, s] = Xz[:, idx == s].mean(1)
    bp = np.array(GAUSS_BREAKPOINTS[alphabet])
    return np.searchsorted(bp, paa).astype(np.int8)


def sax_mindist_cdist(Sa, Sb, L: int, alphabet: int = 4) -> np.ndarray:
    """MINDIST between SAX words (lower-bounds ED of z-normalized series).

    >>> round(float(sax_mindist_cdist([[0, 3]], [[3, 0]], 4)[0, 0]), 4)
    2.68
    """
    Sa, Sb = _device.to_host(Sa), _device.to_host(Sb)
    bp = np.array(GAUSS_BREAKPOINTS[alphabet])
    a = alphabet
    cell = np.zeros((a, a))
    for r in range(a):
        for c in range(a):
            if abs(r - c) > 1:
                cell[r, c] = bp[max(r, c) - 1] - bp[min(r, c)]
    d2 = (cell[Sa[:, None, :], Sb[None, :, :]] ** 2).sum(-1)
    n_seg = Sa.shape[1]
    return np.sqrt(L / n_seg) * np.sqrt(d2)
