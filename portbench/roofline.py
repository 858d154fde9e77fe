"""The least time the chip could take: peaks, and the operations and bytes
each counted piece of work needs, from the cell's shapes alone.

Peaks are one NVIDIA H100 SXM's published rates at 700 W: 67 TFLOP/s in
float32 outside the tensor cores and 3.35 TB/s of HBM.  A bound is the
larger of operations over the first and bytes over the second.  Bytes
count every input read once and every output written once; operations
count the float32 arithmetic the algorithm needs.  The counts are the
ones the repository's bring-up smoke uses (a DTW cell is 6 operations:
the difference, the fused multiply-add as 2, two minimums and the
clamp), copied here so that a change to the program cannot move them.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["FP32_FLOPS", "HBM_BYTES_PER_S", "DTW_OPS_PER_CELL", "Work",
           "band_cells", "dtw_pairs", "adc_sym", "lb_filter", "prealign",
           "classify_step"]

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
DTW_OPS_PER_CELL = 6
# LB_Keogh: two compares, the difference, its square and the sum
KEOGH_OPS_PER_POINT = 5
# LB_Kim: two differences, two squares, their sum and the max with Keogh
KIM_OPS = 6


class Work(NamedTuple):
    ops: float
    nbytes: float

    def bound_s(self) -> float:
        """The least seconds the chip could take for this work."""
        return max(self.ops / FP32_FLOPS, self.nbytes / HBM_BYTES_PER_S)


def band_cells(L: int, w: int) -> int:
    """DP cells inside a Sakoe-Chiba band of half-width ``w`` on ``L x L``."""
    w = max(0, min(int(w), L - 1))
    return L * (2 * w + 1) - w * (w + 1)


def dtw_pairs(n: int, M: int, K: int, T: int, S: int, w: int) -> Work:
    """The encode's refine (row 1): each of ``n`` series' ``M`` segments
    against its ``T`` candidate centroids.  Inputs read once: the
    ``(n, M, S)`` segments, the ``(M, K, S)`` centroids and the ``(n, M,
    T)`` candidate indices as int32; one cost written a pair, however
    often an implementation reads a row again."""
    pairs = n * M * T
    return Work(pairs * band_cells(S, w) * DTW_OPS_PER_CELL,
                (n * M * S + M * K * S + 2 * pairs) * 4)


def adc_sym(na: int, nb: int, M: int, K: int) -> Work:
    """Symmetric ADC (row 3): int32 codes and the ``(M, K, K)`` table in,
    the ``(na, nb)`` distances out; M adds and a root an output."""
    return Work(na * nb * (M + 1),
                ((na + nb) * M + M * K * K + na * nb) * 4)


def lb_filter(n: int, M: int, K: int, S: int) -> Work:
    """The encode's bounds: every segment against every centroid."""
    return Work(n * M * K * (KEOGH_OPS_PER_POINT * S + KIM_OPS),
                (n * M * S + 3 * M * K * S + n * M * K) * 4)


def prealign(n: int, D: int, M: int, S: int, level: int) -> Work:
    """MODWT (two operations a point a level), the sign test, and the
    resampling (position and lerp, four operations an output point)."""
    return Work(n * (2 * level * D + 2 * D + 4 * M * S),
                (n * D + n * M * S) * 4)


def classify_step(n: int, n_train: int, D: int, M: int, K: int, S: int,
                  w: int, T: int, level: int) -> Work:
    """One symmetric 1-NN batch of ``n`` series against ``n_train`` codes:
    the arithmetic the configuration demands (pre-alignment, the LB
    bounds, the refined DTW cells, the gathers and adds of every pair, a
    root and a compare an output), over its inputs read once (the batch,
    the training codes and int64 labels, the LUT, centroids and
    envelopes) and its labels written once."""
    ops = (prealign(n, D, M, S, level).ops + lb_filter(n, M, K, S).ops
           + n * M * T * band_cells(S, w) * DTW_OPS_PER_CELL
           + n * n_train * (M + 2))
    nbytes = (n * D * 4 + n_train * M * 4 + n_train * 8 + M * K * K * 4
              + 3 * M * K * S * 4 + n * 8)
    return Work(ops, nbytes)
