"""Pluggable elastic-measure registry (PyTorch counterpart of
:mod:`repro.core.measures`).

Every cell ``(i, j)`` of an elastic alignment table is

    T[i, j] = min(T[i-1, j-1] + diag_cost,
                  T[i-1, j  ] + vert_cost,     # consume a_i
                  T[i,   j-1] + horiz_cost)    # consume b_j

and only the per-move costs differ between measures.  This module owns
those costs (as tensor functions for the plain sweeps) plus the capability
flags that gate pruning.  The CUDA kernels implement the same four steps
in ``kernels/csrc/wavefront.cuh``; :func:`kernel_measure_id` and
:func:`kernel_param` give them the measure as an integer and one float.

Shipped measures: ``dtw`` (squared costs), ``wdtw`` (``g``: logistic
steepness, weight ``2 / (1 + exp(-g (|i-j| - L/2)))``), ``erp`` (``g``:
gap value, absolute costs, prefix-sum borders) and ``msm`` (``c``:
split/merge cost, absolute costs).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

__all__ = [
    "MeasureSpec", "MeasureArg", "register_measure", "get_measure",
    "resolve", "available", "move_costs", "cost_factors", "gap_costs",
    "fma", "wdtw_weights", "kernel_measure_id", "kernel_param", "DTW",
    "DTW_KERNEL_ID",
]

MeasureArg = Union[None, str, "MeasureSpec"]

DTW_KERNEL_ID = 0   # the dtw cell's number in kernels/csrc/wavefront.cuh


@dataclasses.dataclass(frozen=True)
class MeasureSpec:
    """Pure-data description of one elastic measure (hashable, comparable
    by value).  ``params`` is a sorted tuple of ``(name, float)`` pairs.

    ``has_keogh_lb``: ``max(LB_Kim, LB_Keogh)`` lower-bounds the measure,
    so the LB filter may prune with it.  ``euclid_is_upper_bound``:
    pointwise squared Euclidean distance upper-bounds the measure.
    """
    name: str
    params: Tuple[Tuple[str, float], ...] = ()
    has_keogh_lb: bool = False
    euclid_is_upper_bound: bool = False
    uses_gap_border: bool = False   # ERP-style virtual first row/column
    uses_neighbors: bool = False    # step needs a_{i-1} / b_{j-1} (MSM)
    uses_position: bool = False     # step needs |i - j| (WDTW)

    def param(self, key: str) -> float:
        return dict(self.params)[key]

    def to_manifest(self) -> dict:
        """JSON-safe record for snapshot manifests (the reference's form)."""
        return {"name": self.name, "params": dict(self.params)}

    @property
    def can_prune(self) -> bool:
        """True when the LB-cascade filter-and-refine path is sound: the
        cascade bound lower-bounds the measure and squared Euclidean
        distance upper-bounds it (the threshold seed).

        >>> get_measure("dtw").can_prune, get_measure("wdtw").can_prune
        (True, False)
        """
        return self.has_keogh_lb and self.euclid_is_upper_bound


_REGISTRY: Dict[str, dict] = {}


def register_measure(name: str, *, step: Callable,
                     gap: Optional[Callable] = None,
                     defaults: Tuple[Tuple[str, float], ...] = (),
                     has_keogh_lb: bool = False,
                     euclid_is_upper_bound: bool = False,
                     uses_neighbors: bool = False,
                     uses_position: bool = False,
                     factors: Optional[Callable] = None,
                     kernel_id: Optional[int] = None,
                     doc: str = "") -> None:
    """Register an elastic measure.

    ``step(params, x, y, xp, yp, dd, length)`` returns the per-move costs
    ``(diag, vert, horiz)``; returning the *same tensor object* three times
    marks the shared-cost fast path (DTW family).  ``gap(params, values)``
    gives ERP-style border costs.  ``factors(params, x, y, dd, length)``,
    for a shared-cost measure, returns two tensors whose product is the
    cost: the sweep then forms each cell as one fused multiply-add, as the
    compiled reference does.  ``kernel_id`` is the measure's number in the
    CUDA kernels (``None``: no kernel, plain sweeps only).
    """
    _REGISTRY[name] = dict(step=step, gap=gap, defaults=tuple(defaults),
                           factors=factors,
                           has_keogh_lb=has_keogh_lb,
                           euclid_is_upper_bound=euclid_is_upper_bound,
                           uses_neighbors=uses_neighbors,
                           uses_position=uses_position,
                           kernel_id=kernel_id, doc=doc)


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_measure(name: str, **params: float) -> MeasureSpec:
    """Spec for a registered measure, with keyword parameter overrides."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown elastic measure {name!r}; registered: {available()}")
    entry = _REGISTRY[name]
    merged = dict(entry["defaults"])
    for k, v in params.items():
        if k not in merged:
            raise ValueError(
                f"measure {name!r} has no parameter {k!r}; expected "
                f"{tuple(merged)}")
        merged[k] = float(v)
    return MeasureSpec(
        name=name, params=tuple(sorted(merged.items())),
        has_keogh_lb=entry["has_keogh_lb"],
        euclid_is_upper_bound=entry["euclid_is_upper_bound"],
        uses_gap_border=entry["gap"] is not None,
        uses_neighbors=entry["uses_neighbors"],
        uses_position=entry["uses_position"])


def resolve(measure: MeasureArg) -> MeasureSpec:
    """``None`` -> DTW; ``"erp:g=1.5"`` -> registry lookup with parameters;
    a spec passes through (re-validated against the registry)."""
    if measure is None:
        return DTW
    if isinstance(measure, MeasureSpec):
        if measure.name not in _REGISTRY:
            raise ValueError(
                f"measure {measure.name!r} is not registered; call "
                f"register_measure first (registered: {available()})")
        return measure
    name, _, rest = str(measure).partition(":")
    params = {}
    if rest:
        for item in rest.split(","):
            k, _, v = item.partition("=")
            params[k.strip()] = float(v)
    return get_measure(name.strip(), **params)


def move_costs(spec: MeasureSpec, x, y, xp, yp, dd, length: int):
    """Per-cell costs of the three DP moves -> ``(diag, vert, horiz)``."""
    return _REGISTRY[spec.name]["step"](dict(spec.params), x, y, xp, yp,
                                        dd, length)


def cost_factors(spec: MeasureSpec, x, y, dd, length: int):
    """``(u, v)`` with ``u * v`` the shared cost, or ``None`` when the
    measure has per-move costs."""
    factors = _REGISTRY[spec.name]["factors"]
    if factors is None:
        return None
    return factors(dict(spec.params), x, y, dd, length)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 with ONE rounding, as a fused multiply-add.

    XLA's CPU compiler contracts the reference's ``(x - y) ** 2 + pred``
    (the DTW cell) and the lerp lines of the pre-alignment into FMAs, and
    the kernels write them as ``__fmaf_rn``; this is the same operation in
    plain PyTorch.  The float32 product is exact in float64, so the sum is
    rounded once to float64 and once to float32, which differs from a true
    FMA only when the float64 sum lands exactly on a float32 tie.
    """
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def gap_costs(spec: MeasureSpec, values: torch.Tensor) -> torch.Tensor:
    """Per-element gap cost for the virtual first row/column (ERP style)."""
    gap = _REGISTRY[spec.name]["gap"]
    if gap is None:
        raise ValueError(f"measure {spec.name!r} has no gap border")
    return gap(dict(spec.params), values)


def _wdtw_weight(g: float, dd: torch.Tensor, length: int) -> torch.Tensor:
    # Logistic phase weight, normalized so g = 0 is flat weight 1 (== DTW).
    return 2.0 / (1.0 + torch.exp(-g * (dd.to(torch.float32)
                                        - 0.5 * float(length))))


def wdtw_weights(spec: MeasureSpec, length: int,
                 device: torch.device) -> torch.Tensor:
    """WDTW weight for every phase offset ``|i - j|`` in ``[0, length)``,
    computed by the same expression as the plain step, so a kernel that
    reads this table applies bit-identical weights."""
    dd = torch.arange(length, device=device)
    return _wdtw_weight(spec.param("g"), dd, length).contiguous()


def kernel_measure_id(spec: MeasureSpec) -> int:
    """The measure's number in ``kernels/csrc/wavefront.cuh``."""
    kid = _REGISTRY[spec.name]["kernel_id"]
    if kid is None:
        raise ValueError(f"measure {spec.name!r} has no CUDA kernel step")
    return kid


def kernel_param(spec: MeasureSpec) -> float:
    """The one float parameter the kernel step reads (0 when unused)."""
    if spec.name in ("erp", "wdtw"):
        return spec.param("g")
    if spec.name == "msm":
        return spec.param("c")
    return 0.0


# ---------------------------------------------------------------------------
# Shipped measures
# ---------------------------------------------------------------------------

def _dtw_step(params, x, y, xp, yp, dd, length):
    c = (x - y) ** 2
    return c, c, c   # same object: shared-cost fast path


def _dtw_factors(params, x, y, dd, length):
    d = x - y
    return d, d


def _wdtw_step(params, x, y, xp, yp, dd, length):
    c = _wdtw_weight(params["g"], dd, length) * (x - y) ** 2
    return c, c, c


def _wdtw_factors(params, x, y, dd, length):
    return _wdtw_weight(params["g"], dd, length), (x - y) ** 2


def _erp_step(params, x, y, xp, yp, dd, length):
    g = params["g"]
    return (x - y).abs(), (x - g).abs(), (y - g).abs()


def _erp_gap(params, values):
    return (values - params["g"]).abs()


def _msm_move(new, prev, other, c):
    """MSM split/merge cost C(new | prev, other)."""
    inside = (((prev <= new) & (new <= other))
              | ((prev >= new) & (new >= other)))
    far = c + torch.minimum((new - prev).abs(), (new - other).abs())
    return torch.where(inside, torch.full_like(far, c), far)


def _msm_step(params, x, y, xp, yp, dd, length):
    c = params["c"]
    return ((x - y).abs(),
            _msm_move(x, xp, y, c),    # consume a_i after a_{i-1}
            _msm_move(y, yp, x, c))    # consume b_j after b_{j-1}


register_measure(
    "dtw", step=_dtw_step, factors=_dtw_factors, kernel_id=DTW_KERNEL_ID,
    has_keogh_lb=True, euclid_is_upper_bound=True,
    doc="classic DTW, squared pointwise costs")
register_measure(
    "wdtw", step=_wdtw_step, factors=_wdtw_factors, defaults=(("g", 0.05),),
    uses_position=True, euclid_is_upper_bound=True, kernel_id=1,
    doc="logistic phase-weighted DTW (g=0 recovers dtw exactly)")
register_measure(
    "erp", step=_erp_step, gap=_erp_gap, defaults=(("g", 0.0),),
    kernel_id=2,
    doc="edit distance with real penalty (metric, absolute costs)")
register_measure(
    "msm", step=_msm_step, defaults=(("c", 0.5),), uses_neighbors=True,
    kernel_id=3,
    doc="move-split-merge (metric, absolute costs)")

DTW = get_measure("dtw")
