"""Launch-parameter table and the adaptive register width (counterpart of
:mod:`repro.kernels.tune`, the part the adaptive band needs).

A table keyed by

    (op, L bucket, window bucket, measure, backend)

resolves one launch parameter; backends are the port's routes, ``cuda``
and ``torch``.  ``REPRO_TUNE`` selects the mode:

``off`` (default)
    No table: every lookup returns the builtin default.
``<path>``
    A pinned table: lookups are read-only from the JSON file at ``<path>``
    (missing keys fall back to the default).

The reference's ``auto`` mode, which benchmarks candidate launch
geometries and persists the winners, is not ported: it raises here.

The table also carries the adaptive-corridor register width
(``op="adaptive_width"``): :func:`adaptive_width` derives the cap for
``band="adaptive"`` sweeps from the corridor geometry (projection factor
and safety radius), never wider than the static register.  The width
decides which cells a clipped corridor keeps, so it is part of the
result: the port uses the reference's lane 8 on every device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

__all__ = ["ENV", "mode", "table_key", "tuned", "adaptive_width", "reset"]

ENV = "REPRO_TUNE"

_pinned: Dict[str, Dict[str, Dict[str, int]]] = {}


def mode() -> str:
    return os.environ.get(ENV, "off") or "off"


def _bucket(n: int) -> int:
    """Next power of two >= n: geometry keys bucket L and window+1 so
    nearby shapes share one entry."""
    b = 1
    while b < n:
        b *= 2
    return b


def table_key(op: str, *, length: int, window: Optional[int],
              measure: Optional[str], backend: str) -> str:
    """``"op|L<bucket>|w<bucket>|measure|backend"``.

    >>> table_key("adaptive_width", length=512, window=51, measure=None,
    ...           backend="cuda")
    'adaptive_width|L512|w64|dtw|cuda'
    """
    w = length if window is None else int(window)
    return (f"{op}|L{_bucket(max(1, length))}"
            f"|w{_bucket(min(w, length - 1) + 1)}"
            f"|{measure or 'dtw'}|{backend}")


def _load(path: str) -> Dict[str, Dict[str, int]]:
    if path not in _pinned:
        try:
            with open(path, encoding="utf-8") as f:
                _pinned[path] = json.load(f)
        except (OSError, ValueError):
            _pinned[path] = {}
    return _pinned[path]


def tuned(op: str, param: str, *, length: int, window: Optional[int] = None,
          measure: Optional[str] = None, backend: str = "cuda",
          default: int = 8) -> int:
    """Resolve one launch parameter for ``op`` at the given geometry:
    ``default`` in ``off`` mode and for any key a pinned table lacks."""
    m = mode()
    if m == "off":
        return default
    if m == "auto":
        raise NotImplementedError(
            f"{ENV}=auto (benchmarking launch geometries) is not ported; "
            f"use 'off' or a pinned table path")
    key = table_key(op, length=length, window=window, measure=measure,
                    backend=backend)
    return int(_load(m).get(key, {}).get(param, default))


def adaptive_width(length: int, window: Optional[int], lane: int = 8, *,
                   measure: Optional[str] = None, backend: str = "cuda",
                   factor: int = 8, radius: int = 2) -> int:
    """Register width cap for ``band="adaptive"`` sweeps: the projected
    coarse cells span about ``3 * factor`` fine rows per diagonal, plus
    the safety radius on both sides, rounded up to ``lane``; never wider
    than the static register.  A pinned table may override it per bucket.

    >>> adaptive_width(512, 51)          # min(band_width 56, roundup(30, 8))
    32
    """
    from .dtw_band.ops import band_width
    need = 3 * factor + 2 * radius + 2
    default = min(band_width(length, window, lane),
                  max(lane, -(-need // lane) * lane))
    return tuned("adaptive_width", "width", length=length, window=window,
                 measure=measure, backend=backend, default=default)


def reset() -> None:
    """Drop every cached pinned table (tests)."""
    _pinned.clear()
