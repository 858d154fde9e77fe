"""Launch-parameter table, the measuring ``auto`` mode and the adaptive
register width (counterpart of :mod:`repro.kernels.tune`).

A table keyed by

    (op, L bucket, window bucket, measure, backend)

resolves the launch parameters of one op; the backend is the port's
kernel route, ``cuda`` (the plain ``torch`` route has no launch to tune).
Every kernel wrapper asks the table through :func:`tuned` with its
selector's own choice as the default, so ``off`` changes nothing.  The
ops and their parameters are the port's own (the reference tunes the
TPU's ``block``):

``dtw_band``
    ``bucket`` (register slots of the band row, 0 = the shared-memory
    row) and ``warps`` a block of the register form;
``dtw_band_cdist``
    ``bucket`` (0 = the band rows in shared memory or scratch);
``lb_refine``
    ``warps`` a CTA of the warp form (0 = a thread per pair);
``prealign_encode``
    ``bucket`` (0 = the band rows in shared memory);
``adc_sym``, ``adc_lookup``
    ``ta``, the queries a tile of the row-staged form, wherever the
    selector picks that form (which form follows from the query count,
    and is not tuned).  Their key's measure slot holds the table's type
    (``f32``, ``int8``, ``bf16``), its length slot ``K``.

``pq_attn``'s split count is not tuned: it changes the order in which the
splits' softmax pieces are combined, so its candidates would not give the
default's bits (and the reference's grid has no such op).

``REPRO_TUNE`` selects the mode:

``off`` (default)
    No table: every lookup returns the builtin default.
``auto``
    The first use of a key on CUDA tensors times every candidate of the
    op's grid on the call's own inputs with CUDA events (one warm-up,
    then the best of 3; the kernels are built before the clock starts).
    A candidate is admitted only where its output equals the default's
    bit for bit; one that raises or differs is reported on its line
    (:data:`REPORT`) and left out.  The winner is memoized in the process
    and persisted to ``$REPRO_TUNE_OUT/tuning.json`` (default
    ``build/tune`` at the repository root), written through a temp file
    and ``os.replace`` under a lock, since a server resolves from several
    threads.  ``REPRO_TUNE_GRID=minimal`` collapses each grid to the
    default.  Nothing is measured for CPU tensors or while the current
    stream captures a CUDA graph: the lookup returns the memoized or
    persisted entry, else the default.  The tuner's launches count in
    :data:`LAUNCHES`, apart from the kernels' own counters.
``<path>``
    A pinned table: lookups are read-only from the JSON file at ``<path>``
    (missing keys fall back to the default).

A key buckets the geometry, but whether a launch fits can depend on more
of it (the ADC tile's shared memory grows with ``M``, a warp's staged
rows with the exact ``L``).  So each wrapper hands :func:`resolve` a
``check`` that raises ``ValueError`` for parameters its launch cannot
take at the call's own geometry.  An entry (memoized, persisted or
pinned) that the check refuses is never launched: ``auto`` measures the
key again on the card, and persists the new winner; else the default is
used.  The forms and tiles the grids offer give the same bits at every
geometry by construction (the card tests hold each against the default
over many shapes); the admission test repeats that at the measured one.

The table also carries the adaptive-corridor register width
(``op="adaptive_width"``): :func:`adaptive_width` derives the cap for
``band="adaptive"`` sweeps from the corridor geometry (projection factor
and safety radius), never wider than the static register.  The width
decides which cells a clipped corridor keeps, so it is part of the
result: it is never measured, and the port uses the reference's lane 8
on every device.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["ENV", "GRID_ENV", "OUT_ENV", "DEFAULT_OUT", "GRIDS", "REPORT",
           "LAUNCHES", "mode", "table_key", "tuned", "resolve",
           "adaptive_width", "reset"]

ENV = "REPRO_TUNE"
GRID_ENV = "REPRO_TUNE_GRID"
OUT_ENV = "REPRO_TUNE_OUT"

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "tune"
_TABLE_NAME = "tuning.json"

# candidate grids per op; "minimal" collapses each to the default
GRIDS: Dict[str, Dict[str, Tuple[int, ...]]] = {
    "dtw_band": {"bucket": (0, 8, 16, 32, 64, 128), "warps": (1, 2, 4)},
    "dtw_band_cdist": {"bucket": (0, 8, 16, 32, 64, 128)},
    "lb_refine": {"warps": (0, 1, 2, 4)},
    "prealign_encode": {"bucket": (0, 8, 16, 32, 64, 128)},
    "adc_sym": {"ta": (8, 16, 32)},
    "adc_lookup": {"ta": (8, 16, 32)},
}
_WARMUP, _REPEATS = 1, 3

# one record per measured key: its candidates (ms, or why left out) and
# the winner
REPORT: List[dict] = []
# the tuner's own launches, by kernel
LAUNCHES: Dict[str, int] = {}

_memo: Dict[str, Dict[str, int]] = {}
_pinned: Dict[str, Dict[str, Dict[str, int]]] = {}
_lock = threading.RLock()

Runner = Callable[[Dict[str, int]], Sequence[torch.Tensor]]
Check = Callable[[Dict[str, int]], object]


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


def _out_path() -> str:
    return os.path.join(os.environ.get(OUT_ENV, str(DEFAULT_OUT)),
                        _TABLE_NAME)


def _load(path: str) -> Dict[str, Dict[str, int]]:
    with _lock:
        if path not in _pinned:
            try:
                with open(path, encoding="utf-8") as f:
                    # repro: ignore[RS104] the tuner's tables, under _lock
                    _pinned[path] = json.load(f)
            except (OSError, ValueError):
                # repro: ignore[RS104] the tuner's tables, under _lock
                _pinned[path] = {}
        return _pinned[path]


def _persist(path: str, key: str, entry: Dict[str, int]) -> None:
    """Add ``key`` to the table at ``path``: the file is rewritten whole
    through a temp file in its directory and ``os.replace``."""
    with _lock:
        table = dict(_load(path))
        table[key] = entry
        folder = os.path.dirname(path) or "."
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, prefix=".tuning.")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(table, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
        # repro: ignore[RS104] the tuner's tables, under _lock
        _pinned[path] = table


def _candidates(op: str, defaults: Dict[str, int]
                ) -> Tuple[Dict[str, int], ...]:
    """The default first, then every other point of the op's grid."""
    grid = GRIDS.get(op)
    if grid is None or os.environ.get(GRID_ENV) == "minimal":
        return (dict(defaults),)
    combos = [{}]
    for p in sorted(grid):
        combos = [dict(c, **{p: v}) for c in combos for v in grid[p]]
    out = [dict(defaults)]
    for c in combos:
        cand = dict(defaults, **c)
        if cand not in out:
            out.append(cand)
    return tuple(out)


def _can_measure(device: Optional[torch.device]) -> bool:
    """Only on the card, and never while its stream captures a graph."""
    if device is None or device.type != "cuda":
        return False
    return not torch.cuda.is_current_stream_capturing()


def _time(runner: Runner, params: Dict[str, int]
          ) -> Tuple[float, Sequence[torch.Tensor]]:
    """Best of :data:`_REPEATS` timed calls (CUDA events) after
    :data:`_WARMUP`; the last call's outputs."""
    for _ in range(_WARMUP):
        out = runner(params)
    best = float("inf")
    for _ in range(_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = runner(params)
        stop.record()
        # repro: ignore[RS101] REPRO_TUNE=auto's timing, once a geometry
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best, out


def _same_bits(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(a, b))


def _admits(check: Optional[Check], params: Dict[str, int]) -> bool:
    """Whether the call's launch can take ``params`` at its geometry."""
    if check is None:
        return True
    try:
        check(params)
    except ValueError:
        return False
    return True


def _measure(key: str, op: str, defaults: Dict[str, int],
             runner: Runner) -> Dict[str, int]:
    """Time every candidate on the call's inputs; the fastest of those
    whose outputs equal the default's bit for bit."""
    from . import _build
    _build.lib()                       # build outside the clock
    lines, best, best_ms, want = [], dict(defaults), float("inf"), None
    with _build.counted_apart(LAUNCHES):
        for cand in _candidates(op, defaults):
            line = {"params": cand}
            try:
                ms, out = _time(runner, cand)
            except (RuntimeError, ValueError) as e:
                line["error"] = f"{type(e).__name__}: {e}"
                lines.append(line)
                if want is None:       # the default itself must launch
                    raise
                continue
            line["ms"] = ms
            if want is None:
                want = [t.clone() for t in out]
            elif not _same_bits(out, want):
                line["error"] = "output differs from the default's"
                lines.append(line)
                continue
            lines.append(line)
            if ms < best_ms:
                best, best_ms = cand, ms
    # repro: ignore[RS104] the tuner's tables, under _lock
    REPORT.append({"key": key, "candidates": lines, "winner": best,
                   "winner_ms": best_ms})
    return best


def resolve(op: str, defaults: Dict[str, int], *, length: int,
            window: Optional[int] = None, measure: Optional[str] = None,
            backend: str = "cuda", runner: Optional[Runner] = None,
            device: Optional[torch.device] = None,
            check: Optional[Check] = None) -> Dict[str, int]:
    """Every launch parameter of ``op`` at the given geometry: the
    defaults in ``off`` mode; else the pinned, persisted or (``auto``, on
    the card, given a ``runner``) measured entry.  ``runner(params)``
    launches the op with ``params`` into fresh outputs and returns them;
    ``check(params)`` raises ``ValueError`` where the call's launch cannot
    take ``params`` (such an entry is measured again, or the default
    used)."""
    m = mode()
    if m == "off":
        return defaults
    key = table_key(op, length=length, window=window, measure=measure,
                    backend=backend)
    if m != "auto":                      # a pinned table
        entry = dict(defaults, **_load(m).get(key, {}))
        return entry if _admits(check, entry) else defaults
    with _lock:
        stored = _memo.get(key, _load(_out_path()).get(key))
        if stored is not None and _admits(check, dict(defaults, **stored)):
            # repro: ignore[RS104] the tuner's tables, under _lock
            _memo[key] = stored
            return dict(defaults, **stored)
        if runner is None or not _can_measure(device):
            return defaults
        best = _measure(key, op, defaults, runner)
        # repro: ignore[RS104] the tuner's tables, under _lock
        _memo[key] = best
        _persist(_out_path(), key, best)
        return best


def tuned(op: str, param: str, *, length: int, window: Optional[int] = None,
          measure: Optional[str] = None, backend: str = "cuda",
          default: int = 8, runner: Optional[Runner] = None,
          device: Optional[torch.device] = None,
          check: Optional[Callable[[int], object]] = None) -> int:
    """Resolve one launch parameter for ``op`` (:func:`resolve` with
    ``{param: default}``): ``default`` in ``off`` mode and for any key a
    table lacks or whose entry ``check(value)`` refuses."""
    entry = resolve(op, {param: default}, length=length, window=window,
                    measure=measure, backend=backend, runner=runner,
                    device=device,
                    check=None if check is None
                    else lambda p: check(p[param]))
    return int(entry.get(param, default))


def adaptive_width(length: int, window: Optional[int], lane: int = 8, *,
                   measure: Optional[str] = None, backend: str = "cuda",
                   factor: int = 8, radius: int = 2) -> int:
    """Register width cap for ``band="adaptive"`` sweeps: the projected
    coarse cells span about ``3 * factor`` fine rows per diagonal, plus
    the safety radius on both sides, rounded up to ``lane``; never wider
    than the static register.  A table may override it per bucket; it is
    never measured (no runner), since it changes the result.

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
    """Drop every memo, cached table, report line and launch count
    (tests)."""
    with _lock:
        _memo.clear()
        _pinned.clear()
        REPORT.clear()
        LAUNCHES.clear()
