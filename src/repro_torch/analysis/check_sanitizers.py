"""Dynamic sanitizer over the dispatch surface (the counterpart of the
reference's ``scripts/check_sanitizers.py``): every dispatch op on tiny
device-resident CUDA inputs under PyTorch's sync debug mode.

Usage: ``python -m repro_torch.analysis.check_sanitizers`` (needs a card)

Each op runs once to warm up (the kernel library loads, the allocator
grows), then again under ``torch.cuda.set_sync_debug_mode("error")``:
any call that waits for the card — ``.item()``, ``.tolist()``, ``.cpu()``,
a blocking copy in either direction, ``torch.cuda.synchronize()`` —
raises, and the op is reported with the innermost port frame that made
the call.  This is the analogue of the reference's
``jax.transfer_guard_device_to_host("disallow")``; the mode is stricter,
since a blocking upload of a constant trips it too.  The mode is reset in
a ``finally``.  A sync inside the kernel library (ctypes) is invisible to
it: RS101 reads ``kernels/csrc`` for that.

The reference's second leg, ``jax.checking_leaks`` around a fresh trace,
has no counterpart: the port runs eagerly and has no tracers to leak
(RS104 still guards module state statically).

Exit 0 clean, 1 on any trip, 2 without a card.  An op listed in
:data:`KNOWN_READS` would trip at a read the reference's op does not make,
held in ROADMAP queue 3 until it moves off the scan; the list is empty
(the ADC range check, its last entry, now checks codes where they enter
the program, not per launch).  ``chip_smoke.py`` runs :func:`run`
in-process as its ``sanitizer_path`` phase, with a seeded ``.item()``
that must trip, and holds the trips to exactly that one and
:data:`KNOWN_READS`, each at its own call.
"""

from __future__ import annotations

import re
import sys
import traceback
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["KNOWN_READS", "device_ops", "known", "run", "main"]

Thunk = Callable[[], object]

# op -> (file, function) of a read-back it makes where the reference's op
# makes none (ROADMAP queue 3); none is left
KNOWN_READS: Dict[str, Tuple[str, str]] = {}


def device_ops(device: str = "cuda") -> List[Tuple[str, Thunk]]:
    """``(name, thunk)`` per dispatch op (the reference's seven, the
    adaptive and quantised modes and the encode's LB filter: every name
    of the routing gate's ``EXPECTED_OPS``), then each of its
    ``MEASURED_OPS`` under a non-DTW measure (``op[measure]``), then the
    two 1-NN entry points over encoded codes, on tiny inputs made here,
    before any guard."""
    import torch

    from ..core import dispatch

    A = torch.zeros((2, 8), device=device)
    B = torch.ones((2, 8), device=device)
    B3 = torch.ones((3, 8), device=device)
    codes = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32, device=device)
    lut = torch.stack([1.0 - torch.eye(2, device=device)] * 2)
    qlut = torch.tensor([[0.0, 2.0], [0.0, 2.0]], device=device)
    env = torch.zeros((2, 8), device=device)
    thresh = torch.tensor([100.0, 0.0], device=device)
    cents = torch.stack([torch.zeros((2, 5), device=device),
                         torch.ones((2, 5), device=device)], dim=1)
    coarse = (torch.arange(4, dtype=torch.float32, device=device)[:, None]
              * torch.ones(8, device=device))
    top = torch.tensor([[0.5] * 8, [2.5] * 8], device=device)
    child_idx = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32,
                             device=device)
    child_valid = torch.ones((2, 2), dtype=torch.bool, device=device)
    return [
        ("elastic_pairwise", lambda: dispatch.elastic_pairwise(A, B, 2)),
        ("elastic_pairwise_adaptive",
         lambda: dispatch.elastic_pairwise(A, B, 2, band="adaptive")),
        ("elastic_cdist", lambda: dispatch.elastic_cdist(A, B3, 2)),
        ("adc_cdist", lambda: dispatch.adc_cdist(codes, codes, lut)),
        ("adc_cdist_quant",
         lambda: dispatch.adc_cdist(codes, codes, lut, lut_dtype="int8")),
        ("adc_lookup", lambda: dispatch.adc_lookup(codes, qlut)),
        ("adc_lookup_quant",
         lambda: dispatch.adc_lookup(codes, qlut, lut_dtype="int8")),
        ("prealign_encode", lambda: dispatch.prealign_encode(
            A, cents, level=1, tail=1, window=2)),
        ("lb_refine", lambda: dispatch.lb_refine(A, B, env, env, thresh, 2)),
        ("lb_refine_adaptive", lambda: dispatch.lb_refine(
            A, B, env, env, thresh, 2, band="adaptive")),
        ("two_level_coarse", lambda: dispatch.two_level_coarse(
            A, top, coarse, child_idx, child_valid, n_probe_top=1)),
        ("lb_filter", lambda: dispatch.lb_filter(
            A[:, None], B3[None], B3[None], B3[None], 1)),
        ("elastic_pairwise[wdtw]", lambda: dispatch.elastic_pairwise(
            A, B, 2, measure="wdtw:g=0.1")),
        ("elastic_cdist[erp]", lambda: dispatch.elastic_cdist(
            A, B3, 2, measure="erp:g=0.3")),
        ("prealign_encode[msm]", lambda: dispatch.prealign_encode(
            A, cents, level=1, tail=1, window=2, measure="msm:c=0.5")),
        ("two_level_coarse[msm]", lambda: dispatch.two_level_coarse(
            A, top, coarse, child_idx, child_valid, n_probe_top=1,
            measure="msm:c=0.5")),
        *_entry_points(device),
    ]


def _entry_points(device: str) -> List[Tuple[str, Thunk]]:
    """The 1-NN entry points over codes the program made (``pq.encode``,
    before any guard): the public ``pq`` distances they call check a
    caller's codes, and codes the program made pass without a read."""
    import torch

    from ..core import knn, pq

    cfg = pq.PQConfig(n_sub=2, codebook_size=2, use_prealign=False,
                      kmeans_iters=1, dba_iters=1)
    X = torch.arange(32, dtype=torch.float32, device=device).reshape(4, 8)
    X = X / 10.0
    cb = pq.fit(X, cfg, torch.Generator().manual_seed(0), device=device)
    codes = pq.encode(X, cb, cfg, device=device)
    labels = torch.arange(4, device=device)
    return [
        ("knn_classify_sym", lambda: knn.knn_classify_sym(
            codes, labels, X, cb, cfg, device=device)),
        ("knn_classify_asym", lambda: knn.knn_classify_asym(
            codes, labels, X, cb, cfg, device=device)),
    ]


def _culprit(exc: BaseException) -> str:
    """``path:line in function: code`` of the innermost frame of the package (not of
    this gate) on the way to the sync, else of the innermost frame."""
    frames = traceback.extract_tb(exc.__traceback__)
    here = Path(__file__).name
    pkg = [f for f in frames
           if "repro_torch" in f.filename and Path(f.filename).name != here]
    f = (pkg or frames)[-1]
    return f"{f.filename}:{f.lineno} in {f.name}: {(f.line or '').strip()}"


def known(name: str, culprit: Optional[str],
          reads: Optional[Dict[str, Tuple[str, str]]] = None) -> bool:
    """Whether op ``name`` tripped at the read ``reads`` (by default
    :data:`KNOWN_READS`) lists for it (a trip anywhere else is new)."""
    reads = KNOWN_READS if reads is None else reads
    if culprit is None or name not in reads:
        return False
    path, func = reads[name]
    return re.search(rf"/{re.escape(path)}:\d+ in {re.escape(func)}: ",
                     culprit) is not None


def run(ops: Iterable[Tuple[str, Thunk]]
        ) -> List[Tuple[str, Optional[str]]]:
    """``(name, None)`` for an op clean under the sync debug mode,
    ``(name, culprit)`` for one that tripped it (or failed otherwise)."""
    import torch

    out = []
    for name, thunk in ops:
        try:
            thunk()
            torch.cuda.synchronize()
        except Exception as e:                          # noqa: BLE001
            out.append((name, f"warm-up {type(e).__name__}: {e}"))
            continue
        prev = torch.cuda.get_sync_debug_mode()
        try:
            torch.cuda.set_sync_debug_mode("error")
            thunk()
            err = None
        except Exception as e:                          # noqa: BLE001
            err = f"{type(e).__name__}: {_culprit(e)}"
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()
        out.append((name, err))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_sanitizers: no CUDA device")
        return 2
    results = run(device_ops())
    for name, err in results:
        print(f"  {'ok  ' if err is None else 'TRIP'} {name}"
              + ("" if err is None else f"  <- {err}")
              + ("  (known: ROADMAP queue 3)" if known(name, err) else ""))
    trips = [name for name, err in results if err is not None]
    if trips:
        print(f"FAIL: {len(trips)} op(s) read the card back under "
              f"set_sync_debug_mode('error'): {', '.join(trips)}")
        return 1
    print(f"OK: {len(results)} ops clean under "
          f"set_sync_debug_mode('error')")
    return 0


if __name__ == "__main__":
    sys.exit(main())
