"""The warm-path gate of the serving core: a warmed server replays serial
traffic with nothing new (the port's counterpart of
``scripts/check_recompile.py``).

The reference's gate counts XLA compilations.  The port compiles nothing
at run time once its kernel library is loaded and captures no graph, so
"nothing new" means three things here:

* **no kernel build**: the library was loaded during the warm-up (on the
  card), so no replay loads, and therefore builds, it;
* **the same launches per request size** on every replay: each request's
  deltas of :data:`~repro_torch.kernels._build.LAUNCHES` and of
  :data:`repro_torch.core.dispatch.stats`;
* **no growth of** ``torch.cuda.memory_reserved()`` across the second
  replay (the caching allocator already holds every block it needs).

Warm-up sends one request of each size (default: every size from 1 to the
largest bucket, so every bucket is reached), one at a time, each waiting
for its answer; each replay sends the same sequence again.  The server's
index must take no writes meanwhile.

    from repro_torch.bench.warm_replay import warm_replay
    report = warm_replay(server, Q)
    assert report["ok"], report["failures"]
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core import dispatch
from ..kernels import _build

__all__ = ["warm_replay"]


def _deltas(after: dict, before: dict) -> Dict[str, int]:
    return {str(k): v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _reserved(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    # repro: ignore[RS101] reserved bytes are read once the card is done
    torch.cuda.synchronize(device)
    return torch.cuda.memory_reserved(device)


def warm_replay(server, Q, sizes: Optional[Sequence[int]] = None) -> dict:
    """Warm ``server`` with one serial request of each of ``sizes`` rows of
    ``Q``, replay the sequence twice and check the three conditions of the
    module docstring.

    Returns ``{"ok", "failures", "sizes", "launches", "dispatch",
    "lib_loaded", "reserved_bytes"}``: ``launches`` and ``dispatch`` map
    each request size to its deltas on the second replay,
    ``reserved_bytes`` is ``[before, after]`` the second replay.
    """
    Q = np.asarray(Q, np.float32)
    if sizes is None:
        sizes = range(1, server.cfg.max_batch + 1)
    sizes = [int(n) for n in sizes]
    if max(sizes) > len(Q):
        raise ValueError(f"{len(Q)} queries cannot fill a request of "
                         f"{max(sizes)}")
    device = server.view.device
    server.quiesce()

    def one_pass() -> dict:
        seen = {}
        for n in sizes:
            launches0 = dict(_build.LAUNCHES)
            stats0 = dict(dispatch.stats)
            server.submit_search(Q[:n]).result()
            seen[n] = (_deltas(_build.LAUNCHES, launches0),
                       _deltas(dispatch.stats, stats0))
        return seen

    one_pass()                                   # the warm-up
    loaded = _build._lib is not None
    first = one_pass()
    reserved0 = _reserved(device)
    last = one_pass()
    reserved1 = _reserved(device)

    failures = []
    if device.type == "cuda" and not loaded:
        failures.append("the kernel library was not loaded by the warm-up")
    if (_build._lib is not None) != loaded:
        failures.append("the kernel library was loaded during a replay")
    for n in sizes:
        if first[n] != last[n]:
            failures.append(f"request of {n}: launches differ between "
                            f"replays: {first[n]} then {last[n]}")
    if reserved1 > reserved0:
        failures.append(f"memory_reserved grew from {reserved0} to "
                        f"{reserved1} bytes in the second replay")
    return {"ok": not failures, "failures": failures, "sizes": sizes,
            "launches": {n: last[n][0] for n in sizes},
            "dispatch": {n: last[n][1] for n in sizes},
            "lib_loaded": loaded, "reserved_bytes": [reserved0, reserved1]}
