"""Record writer and timer of the torch benchmark legs (the port's
counterpart of ``benchmarks/common.py``, which imports JAX).

:class:`Bench` collects rows, prints each, and :meth:`Bench.save` writes
``<out_dir>/hw_<cuda|cpu>_<name>.json`` with the device's name, the
``nvidia-smi --query-gpu=name,power.limit`` line on the card (``None`` on
the CPU) and the rows.  Nothing else is written.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional

import torch

from .. import _device

__all__ = ["OUT_DIR", "Bench", "sync", "timeit", "nvidia_smi_line",
           "device_args"]

OUT_DIR = os.path.join("experiments", "bench")


def sync(device: torch.device) -> None:
    """Wait for the card (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn: Callable, device: torch.device, *, repeats: int = 3,
           warmup: int = 1) -> Dict[str, object]:
    """Median wall time of ``fn()`` after ``warmup`` calls, each call
    ending in a synchronize, the samples in call order, and the last
    call's result (``"last"``)."""
    for _ in range(warmup):
        fn()
        sync(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        last = fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return {"median_s": statistics.median(times), "samples_s": times,
            "last": last}


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_args(ap: argparse.ArgumentParser) -> None:
    """The legs' shared flags: ``--device`` (default: the card) and
    ``--out`` (default :data:`OUT_DIR`)."""
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory of the JSON record")


class Bench:
    """Rows of one suite on one device, printed as they come and saved as
    one JSON record."""

    def __init__(self, name: str, device: _device.DeviceArg = None,
                 out_dir: str = OUT_DIR):
        self.name = name
        self.device = _device.resolve_device(device)
        self.out_dir = out_dir
        self.rows: List[dict] = []

    def add(self, **row) -> None:
        self.rows.append(row)
        print("  " + " ".join(f"{k}={_fmt(v)}" for k, v in row.items()),
              flush=True)

    def save(self, headline: Optional[dict] = None) -> str:
        """Write the record; returns its path."""
        on_card = self.device.type == "cuda"
        record = {
            "name": self.name, "device": self.device.type,
            "device_name": (torch.cuda.get_device_name(self.device)
                            if on_card else "cpu"),
            "nvidia_smi": nvidia_smi_line() if on_card else None,
            "torch": torch.__version__, **(headline or {}),
            "rows": self.rows}
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir,
                            f"hw_{self.device.type}_{self.name}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
        print(f"  saved {path}", flush=True)
        return path


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)
