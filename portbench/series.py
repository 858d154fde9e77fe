"""Class-structured synthetic series, made on the device from the seed.

The UCR archive is not in the repository, so each configuration stands in
a dataset of the same length, counts and class count.  A class is a sum
of shape components with random onsets, durations and phases, so elastic
alignment matters, plus Gaussian noise; every series is z-normalised.
The components are those of the repository's generators (copied here so
that the yardstick stays put): Cylinder-Bell-Funnel's plateau, ramp up
and ramp down (Saito 1994), and the Trace-like sine carrier, level step
and sharp peak.  A configuration's ``classes`` lists each class's
components; the generator is vectorised over series, one call per draw.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple

import torch

__all__ = ["COMPONENTS", "substream", "generator", "make_series"]

COMPONENTS = ("cylinder", "bell", "funnel", "sine", "step", "peak")


def substream(seed: int, name: str) -> int:
    """A 63-bit seed for the named stream of ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(substream(seed, name))
    return g


def _uniform(g, n, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=dev)


def make_series(n: int, length: int, classes: Sequence[Sequence[str]],
                noise: float, g: torch.Generator, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` series of ``length`` -> ``(X (n, length) float32, y (n,)
    int64)``; labels uniform over the classes."""
    dev = torch.device(device)
    L = length
    used = {c for cls in classes for c in cls}
    if used - set(COMPONENTS):
        raise ValueError(f"unknown components {sorted(used - set(COMPONENTS))}")
    weights = torch.tensor([[float(c in cls) for c in COMPONENTS]
                            for cls in classes], device=dev)
    y = torch.randint(len(classes), (n,), generator=g, device=dev)
    w = weights[y]                                          # (n, components)
    t = torch.arange(L, dtype=torch.float32, device=dev)[None, :]
    u = t / max(L - 1, 1)
    # Cylinder-Bell-Funnel's event: onset a, end b, amplitude eta
    a = torch.randint(L // 8, max(L // 2, L // 8 + 1), (n, 1), generator=g,
                      device=dev).float()
    dur = torch.randint(L // 4, max(L // 2, L // 4 + 1), (n, 1), generator=g,
                        device=dev).float()
    b = torch.clamp(a + dur, max=L - 1)
    eta = 6.0 + torch.randn((n, 1), generator=g, device=dev)
    inside = ((t >= a) & (t <= b)).float()
    span = torch.clamp(b - a, min=1.0)
    # Trace's morphologies: carrier phase, step and peak locations
    phase = _uniform(g, (n, 1), -0.1, 0.1, dev)
    step_at = _uniform(g, (n, 1), 0.45, 0.55, dev)
    peak_at = _uniform(g, (n, 1), 0.20, 0.30, dev)
    X = noise * torch.randn((n, L), generator=g, device=dev)
    parts = {
        "cylinder": lambda: eta * inside,
        "bell": lambda: eta * inside * (t - a) / span,
        "funnel": lambda: eta * inside * (b - t) / span,
        "sine": lambda: 3.0 * torch.sin(2 * math.pi * (2 * u + phase)),
        "step": lambda: 4.5 * (u > step_at).float(),
        "peak": lambda: 6.0 * torch.exp(-(u - peak_at) ** 2
                                        / (2 * 0.01 ** 2)),
    }
    for k, name in enumerate(COMPONENTS):
        if name in used:
            X += w[:, k:k + 1] * parts[name]()
    X = (X - X.mean(1, keepdim=True)) / torch.clamp(
        X.std(1, keepdim=True, correction=0), min=1e-9)
    return X.contiguous(), y
