"""Synthetic time-series generators.

The UCR archive is not available offline, so benchmarks/tests use
class-structured surrogates with the same statistical character:

* ``random_walks``   — the paper's Fig. 5 scaling workload.
* ``cbf``            — Cylinder-Bell-Funnel, the classic 3-class shape task
                       with random onset/duration (warping matters).
* ``trace_like``     — smooth sine/step morphologies with phase jitter,
                       mimicking the Trace dataset used in Fig. 3.
* ``gun_point_like`` — two classes differing in a localized bump.

All generators are deterministic given a seed and return float32
``(N, D)`` arrays plus integer labels where applicable.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["random_walks", "cbf", "trace_like", "gun_point_like",
           "znorm", "make_dataset"]


def znorm(X: np.ndarray) -> np.ndarray:
    mu = X.mean(-1, keepdims=True)
    sd = X.std(-1, keepdims=True)
    return ((X - mu) / np.maximum(sd, 1e-9)).astype(np.float32)


def random_walks(n: int, length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    steps = rng.standard_normal((n, length)).astype(np.float32)
    return znorm(np.cumsum(steps, axis=1))


def cbf(n_per_class: int, length: int = 128, seed: int = 0
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Cylinder-Bell-Funnel (Saito 1994). Classes: 0=cyl, 1=bell, 2=funnel."""
    rng = np.random.default_rng(seed)
    n = 3 * n_per_class
    X = np.zeros((n, length), np.float32)
    y = np.repeat(np.arange(3), n_per_class)
    t = np.arange(length)
    for i in range(n):
        a = rng.integers(length // 8, length // 2)
        b = a + rng.integers(length // 4, length // 2)
        b = min(b, length - 1)
        eta = rng.normal(6.0, 1.0)
        eps = rng.standard_normal(length)
        mask = ((t >= a) & (t <= b)).astype(np.float32)
        if y[i] == 0:          # cylinder: plateau
            shape = mask
        elif y[i] == 1:        # bell: ramp up
            shape = mask * (t - a) / max(b - a, 1)
        else:                  # funnel: ramp down
            shape = mask * (b - t) / max(b - a, 1)
        X[i] = eta * shape + eps
    return znorm(X), y


def trace_like(n_per_class: int, length: int = 256, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Smooth morphologies with phase jitter: 4 classes mixing a sine carrier
    with/without a mid-series step and a sharp gaussian peak."""
    rng = np.random.default_rng(seed)
    n = 4 * n_per_class
    X = np.zeros((n, length), np.float32)
    y = np.repeat(np.arange(4), n_per_class)
    t = np.linspace(0, 1, length)
    for i in range(n):
        phase = rng.uniform(-0.1, 0.1)
        noise = 0.05 * rng.standard_normal(length)
        sig = np.sin(2 * np.pi * (2 * t + phase))
        if y[i] % 2 == 1:      # add step
            loc = 0.5 + rng.uniform(-0.05, 0.05)
            sig = sig + 1.5 * (t > loc)
        if y[i] >= 2:          # add sharp peak
            loc = 0.25 + rng.uniform(-0.05, 0.05)
            sig = sig + 2.0 * np.exp(-((t - loc) ** 2) / (2 * 0.01 ** 2))
        X[i] = sig + noise
    return znorm(X), y


def gun_point_like(n_per_class: int, length: int = 150, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    n = 2 * n_per_class
    X = np.zeros((n, length), np.float32)
    y = np.repeat(np.arange(2), n_per_class)
    t = np.linspace(0, 1, length)
    for i in range(n):
        rise = 0.3 + rng.uniform(-0.05, 0.05)
        fall = 0.7 + rng.uniform(-0.05, 0.05)
        plateau = 1.0 / (1 + np.exp(-40 * (t - rise))) * \
            (1 - 1.0 / (1 + np.exp(-40 * (t - fall))))
        if y[i] == 1:          # overshoot dip ("gun" draw artifact)
            plateau = plateau + 0.4 * np.exp(
                -((t - rise) ** 2) / (2 * 0.015 ** 2))
        X[i] = plateau + 0.03 * rng.standard_normal(length)
    return znorm(X), y


_GENS = {"cbf": cbf, "trace": trace_like, "gunpoint": gun_point_like}


def make_dataset(name: str, n_per_class: int, length: int, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    if name == "cbf":
        return cbf(n_per_class, length, seed)
    if name == "trace":
        return trace_like(n_per_class, length, seed)
    if name == "gunpoint":
        return gun_point_like(n_per_class, length, seed)
    raise KeyError(f"unknown dataset {name!r}; options: {sorted(_GENS)}")
