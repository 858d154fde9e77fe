"""The benchmark's guard against the JAX reference package: a module
counts by its whole top-level name, the part before the first dot, so
``repro_torch`` (the port) passes and ``repro`` (the JAX package) does
not."""

from __future__ import annotations

from typing import Iterable, List

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
