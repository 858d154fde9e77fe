"""Pipeline stage spans and the obs on/off switch (counterpart of
:mod:`repro.obs.spans`).

``span("stage")`` times a host-visible pipeline stage into the
``stage_seconds`` histogram of :data:`repro_torch.obs.registry.REGISTRY`
(labeled ``stage=<name>``), and bridges into device profiles through
``torch.profiler.record_function``, so the same stage names show up on
the timeline when a ``torch.profiler`` trace is active.

Zero-overhead-by-default is the load-bearing contract.  ``span()`` takes
one of three forms:

* obs disabled (the default — enable with ``REPRO_OBS=1`` or
  :func:`enable`) and no ``torch.profiler`` recording: a shared no-op
  context manager.  No clock reads, no histogram writes, no
  ``record_function``;
* obs disabled under a recording profiler: an annotation-only span.  It
  enters ``record_function(name)`` and nothing else: no clock read, no
  registry write, and its :meth:`fence` is the identity.  The stage then
  sits on the profiler's host clock beside the CUDA runtime calls it
  makes, and each kernel is tied to it through its launch's correlation
  id, whatever the offset between the device's clock and the host's;
* obs enabled: the annotation, a ``stage_seconds`` sample, and a
  :meth:`Span.fence` that calls ``torch.cuda.synchronize()`` when its
  argument holds a CUDA tensor, so work launched asynchronously on the
  card is attributed to the span that launched it instead of leaking
  into whichever stage happens to block next.  CPU tensors are computed
  eagerly and need no fence.

With obs disabled a fence NEVER synchronises the card, so the
instrumented code makes no device sync the un-instrumented code would
not have made.  Timed spans nest and re-enter freely: each ``with`` entry
pushes onto a thread-local stack and records its own sample on exit,
exceptions included.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from .registry import REGISTRY

__all__ = ["ENV_VAR", "enabled", "enable", "disable", "override", "span",
           "current_spans", "fence", "Span"]

ENV_VAR = "REPRO_OBS"

_enabled = os.environ.get(ENV_VAR, "0").lower() not in ("", "0", "false")

_local = threading.local()

# test seam: monkeypatch to observe/forbid device syncs
_block = torch.cuda.synchronize


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


class override:
    """Scoped enable/disable (tests)."""

    def __init__(self, on: bool):
        self.on = bool(on)
        self._prev: Optional[bool] = None

    def __enter__(self):
        global _enabled
        self._prev = _enabled
        _enabled = self.on
        return self

    def __exit__(self, *exc):
        global _enabled
        _enabled = self._prev
        return False


def _stack() -> List[str]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current_spans() -> tuple:
    """Names of the spans currently open on this thread, outermost first."""
    return tuple(_stack())


def _cuda_tensors(x) -> bool:
    """True when ``x`` (a tensor or nested tuples/lists/dicts of them)
    holds a CUDA tensor."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_cuda_tensors(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return any(_cuda_tensors(v) for v in x)
    return False


def fence(x):
    """Synchronise the card when obs is enabled and ``x`` holds a CUDA
    tensor; identity (and in particular no sync) otherwise."""
    if _enabled and _cuda_tensors(x):
        _block()
    return x


class Span:
    """One timed stage entry (enabled path — see :func:`span`)."""

    __slots__ = ("name", "_t0", "_annotation")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0
        self._annotation = None

    def __enter__(self):
        _stack().append(self.name)
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        self._annotation.__exit__(exc_type, exc, tb)
        st = _stack()
        if st and st[-1] == self.name:
            st.pop()
        REGISTRY.histogram("stage_seconds", persistent=True,
                           stage=self.name).record(dt)
        return False

    def fence(self, x):
        """Synchronise on ``x`` so its device work lands in this span;
        returns ``x`` for inline use."""
        return fence(x)


class _NullSpan:
    """Disabled path: one shared immutable no-op for every span() call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def fence(x):
        return x


_NULL_SPAN = _NullSpan()


class _AnnotationSpan:
    """Disabled path under a recording profiler: the annotation alone."""

    __slots__ = ("_annotation",)

    def __init__(self, name: str):
        self._annotation = torch.profiler.record_function(name)

    def __enter__(self):
        self._annotation.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._annotation.__exit__(exc_type, exc, tb)
        return False

    @staticmethod
    def fence(x):
        return x


def span(name: str):
    """Context manager for stage ``name`` (module docstring)."""
    if _enabled:
        return Span(name)
    if _autograd_profiler._is_profiler_enabled:
        return _AnnotationSpan(name)
    return _NULL_SPAN
