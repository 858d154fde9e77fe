"""Seeded RS3xx violations."""

import threading

from .view import IndexView


class Server:
    _WRITER_ONLY = frozenset({"_index", "_view"})
    _WRITER_METHODS = frozenset({"_apply"})

    def __init__(self, index):
        self._index = index
        self._lock = threading.Lock()
        self._view = IndexView.capture(index)

    def _apply(self, batch):
        self._index = batch  # writer method: allowed

    def search(self, q):
        self._view = None  # RS301: writer-only field off writer thread
        view = self._view
        view.version = 9  # RS302: mutating a published view
        self._lock.acquire()  # RS303
        try:
            return view, q
        finally:
            self._lock.release()  # RS303
