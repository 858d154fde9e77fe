"""Clean equivalents of the rs3_bad tree: zero findings expected."""

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
        self._index = batch
        self._view = IndexView.capture(batch, version=1)

    def search(self, q):
        view = self._view
        with self._lock:
            return view, q
