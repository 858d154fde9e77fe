"""Production serving core over the streaming index (counterpart of
:mod:`repro.serve_index`).

Coalesced query microbatching (bucketed padded searches: a warmed server
answers mixed traffic with the same launches per request size) and a
concurrent ingest writer publishing immutable copy-on-write snapshots,
with admission control on the write path.  It runs on the index's device.

    from repro_torch.serve_index import IndexServer, ServeConfig

    with IndexServer(index, ServeConfig(n_probe=4, topk=3)) as srv:
        srv.insert(X).result()
        dist, ids = srv.search(Q)
"""

from .config import SHED_POLICIES, ServeConfig
from .coalescer import QueryCoalescer
from .server import Backpressure, IndexServer, SearchResult
from .view import IndexView

__all__ = [
    "IndexServer",
    "ServeConfig",
    "SHED_POLICIES",
    "IndexView",
    "SearchResult",
    "Backpressure",
    "QueryCoalescer",
]
