"""badk entry point: no ref.py sibling, not imported by core/dispatch.py."""

import torch

from .. import _build


def run_badk(x):
    out = torch.empty_like(x)
    lib, stream = _build.lib(), _build.stream(x.device)
    lib.pq_badk(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    return out
