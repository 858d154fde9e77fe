"""Public entry point of the goodk kernel (csrc/mini.cu)."""

import torch

from .. import _build
from .ref import run_goodk_ref


def run_goodk(x):
    if not x.is_cuda:
        return run_goodk_ref(x)
    out = torch.empty_like(x)
    status = _build.lib().pq_goodk(x.data_ptr(), out.data_ptr(), x.numel(),
                                   _build.stream(x.device))
    if status:
        raise RuntimeError("goodk launch failed")
    return out
