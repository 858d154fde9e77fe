"""vmap over a plain function: no RS204 finding."""

import torch

from .kernels.goodk.ref import run_goodk_ref


def batched(xs):
    return torch.vmap(run_goodk_ref)(xs)
