"""RS204 seed: vmap over a function that reaches a CUDA launch."""

import torch

from .kernels.badk.ops import run_badk


def batched(xs):
    return torch.vmap(run_badk)(xs)  # RS204
