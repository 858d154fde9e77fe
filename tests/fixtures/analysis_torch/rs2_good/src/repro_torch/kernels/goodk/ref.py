"""Plain version of the goodk kernel."""

import torch


def run_goodk_ref(x):
    return torch.mul(x, 2)
