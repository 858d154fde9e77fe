"""Plain version of the nolib kernel."""

import torch


def run_nolib_ref(x):
    return torch.add(x, 1)
