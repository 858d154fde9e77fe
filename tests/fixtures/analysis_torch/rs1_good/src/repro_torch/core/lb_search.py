"""Clean equivalents of the rs1_bad tree: zero findings expected."""

import torch


def filtered_topk(x, k=4):
    d = helper(x)
    d = torch.where((d > 0).any(), -d, d)
    if x.shape[0] > k:           # a shape test: decided on the host
        d = d[:, :k]
    return torch.sort(d).values[:k]


def helper(x):
    return x - x.min()


def memo(x):
    return x


def offline(x):
    return x.cpu().numpy()
