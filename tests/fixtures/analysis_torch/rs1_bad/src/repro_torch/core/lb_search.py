"""Seeded RS1xx violations: every finding here is asserted by
tests/test_torch_analysis.py.  ``filtered_topk`` is a declared hot root
(repro_torch.analysis.callgraph.HOT_ROOTS)."""

import numpy as np
import torch

_CACHE = {}


def filtered_topk(x, k=4):
    d = helper(x)
    if (d > 0).any():  # RS102: an implicit bool(tensor) on a hot path
        d = -d
    memo(x)
    return torch.sort(d).values[:k]


def helper(x):
    v = float(x.min())  # RS101: a host read, hot via filtered_topk
    rows = np.asarray(torch.abs(x))  # RS101: pulls the tensor to the host
    del rows
    return x - v


def memo(x):
    _CACHE[x.shape] = x  # RS104: module state mutated on a hot path
    return x


def report(x):
    return x.item()  # RS101: an unconditional sync, flagged anywhere


def offline(x):
    # a host read is only a finding on a hot path; this function is
    # never reached from a hot root, so this line must NOT be flagged
    return x.cpu().numpy()
