"""Mini dispatch: every counted op imported and routing-gated."""

from ..kernels.goodk.ops import run_goodk


def _count(op, route, measure=None):
    del op, route, measure


def goodk(x):
    _count("goodk", "cuda" if x.is_cuda else "torch")
    return run_goodk(x)


def goodk_adaptive(x):
    # a mode twin, gated in EXPECTED_OPS
    _count("goodk_adaptive", "cuda" if x.is_cuda else "torch")
    return run_goodk(x)
