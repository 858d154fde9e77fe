"""Mini dispatch: goodk and nolib imported; orphan_op not routing-gated."""

from ..kernels.goodk.ops import run_goodk
from ..kernels.nolib.ops import run_nolib


def _count(op, route, measure=None):
    del op, route, measure


def goodk(x):
    _count("goodk", "cuda" if x.is_cuda else "torch")
    return run_goodk(x)


def nolib(x):
    _count("goodk", "cuda" if x.is_cuda else "torch")
    return run_nolib(x)


def orphan(x):
    _count("orphan_op", "torch")  # RS203: not in EXPECTED_OPS
    return x


def orphan_adaptive(x):
    # RS203 twin: a mode-specific counter name that never made it into
    # the gate's EXPECTED_OPS (the adaptive/quant-path failure shape)
    _count("orphan_op_adaptive", "torch")
    return x
