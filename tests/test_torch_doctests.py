"""The port's docstring examples, run as tests (on the CPU: every example
passes ``device="cpu"`` or works on CPU tensors)."""

import doctest
import importlib

import pytest

MODULES = (
    "repro_torch.core.baselines",
    "repro_torch.core.cluster",
    "repro_torch.core.corridor",
    "repro_torch.core.dba",
    "repro_torch.core.dispatch",
    "repro_torch.core.measures",
    "repro_torch.core.pq",
    "repro_torch.core.topk",
    "repro_torch.index.streaming",
    "repro_torch.kernels.dtw_band.ops",
    "repro_torch.kernels.lb_cascade.ops",
    "repro_torch.kernels.pq_adc.ops",
    "repro_torch.kernels.pq_attn.ops",
    "repro_torch.kernels.tune",
    "repro_torch.obs",
)


@pytest.mark.parametrize("name", MODULES)
def test_module_doctests(name):
    mod = importlib.import_module(name)
    result = doctest.testmod(mod, verbose=False, report=True)
    assert result.attempted > 0, f"{name} has no doctest examples"
    assert result.failed == 0, f"{name}: {result.failed} doctest(s) failed"
