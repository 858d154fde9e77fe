"""The port's docstring examples, run as tests (on the CPU: every example
passes ``device="cpu"`` or works on CPU tensors)."""

import doctest
import importlib

import pytest

MODULES = (
    "repro_torch._tree",
    "repro_torch.checkpoint.ckpt",
    "repro_torch.core.baselines",
    "repro_torch.core.cluster",
    "repro_torch.core.corridor",
    "repro_torch.core.dba",
    "repro_torch.core.dispatch",
    "repro_torch.core.measures",
    "repro_torch.core.pq",
    "repro_torch.core.topk",
    "repro_torch.index.planner",
    "repro_torch.index.streaming",
    "repro_torch.kernels.dtw_band.ops",
    "repro_torch.kernels.lb_cascade.ops",
    "repro_torch.kernels.pq_adc.ops",
    "repro_torch.kernels.pq_attn.ops",
    "repro_torch.kernels.prealign_encode.ops",
    "repro_torch.kernels.tune",
    "repro_torch.launch.specs",
    "repro_torch.models.encdec",
    "repro_torch.models.ssm",
    "repro_torch.obs",
    "repro_torch.serve.pqkv",
    "repro_torch.serve_index.config",
    "repro_torch.train.step",
)


@pytest.mark.parametrize("name", MODULES)
def test_module_doctests(name):
    mod = importlib.import_module(name)
    result = doctest.testmod(mod, verbose=False, report=True)
    assert result.attempted > 0, f"{name} has no doctest examples"
    assert result.failed == 0, f"{name}: {result.failed} doctest(s) failed"
