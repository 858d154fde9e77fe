"""The lower-precision control at a size a test run holds: the plain
reference computed in bfloat16, put in the program's place, fails each
cell's limit on three seeds; computed in float32 it answers for itself
with every number 0.  (On an H100, at the cells' own sizes:
``python3 portbench/control.py``.)"""

import pytest
import torch

from portbench.harness import _merge
from portbench.manifest import load_cell, load_manifest

from .conftest import BIG_SEED, TINY

CELLS = [w["name"] for w in load_manifest()["workloads"]]
# longer series and more queries than the tiny runs: the widest gap grows
# with both, as at the cells' own sizes
SIZES = _merge(TINY, {"dataset": {"length": 192, "n_test": 160}})


def _entry(cell, seed):
    import importlib
    c = load_cell(cell, load_manifest())
    mod = importlib.import_module(f"portbench.entries.{c.traffic['entry']}")
    e = mod.Cell(_merge(c.config, SIZES), c.traffic, seed, "cpu")
    e.make_inputs()
    return e, c.workload["limits"]


@pytest.mark.parametrize("seed", [BIG_SEED, 7, 123456789])
@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_fails(cell, seed):
    e, limits = _entry(cell, seed)
    numbers = e.check(e.control_answers(torch.bfloat16))
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("cell", CELLS)
def test_float32_reference_answers_for_itself(cell):
    e, limits = _entry(cell, BIG_SEED)
    numbers = e.check(e.control_answers(torch.float32))
    assert all(v == 0.0 for v in numbers.values()), numbers
