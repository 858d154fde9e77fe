"""A run with the timed path broken underneath comes out not correct:
for each fault a classify cell can have, the harness's look for a chip
is skipped (the CPU route) and the rest of the run is driven as it is.

* an answer altered where it is produced: one label of one batch, made
  the training series farthest from that test series;
* a step that returns its state unchanged: each batch answered with the
  previous batch's labels.
(The cells run on one chip and average nothing over a batch, so there is
no exchange between chips and no batch mean to break.)
"""

import io

import pytest
import torch

from portbench.harness import run_cell
from portbench.manifest import load_manifest

from .conftest import BIG_SEED, TINY

CELLS = [w["name"] for w in load_manifest()["workloads"]]


def _run(cell, fault):
    return run_cell(cell, BIG_SEED, 1.0, False, device="cpu",
                    overrides=TINY, fault=fault, out=io.StringIO(),
                    err=io.StringIO())


def _altered_label(entry):
    launch = entry.launch
    calls = []

    def bad(p):
        out = launch(p)
        calls.append(p)
        if len(calls) == 3:
            out = out.clone()
            far = torch.cdist(entry.tests[p][5:6], entry.train).argmax()
            out[5] = far.to(out.dtype)
        return out
    entry.launch = bad


def _stale_labels(entry):
    launch = entry.launch
    last = []

    def bad(p):
        out = launch(p)
        prev = last[-1] if last else out
        last.append(out)
        return prev
    entry.launch = bad


@pytest.mark.parametrize("fault", [None, _altered_label, _stale_labels],
                         ids=["sound", "altered", "unchanged"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    result = _run(cell, fault)
    gap = result["checks"]["nn_gap"]
    if fault is None:
        assert result["correct"] is True and gap["value"] == 0.0
    else:
        assert result["correct"] is False
        assert gap["value"] > gap["limit"]
