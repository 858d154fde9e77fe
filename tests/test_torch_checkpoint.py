"""The port's checkpoint layer (``repro_torch.checkpoint.ckpt``): the
reference's cases (``tests/test_checkpoint.py``) on the port's trees of
tensors, bf16 leaves among them (stored as their 16 bits), and the
snapshot that ``AsyncCheckpointer.submit`` takes before an in-place
update.  Restored leaves are equal bit for bit."""

import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore, save)


class Pair(NamedTuple):
    w: torch.Tensor
    b: object


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((4, 8), generator=g),
            "h": torch.randn((3, 5), generator=g).bfloat16(),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "pair": Pair(w=torch.randn((2, 2), generator=g),
                                    b=None)},
            "layers": (torch.full((2,), float(seed)),
                       torch.full((3,), -float(seed)).bfloat16()),
            "scalar": torch.tensor(float(seed))}


def _zeros(tree):
    from repro_torch._tree import tree_map
    return tree_map(torch.zeros_like, tree)


def _equal(a, b):
    from repro_torch._tree import leaves
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


class TestSaveRestore:
    def test_roundtrip(self, tmp_path):
        d = str(tmp_path)
        t = _tree(3)
        save(d, 7, t)
        assert latest_step(d) == 7
        back = restore(d, 7, _zeros(t))
        _equal(t, back)
        assert back["nested"]["pair"].b is None

    def test_manifest_names_and_bf16_bits(self, tmp_path):
        """Leaf names are field paths; a bf16 leaf is stored as uint16
        bits with ``"bfloat16"`` in the manifest."""
        d = str(tmp_path)
        t = _tree(1)
        final = save(d, 2, t)
        with open(os.path.join(final, "manifest.json")) as f:
            man = json.load(f)
        names = [m["name"] for m in man["leaves"]]
        assert names == ["h", "layers__0", "layers__1", "nested__b",
                         "nested__pair__w", "scalar", "w"]
        meta = dict(zip(names, man["leaves"]))
        assert meta["h"]["dtype"] == "bfloat16"
        assert meta["w"]["dtype"] == "float32"
        assert meta["nested__b"]["dtype"] == "int32"
        bits = np.load(os.path.join(final, meta["h"]["file"]))
        assert bits.dtype == np.uint16 and bits.shape == (3, 5)
        assert np.array_equal(bits, t["h"].view(torch.int16).numpy().view(
            np.uint16))

    def test_restore_takes_like_dtype_and_device(self, tmp_path):
        d = str(tmp_path)
        t = _tree(4)
        save(d, 1, t)
        like = _zeros(t)
        like["w"] = torch.zeros((4, 8), dtype=torch.float64)
        back = restore(d, 1, like, device="cpu")
        assert back["w"].dtype == torch.float64
        assert torch.equal(back["w"], t["w"].double())
        assert back["h"].device.type == "cpu"

    def test_keep_last_gc(self, tmp_path):
        d = str(tmp_path)
        for s in (1, 2, 3, 4, 5):
            save(d, s, _tree(s), keep_last=2)
        steps = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                       if x.startswith("step_"))
        assert steps == [4, 5]
        assert latest_step(d) == 5

    def test_latest_ignores_partial(self, tmp_path):
        d = str(tmp_path)
        save(d, 3, _tree(0))
        # a torn write: a directory without a manifest is not "latest"
        os.makedirs(os.path.join(d, "step_0000000009"))
        assert latest_step(d) == 3

    def test_structure_mismatch_raises(self, tmp_path):
        d = str(tmp_path)
        save(d, 1, _tree(0))
        with pytest.raises(ValueError, match="leaves"):
            restore(d, 1, {"only": torch.zeros((2,))})

    def test_crashed_overwrite_recovers_old_version(self, tmp_path):
        """A crash between the two renames of an overwrite: the ``.old-``
        aside is the only complete copy and is found again."""
        d = str(tmp_path)
        save(d, 5, _tree(1))
        os.rename(os.path.join(d, "step_0000000005"),
                  os.path.join(d, ".old-step_0000000005"))
        assert latest_step(d) == 5           # recovery renames it back
        back = restore(d, 5, _tree(0))
        assert float(back["scalar"]) == 1.0

    def test_resave_same_step_replaces_cleanly(self, tmp_path):
        """Re-publishing a step leaves the new version and no ``.old-`` /
        ``.tmp-`` staging debris."""
        d = str(tmp_path)
        save(d, 5, _tree(1))
        save(d, 5, _tree(2))
        back = restore(d, 5, _tree(0))
        _equal(back, _tree(2))
        assert os.listdir(d) == ["step_0000000005"]


class TestAsyncWriter:
    def test_async_submit_wait(self, tmp_path):
        d = str(tmp_path)
        ck = AsyncCheckpointer(d, keep_last=3)
        for s in (10, 20):
            ck.submit(s, _tree(s))
        ck.wait()
        ck.close()
        assert not ck._thread.is_alive()
        assert latest_step(d) == 20
        _equal(restore(d, 10, _tree(0)), _tree(10))

    def test_submit_snapshot_is_immediate(self, tmp_path):
        """``submit`` copies the tree before it returns: an in-place update
        of the live tensors right after (as ``adamw_step`` makes) cannot
        reach the checkpoint, CPU tensors included."""
        d = str(tmp_path)
        ck = AsyncCheckpointer(d)
        t = {"x": torch.ones((3,)), "y": torch.ones((2,)).bfloat16()}
        ck.submit(1, t)
        t["x"].mul_(0)
        t["y"].add_(5)
        ck.wait()
        ck.close()
        back = restore(d, 1, _zeros(t))
        assert torch.equal(back["x"], torch.ones(3))
        assert torch.equal(back["y"], torch.ones(2).bfloat16())

    def test_writer_error_surfaces_on_wait(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        ck = AsyncCheckpointer(str(blocker))
        ck.submit(1, {"x": torch.ones(2)})
        with pytest.raises(OSError):
            ck.wait()
        with pytest.raises(OSError):
            ck.submit(2, {"x": torch.ones(2)})
        ck._q.put(None)
        ck._thread.join(timeout=10)
        assert not ck._thread.is_alive()
