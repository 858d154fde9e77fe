"""Fault-tolerant checkpointing (counterpart of :mod:`repro.checkpoint.ckpt`).

* atomic step directories (write to ``.tmp-<name>``, fsync, rename): a
  crash mid-write never corrupts the latest checkpoint;
* ``keep_last`` garbage collection;
* an async writer thread (:class:`AsyncCheckpointer`): the train step
  never waits on storage;
* leaves stored whole, one ``.npy`` file each, named by their field path,
  with a JSON manifest; a ``DTensor`` leaf is gathered whole and written
  by rank 0, one leaf at a time, and ``restore`` lays leaves out for any
  mesh.

Trees are the port's: nested NamedTuples, tuples and dicts of tensors
(:mod:`repro_torch._tree`; ``None`` fields are no leaves).  numpy has no
bfloat16 without ``ml_dtypes``, so a bf16 leaf is stored as its 16 bits
(``uint16``) with ``"bfloat16"`` in the manifest.  The port's checkpoints
are its own: the reference stacks its layers, the port does not.

The atomic-directory helpers are shared with the streaming index's
snapshots (:mod:`repro_torch.index.snapshot`).

>>> import tempfile, torch
>>> d = tempfile.mkdtemp()
>>> tree = {"w": torch.arange(6.0).reshape(2, 3).bfloat16(),
...         "step": torch.tensor(7, dtype=torch.int32)}
>>> _ = save(d, 7, tree)
>>> latest_step(d)
7
>>> back = restore(d, 7, {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
...                       "step": torch.tensor(0, dtype=torch.int32)})
>>> torch.equal(back["w"], tree["w"]), int(back["step"])
(True, 7)
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .._device import DeviceArg, resolve_device
from .._tree import leaves, leaves_with_paths, path_name, tree_map, unflatten
from ..sharding.partition import distribute, is_dtensor

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer",
           "begin_atomic_dir", "write_manifest", "commit_atomic_dir",
           "latest_numbered_dir", "gc_numbered_dirs", "MANIFEST"]

MANIFEST = "manifest.json"


# ---------------------------------------------------------------------------
# Atomic-directory protocol (shared with repro_torch.index.snapshot)
#
# Writers populate a ``.tmp-<name>`` staging directory, fsync a manifest as
# the commit record, then rename over the final path (an existing version
# is moved to a ``.old-<name>`` aside first, never deleted in place): a
# crash at any point leaves a complete version on disk — as the final dir,
# or as an aside that discovery (:func:`latest_numbered_dir`) renames back —
# plus at worst stale staging dirs that the next writer clears.  Never a
# torn read.
# ---------------------------------------------------------------------------

def begin_atomic_dir(directory: str, name: str) -> str:
    """Create (clearing any stale leftover) the staging dir for ``name``."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{name}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return tmp


def write_manifest(tmp: str, manifest: dict) -> None:
    """fsync'd manifest write — the durability point of the protocol."""
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def commit_atomic_dir(tmp: str, directory: str, name: str) -> str:
    """Atomically publish the staged dir as ``directory/name``.

    Durability order: every staged file is fsync'd *before* the rename (a
    published manifest must never point at torn data blocks), and the
    parent directory is fsync'd *after* it (the rename itself survives the
    crash).
    """
    for fn in os.listdir(tmp):
        fd = os.open(os.path.join(tmp, fn), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    tfd = os.open(tmp, os.O_RDONLY)      # the staged dirents themselves
    try:
        os.fsync(tfd)
    finally:
        os.close(tfd)
    final = os.path.join(directory, name)
    # Re-publishing an existing name: move the old version aside rather
    # than deleting it first, so no crash window destroys the only copy
    # (the ".old-" prefix keeps it invisible to latest_numbered_dir).
    old = os.path.join(directory, f".old-{name}")
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)
    shutil.rmtree(old, ignore_errors=True)
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return final


def _recover_old_dirs(directory: str, prefix: str) -> None:
    """Crash recovery for the re-publish window of :func:`commit_atomic_dir`:
    a ``.old-<name>`` aside whose ``<name>`` is gone means the process died
    between the two renames — the aside IS the newest complete version, so
    rename it back into discoverability."""
    for d in os.listdir(directory):
        if not d.startswith(f".old-{prefix}"):
            continue
        final = os.path.join(directory, d[len(".old-"):])
        if os.path.exists(final):
            continue                 # superseded; next commit cleans it up
        try:
            os.rename(os.path.join(directory, d), final)
        except OSError:
            pass                     # read-only fs / concurrent writer


def latest_numbered_dir(directory: str, prefix: str) -> Optional[int]:
    """Newest committed (manifest-bearing) ``<prefix><n>`` dir, or None."""
    if not os.path.isdir(directory):
        return None
    _recover_old_dirs(directory, prefix)
    steps = [int(d[len(prefix):]) for d in os.listdir(directory)
             if d.startswith(prefix)
             and os.path.exists(os.path.join(directory, d, MANIFEST))]
    return max(steps) if steps else None


def gc_numbered_dirs(directory: str, keep_last: int, prefix: str) -> None:
    """Drop all but the newest ``keep_last`` ``<prefix><n>`` dirs."""
    dirs = sorted(d for d in os.listdir(directory) if d.startswith(prefix))
    for d in dirs[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------

def _to_numpy(t: torch.Tensor):
    """A host tensor -> (numpy array, manifest dtype); bf16 as its bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the host, detached (a copy even for a CPU
    tensor, so that a later in-place update cannot reach it)."""
    return t.detach().to("cpu", copy=True)


def _writer() -> bool:
    """Whether this process writes: the only one, or rank 0 of its
    process group."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def save(directory: str, step: int, tree: Any, keep_last: int = 3) -> str:
    """Atomically persist ``tree`` under ``directory/step_<step>``.  Each
    ``DTensor`` leaf is stored whole: every rank gathers it (a
    collective, leaf by leaf in the tree's order), rank 0 alone writes it
    and every rank drops it before the next, so a rank holds one whole
    leaf at a time (the others return the path rank 0 writes to)."""
    name = f"step_{step:010d}"
    tmp = begin_atomic_dir(directory, name) if _writer() else None
    manifest = {"step": step, "leaves": []}
    for path, leaf in leaves_with_paths(tree):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        if tmp is None:
            continue
        leaf_name = path_name(path)
        arr, dtype = _to_numpy(leaf.detach().cpu())
        fn = f"{len(manifest['leaves']):05d}_{leaf_name[:80]}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"file": fn, "name": leaf_name,
                                   "shape": list(arr.shape), "dtype": dtype})
        del arr, leaf
    if tmp is None:
        return os.path.join(directory, name)
    write_manifest(tmp, manifest)
    final = commit_atomic_dir(tmp, directory, name)
    gc_numbered_dirs(directory, keep_last, "step_")
    return final


def latest_step(directory: str) -> Optional[int]:
    return latest_numbered_dir(directory, "step_")


def restore(directory: str, step: int, like: Any,
            device: DeviceArg = None, mesh=None, specs: Any = None) -> Any:
    """Load step ``step`` into the structure of ``like``: each leaf in its
    ``like`` leaf's dtype, on that leaf's device (or on ``device``, when
    given).  ``ValueError`` when the leaf counts differ.  With a
    ``DeviceMesh`` ``mesh`` and ``specs`` (the partition rules' specs of
    ``like``) each leaf is laid out for the mesh of the run that
    restores, whatever mesh saved it (the reference's ``shardings``)."""
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    flat = leaves_with_paths(like)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"the tree expects {len(flat)}")
    dev = None if device is None else resolve_device(device)
    out = []
    for meta, (_, ref) in zip(manifest["leaves"], flat):
        t = _from_numpy(np.load(os.path.join(d, meta["file"])),
                        meta["dtype"])
        out.append(t.to(device=ref.device if dev is None else dev,
                        dtype=ref.dtype))
    out = unflatten(like, out)
    if mesh is not None:
        out = distribute(out, specs, mesh)
    return out


class AsyncCheckpointer:
    """Background writer: ``submit`` copies the tree to the host and
    returns; ``wait`` blocks until every submitted tree is on disk."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                save(self.directory, step, tree, self.keep_last)
            except Exception as e:        # surfaced on the next submit/wait
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree: Any) -> None:
        """Queue ``tree`` for writing.  A tree with ``DTensor`` leaves is
        written now, in the caller, as :func:`save` writes it (one whole
        leaf on the host at a time; a host copy of the whole tree on
        every rank would not fit a production mesh's host memory)."""
        if self._err:
            raise self._err
        if any(is_dtensor(t) for t in leaves(tree)):
            self.wait()
            save(self.directory, step, tree, self.keep_last)
            return
        # the host copy is taken now: the train step updates the live
        # tensors in place
        self._q.put((step, tree_map(_host, tree)))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=10)
