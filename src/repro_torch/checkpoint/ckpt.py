"""The atomic-directory protocol of the checkpoint layer (the helpers of
:mod:`repro.checkpoint.ckpt`, which need no JAX), used by the streaming
index's snapshots.  The pytree ``save``/``restore``/``AsyncCheckpointer``
of the reference come with training.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

__all__ = ["begin_atomic_dir", "write_manifest", "commit_atomic_dir",
           "latest_numbered_dir", "gc_numbered_dirs", "MANIFEST"]

MANIFEST = "manifest.json"


# ---------------------------------------------------------------------------
# Atomic-directory protocol (used by repro_torch.index.snapshot)
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
