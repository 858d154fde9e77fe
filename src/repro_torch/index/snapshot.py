"""Snapshot persistence for the streaming index (counterpart of
:mod:`repro.index.snapshot`, in the same on-disk format: either package
restores what the other wrote).

Reuses the checkpoint layer's atomic-directory protocol
(:func:`repro_torch.checkpoint.ckpt.begin_atomic_dir` / ``write_manifest`` /
``commit_atomic_dir``): arrays land as ``.npy`` leaves in a staging dir,
the JSON manifest is fsync'd as the commit record, and a rename publishes
the snapshot — a crash mid-write never corrupts the latest restorable
state.  The manifest carries the full :class:`IndexConfig` (including the
nested :class:`PQConfig`) plus per-segment static metadata, so restore
needs no out-of-band configuration; arrays are ``.npy`` files, so a
snapshot restores onto any device.

Format 2 additionally records the elastic measure (name + params) as a
dedicated manifest entry and *validates* it on restore: an unregistered
measure name or a record that disagrees with the embedded config is a
hard error — codes in the snapshot were produced under that measure, so
silently reinterpreting them under another would corrupt every distance.

Format 3 persists the scale-out state: each segment's list-to-device
``placement`` array plus its ``n_shards`` / ``shard_cap`` static metadata
(the shard-major layout restores bit-exactly — no re-placement on
restore), and the two-level coarse quantizer tables when the index has
one.  Formats 1–2 remain restorable: their segments load as the
single-shard layout (``placement`` all zeros, ``shard_cap`` = rows).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint.ckpt import (MANIFEST, begin_atomic_dir, commit_atomic_dir,
                               gc_numbered_dirs, latest_numbered_dir,
                               write_manifest)
from .. import _device
from ..core.ivf import TwoLevelCoarse
from ..core.pq import PQCodebook, PQConfig
from ..kernels.pq_adc.ops import check_codes
from .segments import SealedSegment
from .streaming import IndexConfig, StreamingIndex

__all__ = ["save_snapshot", "restore_snapshot", "latest_snapshot"]

_PREFIX = "snap_"
_FORMAT = 3
_SUPPORTED_FORMATS = (1, 2, 3)   # 1 = pre-measure-registry snapshots (DTW),
                                 # 2 = pre-scale-out (single-shard layout)


def _name(step: int) -> str:
    return f"{_PREFIX}{step:010d}"


def latest_snapshot(directory: str) -> Optional[int]:
    """Newest committed (manifest-bearing) snapshot step, or None."""
    return latest_numbered_dir(directory, _PREFIX)


def save_snapshot(directory: str, index: StreamingIndex,
                  step: Optional[int] = None, keep_last: int = 3) -> str:
    """Atomically persist ``index`` under ``directory/snap_<step>``.

    ``step`` defaults to one past the latest existing snapshot.  The hot
    buffer is persisted raw (inserts survive a restart without a forced
    flush).  Returns the committed path.
    """
    if step is None:
        last = latest_snapshot(directory)
        step = 0 if last is None else last + 1
    tmp = begin_atomic_dir(directory, _name(step))

    arrays: Dict[str, np.ndarray] = {
        "coarse": index.coarse,
        "cb_centroids": index.cb.centroids,
        "cb_lut": index.cb.lut,
        "cb_env_upper": index.cb.env_upper,
        "cb_env_lower": index.cb.env_lower,
        "hot_data": index.hot.data,
        "hot_ids": index.hot.ids,
        "hot_live": index.hot.live,
    }
    if index.two_level is not None:
        arrays["tl_top"] = index.two_level.top
        arrays["tl_child_idx"] = index.two_level.child_idx
        arrays["tl_child_valid"] = index.two_level.child_valid
    seg_meta = []
    for s, sg in enumerate(index.segments):
        for field in ("codes", "ids", "live", "assign", "list_start",
                      "list_len", "placement"):
            arrays[f"seg{s:04d}_{field}"] = getattr(sg, field)
        seg_meta.append({"max_list": sg.max_list, "n_shards": sg.n_shards,
                         "shard_cap": sg.shard_cap})
    for name, arr in arrays.items():
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        np.save(os.path.join(tmp, f"{name}.npy"), np.asarray(arr))

    cfg = dataclasses.asdict(index.cfg)
    cfg["pq"] = dataclasses.asdict(index.cfg.pq)
    spec = index.cfg.pq.measure()
    write_manifest(tmp, {
        "format": _FORMAT,
        "step": step,
        "config": cfg,
        "measure": None if spec is None else spec.to_manifest(),
        "dim": index.dim,
        "two_level": index.two_level is not None,
        "next_id": index.next_id,
        "hot_count": index.hot.count,
        "segments": seg_meta,
        "arrays": sorted(arrays),
    })
    final = commit_atomic_dir(tmp, directory, _name(step))
    gc_numbered_dirs(directory, keep_last, _PREFIX)
    return final


def _validate_measure(manifest: dict, cfg: IndexConfig) -> None:
    """Hard-fail on a measure mismatch between the dedicated manifest
    record and the embedded config (and on unregistered measure names) —
    the snapshot's codes/LUTs are only meaningful under the measure that
    produced them.  Format-1 snapshots predate the record and carry their
    measure solely in the config (validated by PQConfig itself)."""
    if manifest["format"] < 2:
        return
    recorded = manifest.get("measure")
    spec = cfg.pq.measure()   # raises for unregistered names
    expected = None if spec is None else spec.to_manifest()
    if recorded != expected:
        raise ValueError(
            f"snapshot measure record {recorded!r} does not match the "
            f"snapshot config's measure {expected!r} — refusing to restore "
            "(codes/LUTs are bound to the measure that built them)")


def restore_snapshot(directory: str, step: Optional[int] = None, *,
                     device: _device.DeviceArg = None) -> StreamingIndex:
    """Rebuild a :class:`StreamingIndex` on ``device`` from ``directory``
    (latest snapshot unless ``step`` is given); tombstones, hot rows and id
    allocation state all round-trip."""
    dev = _device.resolve_device(device)
    if step is None:
        step = latest_snapshot(directory)
        if step is None:
            raise FileNotFoundError(f"no snapshots under {directory!r}")
    d = os.path.join(directory, _name(step))
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format"] not in _SUPPORTED_FORMATS:
        raise ValueError(
            f"snapshot format {manifest['format']} not in supported "
            f"{_SUPPORTED_FORMATS}")

    def load(name: str) -> np.ndarray:
        return np.load(os.path.join(d, f"{name}.npy"))

    cfg_d = dict(manifest["config"])
    cfg_d["pq"] = dict(cfg_d["pq"])
    cfg_d["pq"]["measure_params"] = [
        tuple(p) for p in cfg_d["pq"].get("measure_params", [])]
    cfg = IndexConfig(**{**cfg_d, "pq": PQConfig(**cfg_d["pq"])})
    _validate_measure(manifest, cfg)
    cb = PQCodebook(load("cb_centroids"), load("cb_lut"),
                    load("cb_env_upper"), load("cb_env_lower"))
    two_level = None
    if manifest.get("two_level"):
        two_level = TwoLevelCoarse(top=load("tl_top"),
                                   child_idx=load("tl_child_idx"),
                                   child_valid=load("tl_child_valid"))
    index = StreamingIndex.from_parts(cfg, load("coarse"), cb,
                                      manifest["dim"], two_level=two_level,
                                      device=dev)

    def put(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    index.next_id = manifest["next_id"]
    index.hot.data[:] = load("hot_data")
    index.hot.ids[:] = load("hot_ids")
    index.hot.live[:] = load("hot_live")
    index.hot.count = manifest["hot_count"]
    index._resident.update(
        index.hot.ids[index.hot.ids >= 0].tolist())
    for s, meta in enumerate(manifest["segments"]):
        host_ids = load(f"seg{s:04d}_ids")
        host_live = load(f"seg{s:04d}_live")
        codes = load(f"seg{s:04d}_codes")
        check_codes(cfg.pq.codebook_size, **{f"seg{s:04d}_codes": codes})
        list_start = load(f"seg{s:04d}_list_start")
        if manifest["format"] >= 3:
            placement = load(f"seg{s:04d}_placement")
            n_shards = int(meta["n_shards"])
            shard_cap = int(meta["shard_cap"])
        else:
            # pre-scale-out snapshots are the single-shard layout: every
            # list on shard 0, the whole segment one shard block
            placement = np.zeros(list_start.shape[0], np.int32)
            n_shards = 1
            shard_cap = codes.shape[0]
        index._add_segment(SealedSegment(
            codes=put(codes), ids=put(host_ids), live=put(host_live),
            assign=put(load(f"seg{s:04d}_assign")),
            list_start=put(list_start),
            list_len=put(load(f"seg{s:04d}_list_len")),
            placement=put(placement),
            max_list=int(meta["max_list"]), n_shards=n_shards,
            shard_cap=shard_cap), host_ids=host_ids,
            host_live=host_live)
    return index
