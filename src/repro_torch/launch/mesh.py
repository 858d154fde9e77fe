"""Meshes of the port (counterpart of :mod:`repro.launch.mesh`).

A mesh has two forms.  :class:`MeshDesc` is the abstract one: its shape
and axis names, all that the partition rules
(:mod:`repro_torch.sharding.partition`) read.  :func:`device_mesh` builds
the real ``torch.distributed`` ``DeviceMesh`` of a description from the
process group the program was started in (``torchrun``'s ``env://``, or a
group the caller initialised).  No mesh is a module-level constant, and
importing this module touches no device and no process group.

>>> make_production_mesh().shape
{'data': 16, 'model': 16}
>>> make_production_mesh(multi_pod=True).size
512
>>> validate_search_mesh(make_search_mesh(2), 4)  # doctest: +ELLIPSIS
Traceback (most recent call last):
...
ValueError: index layout is sealed for n_shards=4 but the mesh has 2 ...
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

__all__ = ["MeshDesc", "make_production_mesh", "make_host_mesh",
           "make_search_mesh", "validate_search_mesh", "device_mesh",
           "launch_mesh", "mesh_sizes"]


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    """A mesh's shape and axis names (the abstract form)."""
    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.dims} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a :class:`MeshDesc` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshDesc):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshDesc:
    """16 x 16 = 256 devices a pod over ``("data", "model")``; multi-pod
    adds a leading ``pod`` axis (2 x 16 x 16 = 512)."""
    if multi_pod:
        return MeshDesc((2, 16, 16), ("pod", "data", "model"))
    return MeshDesc((16, 16), ("data", "model"))


def make_host_mesh() -> MeshDesc:
    """The degenerate 1 x 1 mesh (the same axis names): one device."""
    return MeshDesc((1, 1), ("data", "model"))


def make_search_mesh(n_devices: Optional[int] = None) -> MeshDesc:
    """The 1-D ``("search",)`` mesh of the index planner
    (:func:`repro_torch.index.planner.search_sharded`); ``n_devices``
    defaults to the visible cards (1 without one)."""
    if n_devices is None:
        import torch
        n_devices = max(1, torch.cuda.device_count())
    return MeshDesc((int(n_devices),), ("search",))


def validate_search_mesh(mesh, n_shards: int) -> None:
    """Reject a mesh whose ``search`` axis disagrees with a data-partition
    count ``n_shards``: a clear error at plan time, the reference's."""
    sizes = mesh_sizes(mesh)
    if "search" not in sizes:
        raise ValueError(
            f"expected a 1-D ('search',) mesh, got axes {tuple(sizes)}")
    n_dev = sizes["search"]
    if n_shards != n_dev:
        raise ValueError(
            f"index layout is sealed for n_shards={n_shards} but the mesh "
            f"has {n_dev} devices on its 'search' axis — reseal the index "
            f"(IndexConfig(n_shards={n_dev}) + compact()) or build the "
            f"mesh with make_search_mesh({n_shards})")


def device_mesh(desc: MeshDesc, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``desc`` over the initialised default process
    group, whose size must be the mesh's.  ``ValueError`` naming the
    world size needed otherwise (or when no group is initialised)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != desc.size:
        raise ValueError(
            f"the {'x'.join(map(str, desc.dims))} mesh over "
            f"{desc.axis_names} needs a process group of {desc.size} ranks"
            f" (world size {desc.size}); "
            + ("no process group is initialised" if have is None
               else f"this one has {have}"))
    return init_device_mesh(device_type, desc.dims,
                            mesh_dim_names=desc.axis_names)


def launch_mesh(desc: MeshDesc, device):
    """The ``DeviceMesh`` a launcher runs on: ``None`` for a mesh of one
    device (the partition is the identity there; no process group), else
    built over the process group ``torchrun`` describes (``env://``: one
    rank a device, ``nccl`` on the card, ``gloo`` on the CPU).  The world
    size is read before any group is made, and a run of another size
    raises ``ValueError`` naming the ranks the mesh needs."""
    if desc.size == 1:
        return None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != desc.size:
        raise ValueError(
            f"the {'x'.join(map(str, desc.dims))} mesh needs {desc.size} "
            f"ranks, one a device (torchrun --nproc-per-node ... with "
            f"WORLD_SIZE={desc.size}); this run has {world}")
    import torch
    import torch.distributed as dist
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    return device_mesh(desc, device.type)
