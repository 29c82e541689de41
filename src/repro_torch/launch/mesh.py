"""Device meshes for the sharded steps.

Functions, not module-level constants, so importing this module never
touches the process group: a mesh is built over the default process group
that the caller has initialised (``torch.distributed.init_process_group``
with its store, rank and world size), whose size must be the mesh's.  The
production meshes' 256 or 512 ranks are for a fake process group, as a dry
run lowers every cell without the chips.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str) -> DeviceMesh:
    size = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh {names} needs a process group of {size} ranks; call "
            "torch.distributed.init_process_group (store, rank, world_size) first")
    if dist.get_world_size() != size:
        raise RuntimeError(f"a {shape} mesh {names} needs {size} ranks, the process group "
                           f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16×16 = 256 ranks per pod; multi_pod adds the 2-pod 'pod' axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, multi_pod: bool = False,
                    device_type: str = "cuda") -> DeviceMesh:
    """Small mesh for multi-rank tests and one-card runs (a 1×1 mesh)."""
    if multi_pod:
        return _mesh((2, n_data, n_model), ("pod", "data", "model"), device_type)
    return _mesh((n_data, n_model), ("data", "model"), device_type)
