"""Mesh construction over ``torch.distributed`` (the reference's
``launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group.  Single pod: (data=16, model=16) = 256 ranks; multi-pod adds
a leading pod axis: (pod=2, data=16, model=16) = 512 ranks.
:func:`production_mesh_shape` describes those meshes without building them
(an ``AbstractMesh``, enough for specs); :func:`make_production_mesh` and
:func:`make_mesh_for` build a ``DeviceMesh`` with named axes over an
initialised process group — gloo on the CPU, or gloo ranks sharing one
card, whose collectives go through the host (``distributed/sharding.py``);
its device type is ``cuda`` under NCCL and ``cpu`` otherwise.
"""
from __future__ import annotations

import numpy as np

from repro_torch.distributed.sharding import AbstractMesh

__all__ = ["production_mesh_shape", "make_production_mesh", "make_mesh_for"]


def production_mesh_shape(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axis names and sizes, not built."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def _device_mesh(sizes: tuple[int, ...], names: tuple[str, ...]):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ndev = int(np.prod(sizes))
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 0)
    if world < ndev:
        raise RuntimeError(
            f"need {ndev} ranks for mesh {sizes}, have {world} — initialise "
            "a process group of that many ranks first "
            "(torch.distributed.init_process_group)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(ndev).reshape(sizes),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh as a ``DeviceMesh`` over the first 256 (or
    512) ranks of the process group; raises with too few ranks."""
    shape = production_mesh_shape(multi_pod=multi_pod)
    return _device_mesh(shape.axis_sizes, shape.axis_names)


def make_mesh_for(n_devices: int, *, model_parallel: int = 1):
    """Small-scale mesh for tests and examples: (data, model) over the
    first ``n_devices`` ranks."""
    if n_devices % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"{n_devices} ranks")
    return _device_mesh((n_devices // model_parallel, model_parallel),
                        ("data", "model"))
