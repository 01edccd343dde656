"""Device meshes over `torch.distributed` (port of `repro/launch/mesh.py`).

Functions only: importing this module touches no process group and no
device. A mesh is a `DeviceMesh` over the ranks of the default process
group, one rank a device, its axes named as the reference's
(`"pod"`, `"data"`, `"model"`). Sizes are read by axis name
(`mesh_shape`), and a rank's group along an axis is
`mesh.get_group(name)`.

The backend follows the device: NCCL for CUDA, gloo (or torch's fake
process group, which dry tools use) for the CPU. `init_world` starts the
default group that way; a mesh on CUDA over a group that is not NCCL, or
a mesh whose size is not the world's, raises: no rank computes another
rank's share.
"""
from __future__ import annotations

import datetime
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(device=None, *, rank: int = 0, world_size: int = 1,
               init_method: Optional[str] = None, store=None,
               timeout: float = 600.0) -> torch.device:
    """Starts the default process group of `world_size` ranks on the
    backend `device` asks for (None: CUDA; each rank takes the card of
    its rank modulo the cards it sees). Rendezvous through `init_method`
    (`tcp://host:port`, `file://path`) or a `store`. Returns this rank's
    device."""
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout),
                            **kw)
    return dev


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.mesh.init_world "
                           "(or torch.distributed.init_process_group) first")
    backend = dist.get_backend()
    if (device_type == "cuda") != (backend == "nccl"):
        raise RuntimeError(f"a {device_type} mesh needs the "
                           f"{backend_for(device_type)} backend; the "
                           f"process group runs {backend}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: 16 x 16 (`data`, `model`), or
    2 x 16 x 16 (`pod`, `data`, `model`) multi-pod; the world must be 256
    or 512 ranks."""
    shape, names = PRODUCTION[multi_pod]
    return _mesh(resolve_device(device).type, shape, names)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A (`data`, `model`) mesh over the whole world, which must have
    data x model ranks."""
    return _mesh(resolve_device(device).type, (data, model),
                 ("data", "model"))


def mesh_shape(mesh) -> dict:
    """{axis name: size}, as a JAX mesh's `shape`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh, batch: int):
    """Mesh axes usable for batch sharding (largest prefix of (pod, data)
    whose product divides `batch`)."""
    shape = mesh_shape(mesh)
    axes = [a for a in ("pod", "data") if a in shape]
    out, prod = [], 1
    for a in axes:
        if batch % (prod * shape[a]) == 0:
            out.append(a)
            prod *= shape[a]
    return tuple(out)


def batch_shard(mesh, batch_axes_) -> tuple:
    """(this rank's index, the number of shards) of a batch split over
    `batch_axes_`, the first axis major, as a JAX sharding over them."""
    shape, index, n = mesh_shape(mesh), 0, 1
    for a in batch_axes_:
        index = index * shape[a] + mesh.get_local_rank(a)
        n *= shape[a]
    return index, n


def all_reduce_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sums `t` in place over the ranks of the mesh axes `axes` (one
    all_reduce an axis; a one-rank axis still runs its collective)."""
    for a in axes:
        dist.all_reduce(t, group=mesh.get_group(a))
    return t
