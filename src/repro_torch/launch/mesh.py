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
rank's share. The dry tools (`launch/dryrun.py`) ask for a `meta` mesh:
torch's fake process group, whose collectives move nothing, over
tensors that hold shapes only.

Every collective of the sharded step goes through the helpers at the
end (`all_reduce_over`, `all_gather_over`, `reduce_scatter_over`,
`all_to_all_over`, and their autograd forms `gather`, `scatter`,
`reduce`, `enter`). Each records (op, dtype, local result shape, group
size) in the ledger `record_collectives` opens: the port's counterpart
of the collectives in the reference's compiled HLO, which the dry run
counts.
"""
from __future__ import annotations

import contextlib
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
    if device_type == "meta":
        if backend != "fake":
            raise RuntimeError(f"a meta mesh needs torch's fake process "
                               f"group; the process group runs {backend}")
        device_type = "cpu"     # the fake group's mesh; tensors stay meta
    if (device_type == "cuda") != (backend == "nccl"):
        raise RuntimeError(f"a {device_type} mesh needs the "
                           f"{backend_for(device_type)} backend; the "
                           f"process group runs {backend}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _device_type(device) -> str:
    """`meta` (the dry tools' fake world) or the entry points' device."""
    if device is not None and torch.device(device).type == "meta":
        return "meta"
    return resolve_device(device).type


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: 16 x 16 (`data`, `model`), or
    2 x 16 x 16 (`pod`, `data`, `model`) multi-pod; the world must be 256
    or 512 ranks."""
    shape, names = PRODUCTION[multi_pod]
    return _mesh(_device_type(device), shape, names)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A (`data`, `model`) mesh over the whole world, which must have
    data x model ranks."""
    return _mesh(_device_type(device), (data, model), ("data", "model"))


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


# ---------------------------------------------------------------------------
# collectives, each recorded in the ledger
# ---------------------------------------------------------------------------

_LEDGER: Optional[list] = None

# newer torch names the tensor forms *_single; older has only the first
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


@contextlib.contextmanager
def record_collectives():
    """Collects every collective the helpers run inside the block, as
    (op, dtype, local result shape, group size) tuples; op is the HLO's
    name (`all-reduce`, `all-gather`, `reduce-scatter`, `all-to-all`)."""
    global _LEDGER
    prev, _LEDGER = _LEDGER, []
    try:
        yield _LEDGER
    finally:
        _LEDGER = prev


def record(op: str, t: torch.Tensor, group) -> None:
    """Adds one collective to the open ledger (if any)."""
    if _LEDGER is not None:
        _LEDGER.append((op, t.dtype, tuple(t.shape),
                        dist.get_world_size(group)))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def all_reduce_over(t: torch.Tensor, mesh, axes, op: str = "sum"
                    ) -> torch.Tensor:
    """Sums (or takes the max of, `op="max"`) `t` in place over the ranks
    of the mesh axes `axes` (one all_reduce an axis; a one-rank axis
    still runs its collective)."""
    for a in axes:
        all_reduce_in(t, mesh.get_group(a), op)
    return t


def all_reduce_in(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sums (or takes the max of) `t` in place over a process group."""
    record("all-reduce", t, group)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def all_gather_over(t: torch.Tensor, mesh, axis: str, dim: int
                    ) -> torch.Tensor:
    """The ranks' `t` of `axis`, concatenated along `dim` in rank order."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x, group=group)
    out = out.movedim(0, dim)
    record("all-gather", out, group)
    return out


def reduce_scatter_over(t: torch.Tensor, mesh, axis: str, dim: int
                        ) -> torch.Tensor:
    """The sum over `axis` of the ranks' `t`, of which this rank keeps its
    1/n along `dim` (rank order)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not split over {n} ranks of {axis}")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    _REDUCE_SCATTER(out, x, group=group)
    out = out.movedim(0, dim)
    record("reduce-scatter", out, group)
    return out


def all_to_all_over(t: torch.Tensor, mesh, axis: str, split_dim: int,
                    cat_dim: int) -> torch.Tensor:
    """Rank j of `axis` gets this rank's j-th 1/n of `t` along
    `split_dim`; the n parts a rank gets are concatenated along `cat_dim`
    in rank order (a sequence-split layout from a head-split one)."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    x = t.movedim(split_dim, 0)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} "
                         f"does not split over {n} ranks of {axis}")
    x = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    parts = [p.movedim(0, split_dim) for p in out.unbind(0)]
    out = torch.cat(parts, dim=cat_dim)
    record("all-to-all", out, group)
    return out


class _Gather(torch.autograd.Function):
    """All-gather along `dim` forward; reduce-scatter backward."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return all_gather_over(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_over(g, *ctx.args), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along `dim` forward; all-gather backward."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return reduce_scatter_over(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_over(g, *ctx.args), None, None, None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward: the transpose of a
    psum whose result every rank of the axis uses alike."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce_over(t.contiguous().clone(), mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """Identity forward; all-reduce backward: a tensor replicated over
    the axis entering a region where each rank does its own part."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.args = (mesh, axis)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return all_reduce_over(g.contiguous().clone(), mesh,
                               (axis,)), None, None


def gather(t, mesh, axis: str, dim: int):
    """Autograd all-gather over `axis` along `dim` (identity on one
    rank)."""
    if axis_size(mesh, axis) == 1:
        return t
    return _Gather.apply(t, mesh, axis, dim)


def scatter(t, mesh, axis: str, dim: int):
    """Autograd reduce-scatter over `axis` along `dim`."""
    if axis_size(mesh, axis) == 1:
        return t
    return _Scatter.apply(t, mesh, axis, dim)


def reduce(t, mesh, axis: str):
    """Autograd all-reduce over `axis` (identity backward)."""
    if axis_size(mesh, axis) == 1:
        return t
    return _Reduce.apply(t, mesh, axis)


def enter(t, mesh, axis: str):
    """Identity whose backward all-reduces over `axis`."""
    if axis_size(mesh, axis) == 1:
        return t
    return _Enter.apply(t, mesh, axis)
