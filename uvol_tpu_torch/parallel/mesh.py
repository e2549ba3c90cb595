"""Device meshes and the frame-parallel helpers — counterpart of
`uvol_tpu/parallel/mesh.py` on `torch.distributed`.

The reference runs its multi-device paths as `shard_map` over a
`jax.sharding.Mesh`: each device owns a contiguous slice of the frame
(or block) axis, and the few cross-frame reductions are `psum`s and
`all_gather`s. Here each device is one process (a rank), the mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the same dim names
(`("frames",)` or `("streams", "frames")`), and the collectives are
`torch.distributed`'s over the mesh dim's process group.

Two rules the reference's collectives do not need:

  - Float sums across ranks go through `all_sum_in_rank_order`: the
    partials are gathered and added from 0.0 in rank order, the same way
    on every rank and every run. An `all_reduce(SUM)` leaves the order to
    the backend.
  - How a gather travels is chosen once, when the mesh is made, from its
    group's backend (`choose_transport`): NCCL gathers CUDA tensors and
    gloo CPU ones where they lie; gloo's CUDA support covers `broadcast`
    and `all_reduce` only, so for ranks sharing a card over gloo a gather
    goes through host copies.

Entry points run on the card unless the caller names the CPU: a mesh's
`device_type` defaults to "cuda" and raises without one, as
`_device.resolve_device` does. Each rank's card is
`cuda:(LOCAL_RANK % device_count)`.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from uvol_tpu_torch._device import resolve_device

Tensor = torch.Tensor

FRAME_AXIS = "frames"
BLOCK_AXIS = "blocks"

#: how long a collective may wait for the other ranks before it raises
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


def choose_backend(device_type: str, local_world_size: int, device_count: int) -> str:
    """The process-group backend: NCCL when every rank of this host has a
    card of its own, gloo when ranks share a card (NCCL refuses two ranks
    on one GPU) or run on the CPU."""
    if device_type == "cuda" and 0 < local_world_size <= device_count:
        return "nccl"
    return "gloo"


def choose_transport(backend: str, device_type: str) -> str:
    """How a gather travels on a mesh dim whose group has `backend`:
    "device" (the backend gathers the tensors where they lie: NCCL on
    CUDA, gloo on the CPU) or "host" (gloo with CUDA tensors: copied to
    the host, gathered there, copied back)."""
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("an NCCL group gathers CUDA tensors only")
        return "device"
    if backend == "gloo":
        return "host" if device_type == "cuda" else "device"
    raise ValueError(f"unsupported backend {backend!r}")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def rank_device(device_type: str = "cuda", local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: `cuda:(local_rank % device_count)` (LOCAL_RANK
    when not given) or the CPU. Raises for "cuda" without a card."""
    dev = resolve_device(device_type)
    if dev.type == "cpu":
        return dev
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK") or 0
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    local_rank: Optional[int] = None,
    local_world_size: Optional[int] = None,
    device_type: str = "cuda",
) -> bool:
    """Join this process to the ranks of a multi-process run.

    Arguments fall back to the torchrun contract: WORLD_SIZE, RANK,
    LOCAL_RANK, LOCAL_WORLD_SIZE, and `tcp://MASTER_ADDR:MASTER_PORT` as
    `init_method` (a `file://` path works too). Returns False for one
    process (nothing to do: `make_mesh` then makes a one-rank group),
    True once the group is up; a second call is a no-op. Sets this
    rank's card (`rank_device`) before its first CUDA call, and picks the
    backend by `choose_backend`."""
    if world_size is None:
        world_size = _env_int("WORLD_SIZE") or 1
    if world_size <= 1:
        return False
    if dist.is_initialized():
        return True
    if rank is None:
        rank = _env_int("RANK")
        if rank is None:
            raise ValueError("initialize_distributed: no rank given and RANK is not set")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE") or world_size
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError("initialize_distributed: no init_method given and "
                             "MASTER_ADDR/MASTER_PORT are not set")
        init_method = f"tcp://{addr}:{port}"
    dev = rank_device(device_type, local_rank)
    count = 0
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        count = torch.cuda.device_count()
    dist.init_process_group(choose_backend(dev.type, local_world_size, count),
                            init_method=init_method, world_size=world_size, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)
    return True


def make_mesh(
    n: Optional[int] = None,
    *,
    axis_shapes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (FRAME_AXIS,),
    device_type: str = "cuda",
) -> DeviceMesh:
    """A `DeviceMesh` over all `n` ranks (the world size; default), 1-D
    by default, `axis_shapes` for a streams x frames grid. In a process
    that joined no group, a one-rank group is made (`choose_backend`:
    NCCL on a card). Every rank calls this with the same arguments."""
    dev = rank_device(device_type)
    if not dist.is_initialized():
        count = torch.cuda.device_count() if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(choose_backend(dev.type, 1, count), store=dist.HashStore(),
                                rank=0, world_size=1, timeout=COLLECTIVE_TIMEOUT)
    world = dist.get_world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"make_mesh: a mesh spans every rank ({world}), not {n}")
    axis_shapes = (n,) if axis_shapes is None else tuple(axis_shapes)
    if math.prod(axis_shapes) != n or len(axis_shapes) != len(axis_names):
        raise ValueError(f"make_mesh: axis_shapes {axis_shapes} do not lay out {n} ranks "
                         f"over the axes {tuple(axis_names)}")
    mesh = init_device_mesh(dev.type, axis_shapes, mesh_dim_names=tuple(axis_names))
    mesh._uvt_transport = {name: choose_transport(dist.get_backend(mesh.get_group(name)), dev.type)
                           for name in axis_names}
    return mesh


def axis_size(mesh: DeviceMesh, axis: str = FRAME_AXIS) -> int:
    """Ranks along one named mesh dim (the reference's `mesh.shape[axis]`)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str = FRAME_AXIS) -> int:
    """This rank's index along one named mesh dim."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank runs the mesh's work on."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_mesh_device(device, mesh: Optional[DeviceMesh]) -> torch.device:
    """Where a codec runs: `resolve_device(device)`, or with a mesh this
    rank's device (a `device` named beside it must be of its type)."""
    if mesh is None:
        return resolve_device(device)
    dev = mesh_device(mesh)
    if device is not None and resolve_device(device).type != dev.type:
        raise ValueError(f"device {str(device)!r} is not the mesh's {dev.type!r}")
    return dev


def mesh_is_multiprocess(mesh: DeviceMesh) -> bool:
    """True when the mesh has more than one rank (each rank is a process)."""
    return mesh.size() > 1


def transport(mesh: DeviceMesh, axis: str = FRAME_AXIS) -> str:
    """The transport `make_mesh` chose for the dim (`choose_transport`)."""
    return mesh._uvt_transport[axis]


def all_gather_in_rank_order(mesh: DeviceMesh, x: Tensor, axis: str = FRAME_AXIS) -> Tensor:
    """Every rank's x ([n, ...], the same shape and dtype on every rank)
    concatenated along dim 0 in rank order, on x's device. Bits travel
    unchanged (-0.0 and NaN payloads included)."""
    group = mesh.get_group(axis)
    x = x.contiguous()
    src = x.cpu() if transport(mesh, axis) == "host" else x
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def all_sum_in_rank_order(mesh: DeviceMesh, x: Tensor, axis: str = FRAME_AXIS) -> Tensor:
    """The sum over the ranks of one dim of each rank's x (the reference's
    `psum`): the partials are gathered and added from 0.0 in rank order,
    so every rank holds the same bits in every run."""
    parts = all_gather_in_rank_order(mesh, x.unsqueeze(0), axis)
    acc = torch.zeros_like(x)
    for p in parts:
        acc = acc + p
    return acc


def shard_frames(mesh: DeviceMesh, array, frame_dim: int = 0) -> Tensor:
    """This rank's contiguous slice of the frame axis of `array` (numpy or
    tensor, the same on every rank), on its device. The axis must divide
    by the mesh's frame-axis size (`pad_frames_to_mesh`)."""
    t = torch.from_numpy(np.ascontiguousarray(array)) if isinstance(array, np.ndarray) else array
    per, rem = divmod(t.shape[frame_dim], axis_size(mesh))
    if rem:
        raise ValueError(f"shard_frames: {t.shape[frame_dim]} frames do not divide over "
                         f"{axis_size(mesh)} ranks (pad_frames_to_mesh first)")
    part = t.narrow(frame_dim, axis_rank(mesh) * per, per)
    return part.contiguous().to(mesh_device(mesh))


def replicate_to_host(mesh: DeviceMesh, tree):
    """Every rank's slices gathered to every rank in rank order, as CPU
    tensors (the reference's all-gather to fully replicated arrays). A
    tree is a tensor, a dict or a tuple/list of trees, or None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: replicate_to_host(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate_to_host(mesh, v) for v in tree)
    return all_gather_in_rank_order(mesh, tree).cpu()


def pad_frames_to_mesh(array: np.ndarray, mesh: DeviceMesh, frame_dim: int = 0):
    """Pad the frame axis with zeros to a multiple of the mesh's
    frame-axis size. Returns (padded, original_count)."""
    n = array.shape[frame_dim]
    per = axis_size(mesh)
    target = -(-n // per) * per
    if target == n:
        return array, n
    pad = [(0, 0)] * array.ndim
    pad[frame_dim] = (0, target - n)
    return np.pad(array, pad), n


def bucket_frames_by_count(counts, mesh_size: int = 1, max_waste: float = 0.25):
    """Group frame indices into padding buckets for ragged sequences.

    Frames sorted by count are cut greedily so each bucket's padded waste
    (1 - sum(counts)/(len*max)) stays under `max_waste`; bucket lengths
    are then rounded down to multiples of `mesh_size` where possible so
    the frame axis shards evenly (the remainder bucket relies on
    `pad_frames_to_mesh`). Returns index arrays covering every frame
    once, in ascending count across buckets."""
    counts = np.asarray(counts, np.int64)
    order = np.argsort(counts, kind="stable")
    buckets = []
    start = 0
    n = len(order)
    while start < n:
        end = start + 1
        total = int(counts[order[start]])
        while end < n:
            c = int(counts[order[end]])
            new_total = total + c
            # order is count-sorted, so c IS the running max
            waste = 1.0 - new_total / ((end - start + 1) * max(c, 1))
            if waste > max_waste and (end - start) >= mesh_size:
                break
            total = new_total
            end += 1
        if mesh_size > 1 and end < n:
            # round down to a sharding-even length (keep >= mesh_size)
            span = end - start
            even = (span // mesh_size) * mesh_size
            if even >= mesh_size:
                end = start + even
        buckets.append(order[start:end])
        start = end
    return buckets
