"""The (data, feat) device mesh over ``torch.distributed``, and the
collectives the sharded stages use.

Counterpart of ``ssrlcv_tpu/parallel/mesh.py``.  Each rank drives one device
(``cuda:{local rank}``, or the CPU); the mesh is a 2-D
``torch.distributed.device_mesh.DeviceMesh`` over every rank of the group:

  * ``data`` -- match-pair / track / query-feature data parallelism (each
    rank owns a slice of the work items);
  * ``feat`` -- the target-feature axis of the brute-force matcher, so the
    best target of a query is a MIN over the ``feat`` group.

Rank r sits at (r // feat, r % feat); the flattened mesh is the world group
in rank order.

Backends: NCCL for CUDA tensors, gloo for the CPU.  A helper takes the
backend of the group it is given.  Under gloo, a CUDA tensor crosses the
collective through a host copy (gloo's all-gather takes no CUDA tensor) and
comes back to its device: that is the staging the backend needs, not a
fallback -- the computation itself stays on the rank's device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FEAT_AXIS = "feat"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group (one process per device).  ``coordinator``
    is "host:port" of rank 0.  With no arguments it reads torchrun's
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  Does nothing when a group exists already or there is
    one process and no group.  ``backend``: NCCL where CUDA is available,
    gloo otherwise, unless named.  Returns True when this call created the
    group (the caller then destroys it)."""
    if dist.is_initialized():
        return False
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator is None:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def initialize_single(backend: str) -> bool:
    """A one-rank group in this process (an in-memory store, no port), so
    that one process can run the sharded stages over a 1 x 1 mesh.  Does
    nothing when a group exists.  Returns True when it created one."""
    if dist.is_initialized():
        return False
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    return True


def local_rank() -> int:
    """This process's rank among the processes of its host (torchrun's
    ``LOCAL_RANK``; the global rank when that is not set)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))


def make_mesh(data: Optional[int] = None, feat: int = 1, device_type: str = "cuda"):
    """A (data, feat) DeviceMesh over every rank of the initialised group
    (default: all ranks on the data axis).  ``device_type`` "cuda" for an
    NCCL group, "cpu" for a gloo one.  Raises when data x feat is not the
    world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (initialize_distributed or "
                           "initialize_single first)")
    n = dist.get_world_size()
    if data is None:
        data = n // feat
    if data < 1 or feat < 1 or data * feat != n:
        raise ValueError(f"mesh {data}x{feat} != world size {n}")
    return init_device_mesh(device_type, (data, feat), mesh_dim_names=(DATA_AXIS, FEAT_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def flat_rank(mesh) -> int:
    """This rank's index in the flattened (data, feat) mesh."""
    return axis_rank(mesh, DATA_AXIS) * axis_size(mesh, FEAT_AXIS) + axis_rank(mesh, FEAT_AXIS)


def _group(mesh, axis: Optional[str]):
    """The group of one axis, or of the whole mesh (the world) for None."""
    return mesh.get_group(axis) if axis is not None else dist.group.WORLD


def _comm_device(group, device: torch.device) -> torch.device:
    """Where a tensor on ``device`` crosses ``group``'s collectives: the
    host under gloo, the device itself under NCCL."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return device


def all_reduce(x: torch.Tensor, op: str, mesh, axis: Optional[str] = None) -> torch.Tensor:
    """SUM, MIN or MAX of ``x`` over one mesh axis (None: the whole mesh);
    a new tensor on ``x``'s device."""
    group = _group(mesh, axis)
    y = x.to(_comm_device(group, x.device), copy=True)
    dist.all_reduce(y, op=getattr(dist.ReduceOp, op), group=group)
    return y.to(x.device)


def all_gather(x: torch.Tensor, mesh, axis: Optional[str] = None) -> list:
    """Every rank's ``x`` (equal shapes) over one mesh axis (None: the
    whole mesh), in the axis's rank order, on ``x``'s device."""
    group = _group(mesh, axis)
    y = x.to(_comm_device(group, x.device)).contiguous()
    if y.dtype == torch.bool:  # crosses as bytes: not every backend takes bool
        y = y.view(torch.uint8)
    out = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, y, group=group)
    return [o.view(x.dtype).to(x.device) for o in out]


def all_gather_ragged(x: torch.Tensor, mesh, axis: Optional[str] = None) -> list:
    """Every rank's ``x`` of shape (n_rank, ...) with equal trailing dims:
    the counts first, then the rows padded to the largest count, then each
    rank's rows cut back to its count (``_allgather_pair_matches`` of the
    JAX package)."""
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    counts = [int(c) for c in torch.cat(all_gather(n, mesh, axis)).cpu()]
    cap = max(max(counts), 1)
    pad = torch.zeros((cap - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return [g[:c] for g, c in zip(all_gather(torch.cat([x, pad]), mesh, axis), counts)]


def host_value(shard: torch.Tensor, mesh, axis: Optional[str] = None) -> torch.Tensor:
    """The global value of a tensor sharded on its leading axis: every
    rank's shard (equal shapes) concatenated in rank order over one mesh
    axis (None: the flattened mesh), on every rank (``host_value`` of the
    JAX package gathers a non-addressable global array)."""
    return torch.cat(all_gather(shard, mesh, axis))


def host_tree(struct, mesh, axis: Optional[str] = None):
    """``host_value`` over every field of one of the port's tensor
    dataclasses (``core.types``)."""
    import dataclasses

    return type(struct)(**{f.name: host_value(getattr(struct, f.name), mesh, axis)
                           for f in dataclasses.fields(struct)})
