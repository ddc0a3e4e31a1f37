"""Process groups and device meshes for the stereo/mono parallelism axes
(counterpart of depthestimation_tpu/parallel/mesh.py).

The axes are the JAX package's:

- 'data':  frame data parallelism (the per-frame video loop spread over
           ranks) and the mono train step's batch;
- 'tile':  row tiles of one image with halo exchange (parallel/shard.py);
- 'model': tensor parallelism for the mono net (models/train.py), and the
           disparity range of the stereo cost volume.

JAX sees every device of every process in one program. Here each rank is
one process with one device, so a mesh of shape (data, tile, model) needs
a process group of data * tile * model ranks: torch.distributed with NCCL
for tensors on the card (one rank per GPU), or gloo when the caller asks
for the CPU. A mesh of one rank needs no launcher: make_mesh starts a
one-rank group on an in-process store when none is running.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..pipeline import _resolve_device

__all__ = ["make_mesh", "auto_mesh_shape", "initialize_distributed", "axis_info"]


def _backend(device) -> str:
    """NCCL for the card, gloo for the CPU; a CUDA device without a card
    raises (no quiet CPU fallback)."""
    return "nccl" if _resolve_device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda"):
    """Join a process group of num_processes ranks whose rank 0 listens at
    `coordinator` ("host:port" or "tcp://host:port"; or a shared file,
    "file:///path", for processes of one machine). A no-op for one
    process, as in JAX. On the card each rank takes the GPU of its rank
    (one rank per GPU, as NCCL needs) and the backend is NCCL; with
    device="cpu" it is gloo. A failed rendezvous raises."""
    if num_processes is None or num_processes <= 1:
        return
    backend = _backend(device)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)


def auto_mesh_shape(n_devices: int, want_tile: bool = True) -> Tuple[int, int, int]:
    """(data, tile, model) factorization of n_devices: prefer tile
    parallelism for latency, data parallelism for throughput."""
    if n_devices == 1:
        return (1, 1, 1)
    tile = 1
    if want_tile:
        for t in (4, 2):
            if n_devices % t == 0:
                tile = t
                break
    data = n_devices // tile
    return (data, tile, 1)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "tile", "model"),
              device="cuda") -> DeviceMesh:
    """A DeviceMesh of `shape` over every rank of the process group
    (device_type "cuda" unless device="cpu"). shape defaults to
    auto_mesh_shape(world size) and must multiply out to the world size:
    every rank holds one device. Without a running group, a one-rank mesh
    starts one (NCCL on the card, gloo on the CPU) on an in-process store,
    so it needs no port; larger meshes need initialize_distributed first."""
    backend = _backend(device)
    if not dist.is_initialized():
        if shape is not None and int(np.prod(shape)) != 1:
            raise RuntimeError(f"a mesh of shape {tuple(shape)} needs a process "
                               "group: call initialize_distributed first")
        if backend == "nccl":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    world = dist.get_world_size()
    if shape is None:
        shape = auto_mesh_shape(world)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {int(np.prod(shape))} "
                         f"ranks, the process group has {world}")
    device_type = "cuda" if backend == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def axis_info(mesh: DeviceMesh, axis: str):
    """(process group, this rank's index, size) of one mesh axis."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    return mesh.get_group(axis), mesh.get_local_rank(axis), size
