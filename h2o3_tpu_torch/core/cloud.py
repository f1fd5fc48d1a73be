"""Cloud formation — one process per rank, joined in a process group.

Reference: h2o3_tpu/core/cloud.py ``init`` (:108) and ``shutdown``
(:325), where ``jax.distributed.initialize`` forms the cloud and the
mesh spans every process's devices. Here ``init`` wraps
``torch.distributed.init_process_group`` and installs the row mesh
(``parallel/mesh.py``). The caller names the backend, its rank, the
world size and the rendezvous address; nothing is guessed. The roll
call, heartbeat and retries of the reference are not ported.

    from h2o3_tpu_torch.core import cloud
    mesh = cloud.init("nccl", rank, world, "tcp://localhost:29500")
    ...
    cloud.shutdown()
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from h2o3_tpu_torch.parallel import device as dev_mod
from h2o3_tpu_torch.parallel import mesh as mesh_mod


def init(backend: str, rank: int, world_size: int, init_method: str,
         device: dev_mod.DeviceLike = None) -> mesh_mod.Mesh:
    """Join the process group and install its mesh as the process mesh.

    ``backend`` is ``"nccl"`` (CUDA tensors, one card per rank) or
    ``"gloo"`` (CPU tensors, or CUDA tensors staged through the host —
    the layout for several ranks on one card). ``device`` defaults to
    CUDA and raises without a card; a CUDA device without an index
    becomes ``cuda:<rank mod device count>``. An NCCL group gets a gloo
    side group for host objects."""
    dev = dev_mod.resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size)
    group = dist.group.WORLD
    host_group = group if backend == "gloo" else dist.new_group(
        backend="gloo")
    mesh = mesh_mod.Mesh(group=group, host_group=host_group, rank=rank,
                         world_size=world_size, device=dev)
    mesh_mod.set_global_mesh(mesh)
    return mesh


def shutdown() -> None:
    """Leave the process group and return to the world-1 mesh."""
    mesh_mod.set_global_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()

