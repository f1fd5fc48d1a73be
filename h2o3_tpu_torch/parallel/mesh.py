"""The row mesh — W ranks, one process each, every rank homing one
contiguous shard of the padded rows on its own device.

Reference: h2o3_tpu/parallel/mesh.py. There the mesh is a
``jax.sharding.Mesh`` whose ``data`` axis shards rows and every reduce is
a ``psum``; here it is a ``torch.distributed`` process group: rank r
holds padded rows ``[r·npad/W, (r+1)·npad/W)`` and every reduce is an
``all_reduce`` (``parallel/map_reduce.py``). ``host_group`` carries host
objects (``all_gather_object``): a gloo group beside an NCCL one, whose
object collectives want CUDA tensors and a set device.

With no mesh installed ``get_mesh()`` is a world-1 mesh, and every entry
point that takes ``mesh=`` runs exactly its one-device code for it.
``parallel/device.py`` stays the world-1 surface (device resolution).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    group: Any                 # torch.distributed ProcessGroup, or None
    host_group: Any            # group for host objects (gloo), or None
    rank: int
    world_size: int
    device: Optional[torch.device] = None

    @property
    def sharded(self) -> bool:
        """True when rows are split over more than one rank."""
        return self.world_size > 1


LOCAL = Mesh(group=None, host_group=None, rank=0, world_size=1)

_GLOBAL_MESH: Optional[Mesh] = None


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    """Install the process mesh; ``None`` returns to the world-1 mesh."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_mesh() -> Mesh:
    """The process mesh: the one ``core.cloud.init`` installed, else the
    world-1 mesh."""
    return _GLOBAL_MESH if _GLOBAL_MESH is not None else LOCAL


def is_sharded(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.sharded


def data_size(mesh: Optional[Mesh] = None) -> int:
    return (mesh or get_mesh()).world_size


def padded_rows(n: int, mesh: Optional[Mesh] = None, block: int = 1) -> int:
    """Rows padded so every rank holds an equal, ``block``-aligned count.
    Padding rows carry weight 0, so every weighted reduction ignores
    them. (The reference also rounds up to a shape bucket; that exists
    only to bound the number of XLA compilations and has no use here.)"""
    d = data_size(mesh) * max(int(block), 1)
    return ((int(n) + d - 1) // d) * d


def partition_bounds(npad: int, mesh: Optional[Mesh] = None
                     ) -> Tuple[int, int]:
    """This rank's padded row range ``[lo, hi)``: rank r homes rows
    ``[r·npad/W, (r+1)·npad/W)``."""
    mesh = mesh or get_mesh()
    per = int(npad) // mesh.world_size
    if per * mesh.world_size != int(npad):
        raise ValueError(f"{npad} padded rows do not split over "
                         f"{mesh.world_size} ranks")
    return mesh.rank * per, (mesh.rank + 1) * per


def owned_rows(nrows: int, mesh: Optional[Mesh] = None,
               block: int = 1) -> Tuple[int, int]:
    """The logical (unpadded) row range ``[lo, hi)`` this rank supplies to
    ``Frame.from_numpy_partitioned`` of an ``nrows``-row frame; empty
    for a rank whose shard is all padding."""
    lo, hi = partition_bounds(padded_rows(nrows, mesh, block), mesh)
    return min(lo, nrows), min(hi, nrows)


def valid_mask(n: int, span: Tuple[int, int],
               device: torch.device) -> torch.Tensor:
    """float32 1/0 mask over the padded rows ``[lo, hi)`` of this rank:
    1 where the global row index is below ``n``."""
    lo, hi = span
    m = torch.zeros(hi - lo, dtype=torch.float32, device=device)
    m[:max(min(n, hi) - lo, 0)] = 1.0
    return m


def fetch_replicated(x: torch.Tensor,
                     mesh: Optional[Mesh] = None) -> np.ndarray:
    """Host copy of a row-sharded tensor in global row order: an
    ``all_gather`` of every rank's (equal-sized) shard over the host
    group. ``None`` or a world-1 mesh: a plain device → host copy."""
    x = x.detach().cpu().contiguous()
    if not is_sharded(mesh):
        return x.numpy()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x, group=mesh.host_group)
    return torch.cat(parts).numpy()
