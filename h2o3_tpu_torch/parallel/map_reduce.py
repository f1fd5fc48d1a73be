"""MRTask over the row mesh: map each rank's shard, all-reduce the result.

Reference: h2o3_tpu/parallel/map_reduce.py (``frame_reduce`` = a
``shard_map`` whose leaves are ``psum``-ed over the data axis, the
analogue of water/MRTask.java's doAll + reduce tree; ``frame_map`` =
map-only). Here every rank runs ``map_fn`` on its own shard and each
leaf is summed over the ranks with ``torch.distributed.all_reduce``.
World 1 runs no collective. The reference's telemetry and
fault-injection sites are not ported.

``all_reduce`` is the one collective every sharded reduction of the port
goes through (the tree level's histogram, the leaf sums, the metrics,
GLM's Gram and objectives, DeepLearning's gradient): a sum (of any
dtype: the fixed-point cells in int64, GLM's sums in float32, host
decisions' inputs in float64), a maximum or a minimum. ``all_gather``
(``parallel/mesh.fetch_replicated``) gathers a row-sharded tensor to
every rank. ``COLLECTIVES`` counts both: calls, bytes and host seconds —
the host clock runs from the call until the result is usable, so with a
gloo group over CUDA tensors it includes waiting for the kernels queued
before it.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from h2o3_tpu_torch.parallel.mesh import Mesh, get_mesh, is_sharded

COLLECTIVES: Dict[str, float] = {"all_reduce": 0, "all_gather": 0,
                                 "bytes": 0, "seconds": 0.0}
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def reset_collectives() -> None:
    COLLECTIVES.update(all_reduce=0, all_gather=0, bytes=0, seconds=0.0)


def count_collective(kind: str, nbytes: int, t0: float) -> None:
    """Count one ``kind`` collective of ``nbytes`` that started at host
    time ``t0``."""
    COLLECTIVES["seconds"] += time.perf_counter() - t0
    COLLECTIVES[kind] += 1
    COLLECTIVES["bytes"] += int(nbytes)


def all_reduce(t: torch.Tensor, mesh: Optional[Mesh] = None,
               op: str = "sum") -> torch.Tensor:
    """Sum ``t`` over the ranks of a sharded ``mesh`` (or, with ``op=
    "max"`` / ``"min"``, take its maximum / minimum), in place; returns
    ``t``. ``None`` or a world-1 mesh leaves ``t`` as it is."""
    if not is_sharded(mesh):
        return t
    if not t.is_contiguous():
        raise ValueError("all_reduce needs a contiguous tensor")
    t0 = time.perf_counter()
    dist.all_reduce(t, op=_OPS[op], group=mesh.group)
    count_collective("all_reduce", t.numel() * t.element_size(), t0)
    return t


def all_reduce_flat(tensors, mesh: Optional[Mesh] = None) -> list:
    """Sums of several tensors of one dtype over the ranks in ONE
    collective (their elements laid end to end); ``None`` or a world-1
    mesh returns them as they are."""
    tensors = list(tensors)
    if not is_sharded(mesh):
        return tensors
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _tree_map(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    raise TypeError(f"frame_reduce: leaf of type {type(x).__name__} is "
                    "not a tensor")


def frame_reduce(map_fn: Callable[..., Any], *arrays,
                 mesh: Optional[Mesh] = None) -> Any:
    """``map_fn(*local_shards)`` → a tensor, or a tuple/list/dict of
    them; every leaf summed over the ranks."""
    mesh = mesh or get_mesh()
    return _tree_map(lambda s: all_reduce(s.contiguous(), mesh),
                     map_fn(*arrays))


def frame_map(map_fn: Callable[..., Any], *arrays,
              mesh: Optional[Mesh] = None) -> Any:
    """Row-wise map: each rank maps its own shard; the output stays
    sharded like the input."""
    return map_fn(*arrays)
