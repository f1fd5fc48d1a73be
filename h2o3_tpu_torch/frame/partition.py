"""Partitioned ingest agreement — the host-side exchange that lets each
rank ingest only its own rows yet build the columns a single process
would build from all of them.

Reference: h2o3_tpu/frame/partition.py. There every process publishes
its local facts over the coordination service's key-value store and
applies a deterministic merge; here the facts travel in one
``all_gather_object`` over the mesh's host-object group. Each merge
equals what ``column_from_numpy`` decides from the concatenated rows:

- string columns: the sorted union of the ranks' levels is the sorted
  domain that interning all rows gives;
- numeric columns forced categorical: the sorted union of the raw
  levels, in the source dtype, formats to the domain of
  ``factorize_numeric`` over all rows.

The reference also merges numeric facts (integrality, range), which
decide its narrowing codecs; the port stores every numeric column as
float32 and has no such decision to agree on.

Every function here is COLLECTIVE on a sharded mesh: every rank calls
it at the same point in program order.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch.distributed as dist

from h2o3_tpu_torch.parallel.mesh import Mesh


def allgather_objects(obj: Any, mesh: Mesh) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    if not mesh.sharded:
        return [obj]
    out: List[Any] = [None] * mesh.world_size
    dist.all_gather_object(out, obj, group=mesh.host_group)
    return out


def allgather_rows(arrays: Dict[str, np.ndarray],
                   mesh: Mesh) -> Dict[str, np.ndarray]:
    """Every rank's row slices concatenated into full host columns, in
    rank (= row) order, in one exchange."""
    blocks = allgather_objects({k: np.asarray(v) for k, v in arrays.items()},
                               mesh)
    return {k: np.concatenate([b[k] for b in blocks]) for k in arrays}


def local_str_levels(values: np.ndarray) -> List[str]:
    """Sorted distinct string forms of this rank's non-missing values
    (None and float NaN are missing, as in ``column._intern``)."""
    v = np.asarray(values, dtype=object)
    missing = np.array([x is None or (isinstance(x, float) and np.isnan(x))
                        for x in v], dtype=bool)
    return [str(u) for u in np.unique(v[~missing].astype(str))]


def merge_str_levels(per_rank: List[List[str]]) -> List[str]:
    """Sorted union of the ranks' levels."""
    return sorted(set().union(*per_rank))


def local_num_levels(values: np.ndarray) -> dict:
    """Distinct finite raw values of this rank's numeric column forced
    categorical, kept numeric so the union sorts numerically."""
    v = np.asarray(values)
    ok = np.isfinite(v.astype(np.float64))
    return {"levels": np.unique(v[ok]).tolist(), "dtype": str(v.dtype)}


def merge_num_levels(per_rank: List[dict]) -> np.ndarray:
    """Sorted union of the ranks' raw levels, in the source dtype."""
    dtypes = {m["dtype"] for m in per_rank}
    if len(dtypes) > 1:
        raise ValueError(f"partitioned ingest: ranks disagree on the "
                         f"column's dtype {sorted(dtypes)}")
    levels = set().union(*(m["levels"] for m in per_rank))
    return np.asarray(sorted(levels), dtype=np.dtype(dtypes.pop()))
