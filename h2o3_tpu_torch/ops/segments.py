"""Segment (per-node) stat sums.

Reference: h2o3_tpu/ops/segments.py ``segment_sum`` (an XLA one-hot
matmul per row block, ``psum``-ed over the mesh). Here one float32
``index_add_`` over the rank's rows, all-reduced on a sharded mesh.
"""

from __future__ import annotations

import torch

from h2o3_tpu_torch.parallel.map_reduce import all_reduce


def segment_sum(nid: torch.Tensor, vals: torch.Tensor, *,
                n_nodes: int, mesh=None) -> torch.Tensor:
    """Per-node sums: vals [N, K] → [n_nodes, K]; nid in [0, n_nodes).
    On a sharded ``mesh`` the sums cover every rank's rows."""
    out = torch.zeros((n_nodes, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, nid.to(torch.int64), vals.to(torch.float32))
    return all_reduce(out, mesh)
