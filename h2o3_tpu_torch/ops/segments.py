"""Segment (per-node) stat sums.

Reference: h2o3_tpu/ops/segments.py ``segment_sum`` (an XLA one-hot
matmul per row block, ``psum``-ed over the mesh). On the CPU here one
float32 ``index_add_`` over the rank's rows (deterministic there),
all-reduced on a sharded mesh. On the card a float ``index_add_`` adds
in a varying order, so the sums go through 64-bit fixed point
(``ops/fixed_point.index_sum``): the same bits on every run.
"""

from __future__ import annotations

from typing import Optional

import torch

from h2o3_tpu_torch.ops.fixed_point import index_sum
from h2o3_tpu_torch.parallel.map_reduce import all_reduce


def segment_sum(nid: torch.Tensor, vals: torch.Tensor, *,
                n_nodes: int, mesh=None,
                e: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-node sums: vals [N, K] → [n_nodes, K] float32; nid in
    [0, n_nodes). On a sharded ``mesh`` the sums cover every rank's rows.
    On the card ``e`` gives the fixed-point exponents (by default those
    of ``vals`` over every rank's rows); an [M, K] ``e`` gives M equal
    blocks of rows and of nodes their own (``fixed_point.index_sum``)."""
    vals = vals.to(torch.float32)
    if vals.device.type == "cuda":
        return index_sum(nid, vals, n_nodes, e=e, mesh=mesh)
    out = torch.zeros((n_nodes, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, nid.to(torch.int64), vals)
    return all_reduce(out, mesh)
