"""Segment (per-node) stat sums.

Reference: h2o3_tpu/ops/segments.py ``segment_sum`` (an XLA one-hot
matmul per row block). Here one float32 ``index_add_``.
"""

from __future__ import annotations

import torch


def segment_sum(nid: torch.Tensor, vals: torch.Tensor, *,
                n_nodes: int) -> torch.Tensor:
    """Per-node sums: vals [N, K] → [n_nodes, K]; nid in [0, n_nodes)."""
    out = torch.zeros((n_nodes, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, nid.to(torch.int64), vals.to(torch.float32))
