"""Plain (node, feature, bin) histogram — the executable spec of the
``tree_hist`` CUDA kernel and its CPU path.

Reference: h2o3_tpu/ops/histogram.py ``histogram`` (a one-hot matmul per
row block on the TPU). Here one ``index_add_`` scatters each row's
{w, w·g, w·h} into its (node, feature, bin) slot, accumulating in
float32.
"""

from __future__ import annotations

import torch


def histogram(bins: torch.Tensor, nid: torch.Tensor, stats: torch.Tensor,
              *, n_nodes: int, n_bins: int) -> torch.Tensor:
    """[n_nodes, F, B, 3] per-(node, feature, bin) sums of the [N, 3]
    ``stats`` rows. Rows whose ``nid`` lies outside [0, n_nodes) are
    skipped (they scatter into a discarded slot)."""
    N, F = bins.shape
    B = n_bins
    n = nid.to(torch.int64)
    cell = (n[:, None] * F + torch.arange(F, device=bins.device)) * B \
        + bins.to(torch.int64)
    dump = n_nodes * F * B
    cell = torch.where(((n >= 0) & (n < n_nodes))[:, None], cell, dump)
    out = torch.zeros((dump + 1, 3), dtype=torch.float32,
                      device=bins.device)
    src = stats.to(torch.float32)[:, None, :].expand(N, F, 3)
    out.index_add_(0, cell.reshape(-1), src.reshape(N * F, 3))
    return out[:dump].reshape(n_nodes, F, B, 3)
