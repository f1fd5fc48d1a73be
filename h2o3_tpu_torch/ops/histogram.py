"""(node, feature, bin) histogram — the hot loop of tree building.

Reference: h2o3_tpu/ops/histogram.py. ``histogram`` is the reference-
shaped entry point: it builds the {w, w·g, w·h} stats and sums them per
(node, feature, bin) over ALL nodes (no sibling subtraction), and over
every rank of a sharded mesh. On CUDA
tensors it runs the ``histogram`` kernel (ops/kernels/histogram.py, the
port of ``pallas_local_histogram``); on CPU tensors its plain version.

``local_histogram`` is that plain version (the counterpart of the
reference's ``_local_histogram``): one ``index_add_`` scatters each row's
stats into its (node, feature, bin) slot, accumulating in float32. It is
also the plain version of the ``tree_hist`` kernel. On the CPU it drops
the rows outside the nodes and runs three weighted ``bincount`` passes,
one a stat: they add each slot's rows in the same order as
``index_add_`` (the same float32 sums, bit for bit) in a small fraction
of its time.
"""

from __future__ import annotations

import torch


def local_histogram(bins: torch.Tensor, nid: torch.Tensor,
                    stats: torch.Tensor, *, n_nodes: int,
                    n_bins: int) -> torch.Tensor:
    """[n_nodes, F, B, 3] per-(node, feature, bin) sums of the [N, 3]
    ``stats`` rows. A row whose ``nid`` lies outside [0, n_nodes), or a
    (row, feature) whose bin lies outside [0, n_bins), is skipped (it
    scatters into a discarded slot), as the reference's one-hot row is
    all zeros there."""
    F = bins.shape[1]
    B = n_bins
    n = nid.to(torch.int64)
    stats = stats.to(torch.float32)
    on_cpu = bins.device.type == "cpu"
    if on_cpu:
        # rows outside the nodes add nothing: drop them first (the rows
        # kept stay in order, so every slot's sum is unchanged)
        rows = ((n >= 0) & (n < n_nodes)).nonzero()[:, 0]
        bins, n, stats = bins[rows], n[rows], stats[rows]
    N = bins.shape[0]
    b = bins.to(torch.int64)
    cell = (n[:, None] * F + torch.arange(F, device=bins.device)) * B + b
    dump = n_nodes * F * B
    keep = ((n >= 0) & (n < n_nodes))[:, None] & (b >= 0) & (b < B)
    cell = torch.where(keep, cell, dump).reshape(-1)
    if on_cpu:
        out = torch.stack([torch.bincount(
            cell, weights=stats[:, None, c].expand(N, F).reshape(-1),
            minlength=dump + 1) for c in range(3)],
            dim=1).to(torch.float32)       # (an empty bincount is int64)
    else:
        out = torch.zeros((dump + 1, 3), dtype=torch.float32,
                          device=bins.device)
        out.index_add_(0, cell, stats[:, None, :].expand(N, F, 3)
                       .reshape(N * F, 3))
    return out[:dump].reshape(n_nodes, F, B, 3)


def _stats(w, g, h) -> torch.Tensor:
    return torch.stack([w, w * g, w * h], dim=1).to(torch.float32)


def histogram(bins, nid, w, g, h, *, n_nodes: int, n_bins: int,
              mesh=None, exps=None) -> torch.Tensor:
    """[n_nodes, F, n_bins, {w, w·g, w·h}] over all rows: the ``histogram``
    kernel on CUDA tensors, ``local_histogram`` on CPU tensors, summed
    over the ranks of a sharded ``mesh``. Padding rows must have
    w == 0. ``exps`` are the kernel's fixed-point exponents of the
    stats (``stat_exponents``), by default computed here."""
    from h2o3_tpu_torch.ops.kernels.histogram import full_histogram
    return full_histogram(bins, nid, _stats(w, g, h), n_nodes=n_nodes,
                          n_bins=n_bins, exps=exps, mesh=mesh)


def stat_exponents(w, g, h, mesh=None):
    """The kernel's fixed-point exponents of the {w, w·g, w·h} stats on
    the card (None elsewhere), over every rank of ``mesh``: a caller
    whose stats stay fixed over many histograms computes them once."""
    if not w.is_cuda:
        return None
    from h2o3_tpu_torch.ops.fixed_point import exponents
    return exponents(_stats(w, g, h), mesh=mesh)


def plain_histogram(bins, nid, w, g, h, *, n_nodes: int,
                    n_bins: int, exps=None) -> torch.Tensor:
    """``histogram`` through its plain version on any device — the
    reference the kernel is held against on the card (``exps`` is the
    kernel's and unused here)."""
    return local_histogram(bins, nid, _stats(w, g, h), n_nodes=n_nodes,
                           n_bins=n_bins)
