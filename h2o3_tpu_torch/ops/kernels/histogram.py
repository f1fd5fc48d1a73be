"""The full (node, feature, bin) histogram kernel — every node summed, no
sibling subtraction.

Reference: h2o3_tpu/ops/pallas_histogram.py ``pallas_local_histogram``
(the single-shard Pallas histogram, a one-hot matmul per row block on the
MXU). Here it is the hand-written CUDA kernel ``histogram``
(csrc/histogram.cu, which shares its device code with ``tree_hist``
through csrc/hist_slab.cuh). ``full_histogram`` given CUDA tensors
launches it on the current stream (and raises if it does not build or
launch); given CPU tensors it runs the plain version,
``ops.histogram.local_histogram``.
"""

from __future__ import annotations

import ctypes

import torch

from h2o3_tpu_torch.ops import kernels
from h2o3_tpu_torch.ops.histogram import local_histogram
from h2o3_tpu_torch.ops.kernels import (bin_dtype, launched, need, on_cuda,
                                        ptr, scratch, slab_geometry,
                                        sm_count, stream)

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# shared-memory budget of one block's [nodes, F, B, 3] slab: 24 nodes at
# F = 12, B = 65, so the deepest uplift level (L = 512) runs in 22 node
# chunks
HIST_SLAB_BYTES = kernels.SLAB_BYTES

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = kernels.bind("histogram", {
            "histogram": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _LL, _I, _I, _I, _LL,
                          _I, _I, _I, _I, _LL, _VP]})
    return _LIB


def full_histogram(bins: torch.Tensor, nid: torch.Tensor,
                   stats: torch.Tensor, *, n_nodes: int,
                   n_bins: int) -> torch.Tensor:
    """[n_nodes, F, n_bins, 3] sums of ``stats`` [N, 3] float32 per (node,
    feature, bin); ``bins`` [N, F] int8/int32, ``nid`` [N] int32. Rows
    outside [0, n_nodes) and bins outside [0, n_bins) contribute
    nothing."""
    if not on_cuda(bins, "histogram"):
        return local_histogram(bins, nid, stats, n_nodes=n_nodes,
                               n_bins=n_bins)
    dev = bins.device
    N, F = bins.shape
    L, B = n_nodes, n_bins
    is8 = bin_dtype(bins)
    p_bins = need(bins, bins.dtype, (N, F), "bins", dev)
    p_nid = need(nid, torch.int32, (N,), "nid", dev)
    p_stats = need(stats, torch.float32, (N, 3), "stats", dev)
    out = torch.zeros((L, F, B, 3), dtype=torch.float32, device=dev)
    plan = slab_geometry(N, F, L, B, sms=sm_count(dev),
                         budget=HIST_SLAB_BYTES)
    keys, rows = scratch(plan, N, dev)
    rc = _lib().histogram(p_bins, is8, p_nid, p_stats, ptr(keys), ptr(rows),
                          out.data_ptr(), N, F, B, L, plan.rows_per_block,
                          plan.n_chunks, plan.n_groups, plan.replicas,
                          plan.threads, plan.smem, stream(dev))
    launched(_lib(), rc, "histogram")
    return out
