"""The slab histogram's host plan (``ops/kernels.slab_geometry``) at the
shapes of every path that launches it, on the CPU: the SM count and the
shared-memory budget are given, so no card is needed.

Each case checks that the slab (all its copies) and the warps' row
queues stay within the budget,
that the node chunks and feature groups are balanced, that the tiles
cover every (row, node, feature) exactly once, and that emulating the
plan tile by tile with the plain ``local_histogram`` on sub-slices gives
exactly one ``local_histogram`` call."""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.ops import kernels
from h2o3_tpu_torch.ops.histogram import local_histogram

H100_SMS = 132

# (path, n_rows, F, B, nodes, left_only): GBM d = 0..5 (Lh), DRF's deeper
# levels (Lh up to 256), uplift L = 1..512, and a wide frame of F = 300
# int32 features at B = 256
CASES = (
    [("gbm", 5_000_000, 10, 126, lh, d > 0)
     for d, lh in enumerate((1, 1, 2, 4, 8, 16))]
    + [("drf", 5_000_000, 10, 126, lh, True) for lh in (32, 64, 128, 256)]
    + [("uplift", 13_979_592, 12, 65, 2 ** d, False) for d in range(10)]
    + [("wide", 1_000_000, 300, 256, 4, False)])

# chunk counts at the full budget (one 1024-thread block per SM)
WANT_CHUNKS = {("gbm", 16): 2, ("drf", 256): 18, ("uplift", 16): 1,
               ("uplift", 32): 2, ("uplift", 64): 3, ("uplift", 128): 6,
               ("uplift", 256): 11, ("uplift", 512): 22}


def _ids(case):
    return f"{case[0]}-F{case[2]}-B{case[3]}-nodes{case[4]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plan_fits_budget_balanced_and_covers(case):
    path, n, F, B, nodes, _ = case
    budget = kernels.SLAB_BYTES
    plan = kernels.slab_geometry(n, F, nodes, B, sms=H100_SMS,
                                 budget=budget)
    slab = plan.chunk_nodes * plan.group_feats * B * 12
    assert plan.queue == plan.threads // 32 * kernels.SLAB_QUEUE * 4
    assert plan.smem == plan.replicas * slab + plan.queue <= budget
    assert plan.threads == kernels.SLAB_THREADS
    assert 1 <= plan.replicas <= plan.threads // 32
    if plan.replicas > 1:
        assert 2 * slab <= budget - plan.queue
    assert plan.n_chunks == WANT_CHUNKS.get((path, nodes), plan.n_chunks)
    if path in ("gbm", "uplift") and nodes <= 8:
        assert plan.n_chunks == 1
    # 74 features of 256 bins fit beside the queues: 5 groups of 60
    assert plan.n_groups == (5 if path == "wide" else 1)
    # the whole grid, counted without walking every tile
    assert plan.row_blocks * plan.rows_per_block >= n
    assert (plan.row_blocks - 1) * plan.rows_per_block < n
    chunk = [(y + 1) * nodes // plan.n_chunks - y * nodes // plan.n_chunks
             for y in range(plan.n_chunks)]
    group = [(z + 1) * F // plan.n_groups - z * F // plan.n_groups
             for z in range(plan.n_groups)]
    assert sum(chunk) == nodes and sum(group) == F
    assert max(chunk) - min(chunk) <= 1 and max(chunk) == plan.chunk_nodes
    assert max(group) - min(group) <= 1 and max(group) == plan.group_feats
    # past SLAB_LIST_CHUNKS chunks a block sorts its rows by chunk first,
    # its counts and starts in the warps' queues
    assert plan.listed == (
        plan.n_chunks > kernels.SLAB_LIST_CHUNKS
        and 2 * plan.n_chunks * 4 <= plan.queue)
    if path == "uplift" and nodes >= 64 or path == "drf":
        assert plan.listed
    # about SLAB_WAVES blocks per SM slot, each walking every node chunk
    blocks = plan.row_blocks * plan.n_groups
    assert blocks <= 2 * H100_SMS * kernels.SLAB_WAVES + plan.n_groups


def test_plan_shallow_levels_are_replicated():
    gbm = kernels.slab_geometry(5_000_000, 10, 1, 126, sms=H100_SMS)
    uplift = kernels.slab_geometry(13_979_592, 12, 1, 65, sms=H100_SMS)
    assert gbm.replicas == 15 and uplift.replicas == 24
    deep = kernels.slab_geometry(5_000_000, 10, 16, 126, sms=H100_SMS)
    assert deep.replicas == 1 and deep.chunk_nodes == 8


def test_plan_rejects_a_feature_wider_than_the_budget():
    with pytest.raises(ValueError, match="exceed"):
        kernels.slab_geometry(100, 3, 1, 300, sms=H100_SMS, budget=3000)


def _emulate(plan, bins, nid, stats, nodes, B):
    """The plan's tiles, each summed by ``local_histogram`` on its
    sub-slices and added into its place of the full histogram."""
    N, F = bins.shape
    out = torch.zeros((nodes, F, B, 3), dtype=torch.float32)
    covered = torch.zeros((N, nodes, F), dtype=torch.int32)
    for r0, r1, c0, c1, f0, f1 in plan.tiles(N, F, nodes):
        out[c0:c1, f0:f1] += local_histogram(
            bins[r0:r1, f0:f1], nid[r0:r1] - c0, stats[r0:r1],
            n_nodes=c1 - c0, n_bins=B)
        covered[r0:r1, c0:c1, f0:f1] += 1
    return out, covered


# small shapes, small budgets and SM counts: many row blocks, chunks and
# groups, replicas, uneven splits
EMULATED = [
    # (n_rows, F, B, nodes, budget, sms, left_only)
    (3_001, 10, 126, 1, kernels.SLAB_BYTES, 132, False),
    (3_001, 10, 126, 16, kernels.SLAB_BYTES, 132, True),
    (2_999, 12, 65, 64, kernels.SLAB_BYTES, 132, False),
    (5_000, 12, 65, 512, 5 * 65 * 12 * 12, 3, False),
    (1_500, 10, 126, 256, 7 * 10 * 126 * 12, 4, True),
    (2_000, 10, 126, 8, 3 * 126 * 12, 2, False),
    (1_000, 30, 256, 4, kernels.SLAB_BYTES // 4, 5, False),
]


@pytest.mark.parametrize("n,F,B,nodes,budget,sms,left_only", EMULATED)
def test_plan_tile_by_tile_equals_one_histogram(n, F, B, nodes, budget,
                                                sms, left_only):
    plan = kernels.slab_geometry(n, F, nodes, B, sms=sms, budget=budget,
                                 threads=128)
    assert plan.smem <= budget
    r = np.random.RandomState(n + nodes)
    bins = torch.from_numpy(r.randint(0, B, (n, F)).astype(np.int32))
    bins[::37, 0] = B                     # outside the bins: skipped
    raw = r.randint(-1, 2 * nodes + 1 if left_only else nodes + 1, n)
    nid = torch.from_numpy(raw.astype(np.int32))
    w = r.randint(0, 3, n).astype(np.float32)
    stats = torch.from_numpy(np.stack(
        [w, w * r.randint(-4, 5, n), w * r.randint(1, 5, n)],
        1).astype(np.float32))
    if left_only:                         # the kernel's left-child path
        nid = torch.where(nid % 2 == 0, nid >> 1, -1)
    got, covered = _emulate(plan, bins, nid, stats, nodes, B)
    want = local_histogram(bins, nid, stats, n_nodes=nodes, n_bins=B)
    assert torch.equal(got, want)
    assert bool((covered == 1).all())
    assert plan.n_chunks * plan.n_groups > 1 or budget == kernels.SLAB_BYTES
