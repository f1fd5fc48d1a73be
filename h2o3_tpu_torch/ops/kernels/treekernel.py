"""One tree level: histogram → split scan → row partition.

Reference: h2o3_tpu/ops/pallas/treekernel.py ``fused_level`` (one
``pallas_call``, ``_fused_call``, on a single data shard) and
``xla_level`` (the reference composition). Here the level is three
hand-written CUDA kernels (csrc/treekernel.cu), each with its plain
PyTorch version beside it:

- ``tree_hist``      phase 0: the [Lh, F, B, 3] {w, w·g, w·h} histogram
                     (left children only at d >= 1, into the parent slot),
                     summed in 64-bit fixed point (``ops/fixed_point.py``:
                     the same bits on every run);
- ``tree_split``     the boundary: sibling subtraction with the w/h >= 0
                     clamps, ``best_splits``, the min-split-improvement and
                     depth-limit masks, the categorical-split flags;
- ``tree_partition`` phase 1: every row to child ``2·nid + {0, 1}``.

A wrapper given CUDA tensors launches its kernel on the current stream
(and raises if the kernel does not build or launch); given CPU tensors it
runs its plain version. ``fused_level`` composes the three wrappers;
``plain_level`` composes the three plain versions on any device and is
the reference the kernels are held against on the card.

On a sharded mesh (``parallel/mesh.py``, W ranks each holding its own
rows) the level runs as the reference's two-kernel variant
(``_hist_call`` → ``psum`` → ``_level_boundary`` → ``_partition_call``):

- ``shard_hist``      the rank's histogram (``tree_hist``'s device code
                      on the rank's rows, counted under its own name) and
                      its sum over the ranks: the int64 fixed-point cells
                      are all-reduced (``torch.distributed``) before they
                      convert to float32, with exponents every rank
                      shares;
- ``tree_split``      on the summed histogram, identical on every rank;
- ``shard_partition`` the rank's rows routed (``tree_partition``'s
                      device code, counted under its own name).

The model axis (the reference's ``vmap`` of ``_fused_call`` over a grid
bucket of models, ``h2o3_tpu/models/gbm.py`` ``_boost_scan_batched_jit``)
is three more launches, each counted under its own name:
``tree_hist_models``, ``tree_split_models`` and ``tree_partition_models``
run one level of M models at once. The bins are shared; node ids,
stats, exponents, knobs, column masks, depth limits, histograms and
decisions carry a leading model axis. Each model's outputs are the bits
its own ``tree_hist`` / ``tree_split`` / ``tree_partition`` give, and
the plain versions (``hist_models_plain``, ``split_models_plain``,
``partition_models_plain``) are the single-model plain versions in a
loop over the models. ``fused_level_models`` composes the three
wrappers and ``plain_level_models`` the three plain versions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import torch

from h2o3_tpu_torch.ops import kernels
from h2o3_tpu_torch.ops.fixed_point import exponents
from h2o3_tpu_torch.ops.histogram import local_histogram
from h2o3_tpu_torch.ops.kernels import (bin_dtype, launched, need, on_cuda,
                                        ptr, refused, scratch, slab_buffers,
                                        slab_geometry, sm_count, stream)
from h2o3_tpu_torch.ops.split_scan import best_splits
from h2o3_tpu_torch.parallel.map_reduce import all_reduce
from h2o3_tpu_torch.parallel.mesh import is_sharded

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# shared-memory budget of one tree_hist block's [nodes, F, B, 3] slab
HIST_SLAB_BYTES = kernels.SLAB_BYTES
# tree_split: threads of a (node, feature) block at most (kSplitThreads,
# the kernel's launch bound), and the shared memory a block may take
SPLIT_THREADS, SPLIT_SMEM_BYTES = 1024, kernels.SLAB_BYTES
# tree_partition: the shared memory of a block's node records and left
# sets; threads a block and blocks an SM (kRouteThreads,
# kRouteBlocksPerSm: the kernel's launch bound keeps its registers within
# that many), for a grid of one wave
ROUTE_SMEM_BYTES = kernels.SLAB_BYTES
ROUTE_THREADS, ROUTE_BLOCKS_PER_SM = 512, 2

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = kernels.bind("treekernel", {
            "tree_hist": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL,
                          _I, _I, _I, _I, _LL, _I, _I, _I, _I, _LL, _I,
                          _VP],
            "slab_convert": [_VP, _VP, _VP, _LL, _VP],
            "tree_split": [_VP] * 23 + [_I] * 9 + [_LL, _VP],
            "tree_partition": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                               _VP, _LL, _I, _I, _I, _LL, _LL, _I, _I, _LL,
                               _I, _I, _VP],
            "tree_hist_global": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _LL, _I,
                                 _I, _I, _I, _I, _I, _VP],
            "tree_hist_models": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                 _LL, _I, _I, _I, _I, _LL, _I, _I, _I, _I,
                                 _LL, _I, _VP],
            "tree_hist_global_models": [_VP, _I, _VP, _VP, _VP, _VP, _VP,
                                        _LL, _I, _I, _I, _I, _I, _I, _VP],
            "tree_split_models": [_VP] * 23 + [_I] * 9 + [_LL, _I, _VP],
            "tree_partition_models": [_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP,
                                      _VP, _VP, _LL, _I, _I, _I, _LL, _LL,
                                      _I, _I, _LL, _I, _I, _I, _VP],
        })
    return _LIB


# ------------------------------------------------------------ tree_hist


def hist_plain(bins, nid, stats, *, d: int, n_nodes_h: int, n_bins: int,
               exps=None, mesh=None):
    """Plain version of ``tree_hist``: at d >= 1 odd (right-child) rows
    are skipped and even rows land in their parent's slot; float32 sums,
    over every rank of a sharded ``mesh`` (``exps`` is the kernel's and
    unused here)."""
    if d > 0:
        nid = torch.where(nid % 2 == 0, nid >> 1, -1)
    return all_reduce(local_histogram(bins, nid, stats, n_nodes=n_nodes_h,
                                      n_bins=n_bins), mesh)


def tree_hist(bins, nid, stats, *, d: int, n_nodes_h: int, n_bins: int,
              exps=None, mesh=None):
    """[Lh, F, B, 3] level histogram of ``stats`` [N, 3]. ``exps`` (int32
    [3] on the card) are the fixed-point exponents, by default those of
    ``stats``; a grown tree passes its own, computed once a tree.
    ``mesh`` is unused: a level runs ``tree_hist`` only unsharded."""
    return _hist(bins, nid, stats, d, n_nodes_h, n_bins, exps, None,
                 "tree_hist")


def shard_hist(bins, nid, stats, *, d: int, n_nodes_h: int, n_bins: int,
               exps=None, mesh=None):
    """``tree_hist`` of this rank's rows, summed over the ranks of
    ``mesh`` (the port of the reference's per-shard ``_hist_call`` and
    its ``psum``). ``exps`` must be the same on every rank (by default
    ``exponents`` over every rank's rows)."""
    return _hist(bins, nid, stats, d, n_nodes_h, n_bins, exps, mesh,
                 "shard_hist")


def _hist(bins, nid, stats, d, n_nodes_h, n_bins, exps, mesh, name):
    if not on_cuda(bins, name):
        return hist_plain(bins, nid, stats, d=d, n_nodes_h=n_nodes_h,
                          n_bins=n_bins, mesh=mesh)
    dev = bins.device
    N, F = bins.shape
    B, Lh = n_bins, n_nodes_h
    is8 = bin_dtype(bins)
    p_bins = need(bins, bins.dtype, (N, F), "bins", dev)
    p_nid = need(nid, torch.int32, (N,), "nid", dev)
    p_stats = need(stats, torch.float32, (N, 3), "stats", dev)
    if exps is None:
        exps = exponents(stats, mesh=mesh)
    p_exps = need(exps, torch.int32, (3,), "exps", dev)
    cells = Lh * F * B * 3
    sharded = is_sharded(mesh)
    plan = None if Lh > kernels.SLAB_MAX_NODES else slab_geometry(
        N, F, Lh, B, sms=sm_count(dev), budget=HIST_SLAB_BYTES)
    if plan is None or (not plan.listed
                        and plan.n_chunks > kernels.SLAB_LIST_CHUNKS):
        # a deep level: more parents than the slab's chunks can sort its
        # rows into, so each row adds into the global cells itself. The
        # accumulator is an allocation of its own (8 bytes a cell, 7.9 GB
        # at a depth-20 tree's last level), freed once the launch is
        # queued, while the output lives on
        acc = torch.zeros(cells, dtype=torch.int64, device=dev)
        out = torch.zeros(cells, dtype=torch.float32, device=dev)
        rc = _lib().tree_hist_global(
            p_bins, is8, p_nid, p_stats, p_exps, acc.data_ptr(),
            out.data_ptr(), N, F, B, Lh, int(d > 0),
            max(1, min(-(-N // 256), 8 * sm_count(dev))),
            int(not sharded), stream(dev))
    else:
        acc, out = slab_buffers(cells, dev)
        keys, rows = scratch(plan, N, dev)
        rc = _lib().tree_hist(p_bins, is8, p_nid, p_stats, p_exps,
                              ptr(keys), ptr(rows), acc.data_ptr(),
                              out.data_ptr(), N, F, B, Lh, int(d > 0),
                              plan.rows_per_block, plan.n_chunks,
                              plan.n_groups, plan.replicas, plan.threads,
                              plan.smem, int(not sharded), stream(dev))
    launched(_lib(), rc, name)
    if sharded:
        # integer cells sum exactly over the ranks, then convert once
        all_reduce(acc, mesh)
        all_reduce(out, mesh)
        refused(_lib(), _lib().slab_convert(acc.data_ptr(), out.data_ptr(),
                                            p_exps, cells, stream(dev)),
                name)
    return out.view(Lh, F, B, 3)


# ----------------------------------------------------------- tree_split


def split_plain(lh, prev, col_mask, nb, is_cat, constraints, lo, hi, knobs,
                depth_limit, *, d: int, n_nodes: int, n_bins: int):
    """Plain version of ``tree_split``: sibling subtraction with the
    f32-cancellation clamps on w and h, the split scan, and the masks.
    ``knobs`` is [min_rows, reg_lambda, min_split_improvement]."""
    if d == 0:
        hist = lh
    else:
        rh = prev - lh
        rh[..., 0] = rh[..., 0].clamp_min(0.0)
        rh[..., 2] = rh[..., 2].clamp_min(0.0)
        hist = torch.stack([lh, rh], dim=1).reshape(n_nodes, *lh.shape[1:])
    ic = None if is_cat is None else is_cat != 0
    bg, bf, bt, bnal, blv, brv, leftmask = best_splits(
        hist, nb, col_mask != 0, min_rows=knobs[0], reg_lambda=knobs[1],
        is_cat=ic, constraints=constraints, lo=lo, hi=hi)
    split = (bg > knobs[2]) & (d < depth_limit[0])
    cs = ic[bf.long()] & split if ic is not None \
        else torch.zeros_like(split)
    return hist, bg, bf, bt, bnal, blv, brv, leftmask, split, cs


class SplitPlan(NamedTuple):
    """The launch of ``tree_split``: one block of ``threads`` threads per
    (node, feature), each thread a run of ``per`` bins; a bitonic sort of
    ``n_sort`` (a power of two) (key, bin) pairs, held in registers where
    a thread has one pair; ``words`` 32-bit words of a left set; ``smem``
    bytes of shared memory a block (orig and scan-order w/g/h, the sort's
    keys and bins, warp totals, one candidate a warp, as
    csrc/treekernel.cu lays them out)."""
    threads: int
    per: int
    n_sort: int
    words: int
    smem: int


@functools.lru_cache(maxsize=None)
def split_plan(n_bins: int) -> SplitPlan:
    """Plan ``tree_split`` for ``n_bins`` bins (NA included): a thread
    per slot of the sort (the B-1 value bins rounded up to a power of
    two, at least a warp), at most SPLIT_THREADS threads, a longer run a
    thread beyond that; raises when a block's shared memory exceeds
    SPLIT_SMEM_BYTES."""
    bm = n_bins - 1
    if bm < 2:
        raise ValueError(f"tree_split: needs at least 3 bins, got {n_bins}")
    n_sort = 1 << (bm - 1).bit_length()
    threads = min(SPLIT_THREADS, max(32, n_sort))
    per = -(-bm // threads)
    smem = 4 * (3 * n_bins + 3 * threads * per + 2 * n_sort + 96) + 16 * 32
    if smem > SPLIT_SMEM_BYTES:
        raise ValueError(f"tree_split: {n_bins} bins need {smem} B of shared "
                         f"memory, over {SPLIT_SMEM_BYTES}")
    return SplitPlan(threads, per, n_sort, -(-bm // 32), smem)


# tree_split's scratch per (device, stream), raw 32-bit words: the
# per-node arrival counters (zeros that every launch leaves at zero: the
# node's last block resets its own), then each (node, feature)'s
# candidate {gain, index, lv, rv} and left set, which every launch writes
# before it reads them
_SCRATCH: Dict[Tuple[int, int], List[torch.Tensor]] = {}


def split_scratch(n_nodes: int, n_pairs: int, words: int, device,
                  strm: int) -> List[torch.Tensor]:
    """[arrivals, cands, bits] for launches on stream ``strm`` of
    ``device``: at least ``n_nodes`` zeroed counters, ``4 * n_pairs``
    candidate words and ``n_pairs * words`` left-set words, each
    allocated once per power-of-two size. Work on one stream runs in
    order, so launches there may share them."""
    bufs = _SCRATCH.setdefault((device.index, strm), [None, None, None])
    for i, n in enumerate((n_nodes, 4 * n_pairs, n_pairs * words)):
        if bufs[i] is None or bufs[i].numel() < n:
            bufs[i] = torch.zeros(max(64, 1 << (n - 1).bit_length()),
                                  dtype=torch.int32, device=device)
    return bufs


def tree_split(lh, prev, col_mask, nb, is_cat, constraints, lo, hi, knobs,
               depth_limit, *, d: int, n_nodes: int, n_bins: int):
    """Level boundary → (hist [L,F,B,3], gain, feat, thresh, na_left,
    left_val, right_val, leftmask [L,B-1], split, cat_split). Inputs:
    ``lh`` [Lh,F,B,3] from ``tree_hist``; ``prev`` the previous level's
    histogram (None at d=0); ``col_mask`` int8 [1|L, F]; ``nb`` int32
    [F]; ``is_cat``/``constraints`` int8 [F] or None; ``lo``/``hi``
    float32 [1|L]; ``knobs`` float32 [3]; ``depth_limit`` int32 [1]."""
    if not on_cuda(lh, "tree_split"):
        return split_plain(lh, prev, col_mask, nb, is_cat, constraints, lo,
                           hi, knobs, depth_limit, d=d, n_nodes=n_nodes,
                           n_bins=n_bins)
    dev = lh.device
    L, B = n_nodes, n_bins
    Lh, F = lh.shape[0], lh.shape[1]
    if d > 0 and prev is None:
        raise ValueError("tree_split: d > 0 needs the previous histogram")
    cm_rows, bound_rows = col_mask.shape[0], lo.shape[0]
    ptrs = [
        need(lh, torch.float32, (Lh, F, B, 3), "lh", dev),
        need(prev if d > 0 else None, torch.float32, (Lh, F, B, 3),
              "prev", dev),
        need(col_mask, torch.int8, (cm_rows, F), "col_mask", dev),
        need(nb, torch.int32, (F,), "nb", dev),
        need(is_cat, torch.int8, (F,), "is_cat", dev),
        need(constraints, torch.int8, (F,), "constraints", dev),
        need(lo, torch.float32, (bound_rows,), "lo", dev),
        need(hi, torch.float32, (bound_rows,), "hi", dev),
        need(knobs, torch.float32, (3,), "knobs", dev),
        need(depth_limit, torch.int32, (1,), "depth_limit", dev),
    ]
    if cm_rows not in (1, L) or bound_rows not in (1, L):
        raise ValueError("tree_split: col_mask and lo/hi take 1 or L rows")
    plan = split_plan(B)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    outs = (torch.empty((L, F, B, 3), **f32), torch.empty(L, **f32),
            torch.empty(L, **i32), torch.empty(L, **i32),
            torch.empty(L, **b8), torch.empty(L, **f32),
            torch.empty(L, **f32), torch.empty((L, B - 1), **b8),
            torch.empty(L, **b8), torch.empty(L, **b8))
    strm = stream(dev)
    scr = split_scratch(L, L * F, plan.words, dev, strm)
    rc = _lib().tree_split(*ptrs, *(o.data_ptr() for o in outs),
                           scr[1].data_ptr(), scr[2].data_ptr(),
                           scr[0].data_ptr(), d, L, F, B, cm_rows,
                           bound_rows, plan.threads, plan.per, plan.n_sort,
                           plan.smem, strm)
    launched(_lib(), rc, "tree_split")
    return outs


# ------------------------------------------------------- tree_partition


def partition_plain(bins, nid, feat, thresh, na_left, split, cat_split,
                    leftmask, *, n_bins: int):
    """Plain version of ``tree_partition`` (``_level_goleft`` on the raw
    per-node decisions, gated by ``split``). Per-node tables are read by
    ``index_select``: on the CPU, indexing a small table by a long row
    index (``table[n]``) is far slower."""
    n = nid.long()

    def at(t):
        return t.index_select(0, n)

    b = bins.gather(1, at(feat.long())[:, None])[:, 0].to(torch.int32)
    isna = b == n_bins - 1
    real = (b >= 0) & (b < n_bins - 1)
    inset = leftmask.reshape(-1).index_select(
        0, n * (n_bins - 1) + b.clamp(0, n_bins - 2).long()) & real
    go_split = torch.where(at(cat_split), inset, b <= at(thresh))
    goleft = torch.where(at(split), torch.where(isna, at(na_left), go_split),
                         True)
    return (2 * nid + torch.where(goleft, 0, 1)).to(torch.int32)


def tree_partition(bins, nid, feat, thresh, na_left, split, cat_split,
                   leftmask, *, n_bins: int):
    """Routed node ids [N] int32: ``2·nid`` (left) or ``2·nid + 1``."""
    return _partition(bins, nid, feat, thresh, na_left, split, cat_split,
                      leftmask, n_bins, "tree_partition")


def shard_partition(bins, nid, feat, thresh, na_left, split, cat_split,
                    leftmask, *, n_bins: int):
    """``tree_partition`` of this rank's rows on the replicated decisions
    (the port of the reference's per-shard ``_partition_call``)."""
    return _partition(bins, nid, feat, thresh, na_left, split, cat_split,
                      leftmask, n_bins, "shard_partition")


class RoutePlan(NamedTuple):
    """The launch of ``tree_partition``: rows [head, head + 4·n_vec) are
    routed four at a time from 16-byte nid loads (nid + head is 16-byte
    aligned), the ``head`` rows before and ``tail`` rows after one at a
    time; ``vec_out``: the new ids are stored 16 bytes at a time (out is
    aligned like nid). ``smem`` bytes of shared memory a block: an 8-byte
    record a node (``recs_in_smem``; else none, and a row's node is read
    from the global tables), then, where ``bits_in_smem``, ``words``
    32-bit words of left set a node. ``blocks`` of ROUTE_THREADS threads:
    one wave, as many as the SMs hold, fewer where the rows need fewer."""
    head: int
    n_vec: int
    tail: int
    vec_out: bool
    words: int
    bits_in_smem: bool
    smem: int
    blocks: int
    recs_in_smem: bool = True


def route_plan(n_rows: int, n_nodes: int, n_bins: int, nid_addr: int,
               out_addr: int, *, sms: int,
               global_records: bool = False) -> RoutePlan:
    """Plan ``tree_partition`` over ``n_rows`` rows whose int32 node ids
    start at address ``nid_addr`` and whose new ids go to ``out_addr``, on
    a card of ``sms`` SMs; raises when the node records alone exceed
    ROUTE_SMEM_BYTES, unless ``global_records`` (a deep level's plan: no
    shared memory, the node tables read from global memory)."""
    head = min(n_rows, (-nid_addr % 16) // 4)
    n_vec = (n_rows - head) // 4
    words = -(-(n_bins - 1) // 32)
    rec, bits = (0, 0) if global_records else \
        (8 * n_nodes, 4 * n_nodes * words)
    if rec > ROUTE_SMEM_BYTES:
        raise ValueError(f"tree_partition: {n_nodes} nodes' records exceed "
                         f"{ROUTE_SMEM_BYTES} B of shared memory")
    in_smem = not global_records and rec + bits <= ROUTE_SMEM_BYTES
    smem = rec + bits if in_smem else rec
    per_sm = max(1, min(ROUTE_BLOCKS_PER_SM,
                        kernels.SM_SMEM_BYTES // (smem + 1024)))
    blocks = max(1, min(-(-n_vec // ROUTE_THREADS), per_sm * sms))
    return RoutePlan(head, n_vec, n_rows - head - 4 * n_vec,
                     (out_addr - nid_addr) % 16 == 0, words, in_smem, smem,
                     blocks, not global_records)


def _partition(bins, nid, feat, thresh, na_left, split, cat_split, leftmask,
               n_bins, name):
    if not on_cuda(bins, name):
        return partition_plain(bins, nid, feat, thresh, na_left, split,
                               cat_split, leftmask, n_bins=n_bins)
    dev = bins.device
    N, F = bins.shape
    L = feat.shape[0]
    is8 = bin_dtype(bins)
    ptrs = [
        need(bins, bins.dtype, (N, F), "bins", dev),
        need(nid, torch.int32, (N,), "nid", dev),
    ]
    out = torch.empty(N, dtype=torch.int32, device=dev)
    tables = [
        need(feat, torch.int32, (L,), "feat", dev),
        need(thresh, torch.int32, (L,), "thresh", dev),
        need(na_left, torch.bool, (L,), "na_left", dev),
        need(split, torch.bool, (L,), "split", dev),
        need(cat_split, torch.bool, (L,), "cat_split", dev),
        need(leftmask, torch.bool, (L, n_bins - 1), "leftmask", dev),
    ]
    plan = route_plan(N, L, n_bins, ptrs[1], out.data_ptr(),
                      sms=sm_count(dev),
                      global_records=8 * L > ROUTE_SMEM_BYTES)
    rc = _lib().tree_partition(ptrs[0], is8, ptrs[1], out.data_ptr(),
                               *tables, N, F, n_bins, L, plan.head,
                               plan.n_vec, int(plan.vec_out), plan.blocks,
                               plan.smem, int(plan.bits_in_smem),
                               int(plan.recs_in_smem), stream(dev))
    launched(_lib(), rc, name)
    return out


# --------------------------------------------------------------- levels


def level_operands(col_mask, nb, is_cat, constraints, lo, hi, scalars,
                  device):
    """The per-level small operands in the kernels' types, on device."""
    def t(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype).reshape(-1)
        return torch.full((1,), x, dtype=dtype, device=device)

    knobs = torch.cat([t(scalars.min_rows, torch.float32),
                       t(scalars.reg_lambda, torch.float32),
                       t(scalars.msi, torch.float32)])
    dl = t(scalars.depth_limit if scalars.depth_limit is not None
           else 1 << 30, torch.int32)
    cm = col_mask if col_mask.dim() == 2 else col_mask[None, :]
    cm = cm.to(device=device, dtype=torch.int8).contiguous()
    nb = nb.to(device=device, dtype=torch.int32).contiguous()
    ic = None if is_cat is None else is_cat.to(device=device,
                                               dtype=torch.int8)
    cons = None if constraints is None else constraints.to(
        device=device, dtype=torch.int8)
    lo = lo.to(device=device, dtype=torch.float32).contiguous()
    hi = hi.to(device=device, dtype=torch.float32).contiguous()
    return cm, nb, ic, cons, lo, hi, knobs, dl


def _level(hist_fn, split_fn, part_fn, bins, nid, stats, prev_hist,
           col_mask, nb, is_cat, constraints, lo, hi, scalars, mesh, exps,
           *, d, n_nodes, n_bins):
    cm, nb, ic, cons, lo, hi, knobs, dl = level_operands(
        col_mask, nb, is_cat, constraints, lo, hi, scalars, bins.device)
    lh = hist_fn(bins, nid, stats, d=d, n_nodes_h=max(n_nodes // 2, 1),
                 n_bins=n_bins, exps=exps, mesh=mesh)
    hist, bg, bf, bt, bnal, blv, brv, lmask, split, cs = split_fn(
        lh, prev_hist, cm, nb, ic, cons, lo, hi, knobs, dl, d=d,
        n_nodes=n_nodes, n_bins=n_bins)
    new_nid = part_fn(bins, nid, bf, bt, bnal, split, cs, lmask,
                      n_bins=n_bins)
    return hist, bg, bf, bt, bnal, blv, brv, lmask, split, new_nid


def fused_level(bins, nid, stats, prev_hist, col_mask, nb, is_cat,
                constraints, lo, hi, scalars, *, d: int, n_nodes: int,
                n_bins: int, mesh=None, exps=None):
    """One tree level: returns (hist [L,F,B,3], gain, feat, thresh,
    na_left, left_val, right_val, leftmask, split, new_nid).

    ``stats`` is the level-invariant [N, 3] {w, w·g, w·h} block,
    ``prev_hist`` the previous level's histogram (None at the root), and
    ``split`` already folds in the min-split-improvement and depth-limit
    masks. CUDA inputs run the three kernels; CPU inputs their plain
    versions. On a sharded ``mesh`` the rows are this rank's: the
    histogram is ``shard_hist`` summed over the ranks, ``new_nid`` routes
    the rank's rows by ``shard_partition``, and every other output is the
    same on every rank. ``exps`` are the histogram's fixed-point
    exponents (``ops/fixed_point.exponents`` of ``stats``, the same on
    every rank), by default computed at each level. The reference's
    ``block_rows``/``interpret`` arguments have no counterpart."""
    hist_fn, part_fn = ((shard_hist, shard_partition) if is_sharded(mesh)
                        else (tree_hist, tree_partition))
    return _level(hist_fn, tree_split, part_fn, bins, nid, stats, prev_hist,
                  col_mask, nb, is_cat, constraints, lo, hi, scalars, mesh,
                  exps, d=d, n_nodes=n_nodes, n_bins=n_bins)


def plain_level(bins, nid, stats, prev_hist, col_mask, nb, is_cat,
                constraints, lo, hi, scalars, *, d: int, n_nodes: int,
                n_bins: int, mesh=None, exps=None):
    """``fused_level`` through the plain versions on any device — the
    reference the kernels are held against on the card (the counterpart
    of the reference package's ``xla_level``)."""
    return _level(hist_plain, split_plain, partition_plain, bins, nid,
                  stats, prev_hist, col_mask, nb, is_cat, constraints, lo,
                  hi, scalars, mesh, exps, d=d, n_nodes=n_nodes,
                  n_bins=n_bins)


# ------------------------------------------------------------ model axis


def hist_models_plain(bins, nid, stats, *, d: int, n_nodes_h: int,
                      n_bins: int, exps=None):
    """Plain version of ``tree_hist_models``: ``hist_plain`` of each
    model's node ids ``nid[m]`` and stats ``stats[m]``, stacked
    [M, Lh, F, B, 3] (``exps`` is the kernel's and unused here)."""
    return torch.stack([hist_plain(bins, nid[m], stats[m], d=d,
                                   n_nodes_h=n_nodes_h, n_bins=n_bins)
                        for m in range(nid.shape[0])])


def tree_hist_models(bins, nid, stats, *, d: int, n_nodes_h: int,
                     n_bins: int, exps=None):
    """[M, Lh, F, B, 3] level histograms of M models in one launch:
    ``bins`` [N, F] shared, ``nid`` [M, N] int32, ``stats`` [M, N, 3]
    and ``exps`` int32 [M, 3] (by default each model's ``exponents``).
    Model m's histogram is ``tree_hist(bins, nid[m], stats[m],
    exps=exps[m])``, bit for bit. The slab is planned for one model's
    rows on a 1/M share of the SMs."""
    if not on_cuda(bins, "tree_hist_models"):
        return hist_models_plain(bins, nid, stats, d=d, n_nodes_h=n_nodes_h,
                                 n_bins=n_bins)
    dev = bins.device
    N, F = bins.shape
    M = nid.shape[0]
    B, Lh = n_bins, n_nodes_h
    is8 = bin_dtype(bins)
    p_bins = need(bins, bins.dtype, (N, F), "bins", dev)
    p_nid = need(nid, torch.int32, (M, N), "nid", dev)
    p_stats = need(stats, torch.float32, (M, N, 3), "stats", dev)
    if exps is None:
        exps = torch.stack([exponents(stats[m]) for m in range(M)])
    p_exps = need(exps, torch.int32, (M, 3), "exps", dev)
    cells = Lh * F * B * 3
    sms = max(1, sm_count(dev) // M)
    plan = None if Lh > kernels.SLAB_MAX_NODES else slab_geometry(
        N, F, Lh, B, sms=sms, budget=HIST_SLAB_BYTES)
    if plan is None or (not plan.listed
                        and plan.n_chunks > kernels.SLAB_LIST_CHUNKS):
        # the deep levels: tree_hist's global-atomic route, a wave a model
        acc = torch.zeros(M * cells, dtype=torch.int64, device=dev)
        out = torch.zeros(M * cells, dtype=torch.float32, device=dev)
        rc = _lib().tree_hist_global_models(
            p_bins, is8, p_nid, p_stats, p_exps, acc.data_ptr(),
            out.data_ptr(), N, F, B, Lh, int(d > 0),
            max(1, min(-(-N // 256), 8 * sms)), M, stream(dev))
    else:
        acc, out = slab_buffers(M * cells, dev)
        keys, rows = scratch(plan, M * N, dev)
        rc = _lib().tree_hist_models(
            p_bins, is8, p_nid, p_stats, p_exps, ptr(keys), ptr(rows),
            acc.data_ptr(), out.data_ptr(), N, F, B, Lh, int(d > 0),
            plan.rows_per_block, plan.n_chunks, plan.n_groups,
            plan.replicas, plan.threads, plan.smem, M, stream(dev))
    launched(_lib(), rc, "tree_hist_models")
    return out.view(M, Lh, F, B, 3)


def split_models_plain(lh, prev, col_mask, nb, is_cat, constraints, lo, hi,
                       knobs, depth_limit, *, d: int, n_nodes: int,
                       n_bins: int):
    """Plain version of ``tree_split_models``: ``split_plain`` of each
    model, its outputs stacked along a leading model axis."""
    outs = [split_plain(lh[m], None if prev is None else prev[m],
                        col_mask[m], nb, is_cat, constraints, lo[m], hi[m],
                        knobs[m], depth_limit[m:m + 1], d=d,
                        n_nodes=n_nodes, n_bins=n_bins)
            for m in range(lh.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def tree_split_models(lh, prev, col_mask, nb, is_cat, constraints, lo, hi,
                      knobs, depth_limit, *, d: int, n_nodes: int,
                      n_bins: int):
    """``tree_split`` of M models in one launch: ``lh`` [M, Lh, F, B, 3],
    ``prev`` [M, Lh, F, B, 3] (None at d=0), ``col_mask`` int8
    [M, 1|L, F], ``lo``/``hi`` float32 [M, 1|L], ``knobs`` float32 [M, 3]
    and ``depth_limit`` int32 [M] per model; ``nb``, ``is_cat`` and
    ``constraints`` shared. Returns ``tree_split``'s ten outputs, each
    with a leading model axis; model m's are its own launch's bits."""
    if not on_cuda(lh, "tree_split_models"):
        return split_models_plain(lh, prev, col_mask, nb, is_cat,
                                  constraints, lo, hi, knobs, depth_limit,
                                  d=d, n_nodes=n_nodes, n_bins=n_bins)
    dev = lh.device
    L, B = n_nodes, n_bins
    M, Lh, F = lh.shape[0], lh.shape[1], lh.shape[2]
    if d > 0 and prev is None:
        raise ValueError("tree_split_models: d > 0 needs the previous "
                         "histograms")
    cm_rows, bound_rows = col_mask.shape[1], lo.shape[1]
    if cm_rows not in (1, L) or bound_rows not in (1, L):
        raise ValueError("tree_split_models: col_mask and lo/hi take 1 or "
                         "L rows a model")
    ptrs = [
        need(lh, torch.float32, (M, Lh, F, B, 3), "lh", dev),
        need(prev if d > 0 else None, torch.float32, (M, Lh, F, B, 3),
             "prev", dev),
        need(col_mask, torch.int8, (M, cm_rows, F), "col_mask", dev),
        need(nb, torch.int32, (F,), "nb", dev),
        need(is_cat, torch.int8, (F,), "is_cat", dev),
        need(constraints, torch.int8, (F,), "constraints", dev),
        need(lo, torch.float32, (M, bound_rows), "lo", dev),
        need(hi, torch.float32, (M, bound_rows), "hi", dev),
        need(knobs, torch.float32, (M, 3), "knobs", dev),
        need(depth_limit, torch.int32, (M,), "depth_limit", dev),
    ]
    plan = split_plan(B)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    outs = (torch.empty((M, L, F, B, 3), **f32), torch.empty((M, L), **f32),
            torch.empty((M, L), **i32), torch.empty((M, L), **i32),
            torch.empty((M, L), **b8), torch.empty((M, L), **f32),
            torch.empty((M, L), **f32), torch.empty((M, L, B - 1), **b8),
            torch.empty((M, L), **b8), torch.empty((M, L), **b8))
    strm = stream(dev)
    scr = split_scratch(M * L, M * L * F, plan.words, dev, strm)
    rc = _lib().tree_split_models(
        *ptrs, *(o.data_ptr() for o in outs), scr[1].data_ptr(),
        scr[2].data_ptr(), scr[0].data_ptr(), d, L, F, B, cm_rows,
        bound_rows, plan.threads, plan.per, plan.n_sort, plan.smem, M, strm)
    launched(_lib(), rc, "tree_split_models")
    return outs


def partition_models_plain(bins, nid, feat, thresh, na_left, split,
                           cat_split, leftmask, *, n_bins: int):
    """Plain version of ``tree_partition_models``: ``partition_plain``
    of each model, stacked [M, N]."""
    return torch.stack([partition_plain(bins, nid[m], feat[m], thresh[m],
                                        na_left[m], split[m], cat_split[m],
                                        leftmask[m], n_bins=n_bins)
                        for m in range(nid.shape[0])])


def tree_partition_models(bins, nid, feat, thresh, na_left, split,
                          cat_split, leftmask, *, n_bins: int):
    """Routed node ids [M, N] int32 of M models in one launch: ``nid``
    [M, N], the decisions [M, L] and ``leftmask`` [M, L, B-1]; ``bins``
    shared. Model m's row is ``tree_partition`` of its own, bit for
    bit."""
    if not on_cuda(bins, "tree_partition_models"):
        return partition_models_plain(bins, nid, feat, thresh, na_left,
                                      split, cat_split, leftmask,
                                      n_bins=n_bins)
    dev = bins.device
    N, F = bins.shape
    M, L = feat.shape
    is8 = bin_dtype(bins)
    p_bins = need(bins, bins.dtype, (N, F), "bins", dev)
    p_nid = need(nid, torch.int32, (M, N), "nid", dev)
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    tables = [
        need(feat, torch.int32, (M, L), "feat", dev),
        need(thresh, torch.int32, (M, L), "thresh", dev),
        need(na_left, torch.bool, (M, L), "na_left", dev),
        need(split, torch.bool, (M, L), "split", dev),
        need(cat_split, torch.bool, (M, L), "cat_split", dev),
        need(leftmask, torch.bool, (M, L, n_bins - 1), "leftmask", dev),
    ]
    plan = route_plan(N, L, n_bins, p_nid, out.data_ptr(),
                      sms=max(1, sm_count(dev) // M),
                      global_records=8 * L > ROUTE_SMEM_BYTES)
    rc = _lib().tree_partition_models(
        p_bins, is8, p_nid, out.data_ptr(), *tables, N, F, n_bins, L,
        plan.head, plan.n_vec, int(plan.vec_out), plan.blocks, plan.smem,
        int(plan.bits_in_smem), int(plan.recs_in_smem), M, stream(dev))
    launched(_lib(), rc, "tree_partition_models")
    return out


def models_operands(col_mask, nb, is_cat, constraints, lo, hi, knobs,
                    depth_limit, device):
    """The model axis's small operands in the kernels' types on
    ``device``: ``col_mask`` [M, F] or [M, L, F] → int8 [M, 1|L, F];
    ``lo``/``hi`` [M, 1|L] float32; ``knobs`` [M, 3] float32;
    ``depth_limit`` [M] int32."""
    cm = col_mask if col_mask.dim() == 3 else col_mask[:, None, :]
    cm = cm.to(device=device, dtype=torch.int8).contiguous()
    nb = nb.to(device=device, dtype=torch.int32).contiguous()
    ic = None if is_cat is None else is_cat.to(device=device,
                                               dtype=torch.int8)
    cons = None if constraints is None else constraints.to(
        device=device, dtype=torch.int8)
    f32 = dict(device=device, dtype=torch.float32)
    return (cm, nb, ic, cons, lo.to(**f32).contiguous(),
            hi.to(**f32).contiguous(), knobs.to(**f32).contiguous(),
            depth_limit.to(device=device, dtype=torch.int32).contiguous())


def _level_models(hist_fn, split_fn, part_fn, bins, nid, stats, prev_hist,
                  col_mask, nb, is_cat, constraints, lo, hi, knobs,
                  depth_limit, exps, *, d, n_nodes, n_bins):
    ops = models_operands(col_mask, nb, is_cat, constraints, lo, hi, knobs,
                          depth_limit, bins.device)
    lh = hist_fn(bins, nid, stats, d=d, n_nodes_h=max(n_nodes // 2, 1),
                 n_bins=n_bins, exps=exps)
    hist, bg, bf, bt, bnal, blv, brv, lmask, split, cs = split_fn(
        lh, prev_hist, *ops, d=d, n_nodes=n_nodes, n_bins=n_bins)
    new_nid = part_fn(bins, nid, bf, bt, bnal, split, cs, lmask,
                      n_bins=n_bins)
    return hist, bg, bf, bt, bnal, blv, brv, lmask, split, new_nid


def fused_level_models(bins, nid, stats, prev_hist, col_mask, nb, is_cat,
                       constraints, lo, hi, knobs, depth_limit, *, d: int,
                       n_nodes: int, n_bins: int, exps=None):
    """One tree level of M models (``fused_level`` with a leading model
    axis on every per-model input and output): ``nid`` [M, N], ``stats``
    [M, N, 3], ``prev_hist`` [M, Lh, F, B, 3], ``col_mask`` [M, F] or
    [M, L, F], ``lo``/``hi`` [M, 1|L], ``knobs`` [M, 3] (min_rows,
    reg_lambda, min_split_improvement), ``depth_limit`` [M], ``exps``
    [M, 3]. CUDA inputs run the three model-axis kernels, CPU inputs
    their plain versions."""
    return _level_models(tree_hist_models, tree_split_models,
                         tree_partition_models, bins, nid, stats, prev_hist,
                         col_mask, nb, is_cat, constraints, lo, hi, knobs,
                         depth_limit, exps, d=d, n_nodes=n_nodes,
                         n_bins=n_bins)


def plain_level_models(bins, nid, stats, prev_hist, col_mask, nb, is_cat,
                       constraints, lo, hi, knobs, depth_limit, *, d: int,
                       n_nodes: int, n_bins: int, exps=None):
    """``fused_level_models`` through the plain versions on any device."""
    return _level_models(hist_models_plain, split_models_plain,
                         partition_models_plain, bins, nid, stats,
                         prev_hist, col_mask, nb, is_cat, constraints, lo,
                         hi, knobs, depth_limit, exps, d=d,
                         n_nodes=n_nodes, n_bins=n_bins)
