"""Shared tree machinery — level-wise histogram tree growing.

Reference: h2o3_tpu/models/tree.py. Trees are COMPLETE binary trees of
static depth D: level d has 2^d node slots (empty nodes have zero
histograms and never split). Per level: histogram → split scan → row
routing (one ``fused_level``: three CUDA kernels on the card, their
plain versions on the CPU), then the leaves get Newton values. No host
round trips inside a tree on one device; on a sharded mesh over gloo,
each level's all-reduce waits on the host. On the card every sum of a
tree is 64-bit fixed point (``ops/fixed_point.py``), so a fit gives the
same bits on every run.

Forests are laid out at ``bucket_depth(max_depth)`` with the actual depth
as a traced limit that masks deeper splits, exactly as the reference
lays them out, so the two packages' forests compare array for array.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from h2o3_tpu_torch.ops.fixed_point import exponents
from h2o3_tpu_torch.ops.kernels.treekernel import fused_level
from h2o3_tpu_torch.ops.segments import segment_sum


class TreeScalars(NamedTuple):
    """Per-fit training knobs as 0-d device tensors (the level kernels
    read them from device memory, so no host sync): min_rows,
    reg_lambda, min_split_improvement and the actual depth limit."""
    min_rows: torch.Tensor
    reg_lambda: torch.Tensor
    msi: torch.Tensor
    depth_limit: Optional[torch.Tensor] = None


def scalars_of(params: "TreeParams", device,
               depth_limit: Optional[int] = None) -> TreeScalars:
    f32 = dict(dtype=torch.float32, device=device)
    dl = params.max_depth if depth_limit is None else depth_limit
    return TreeScalars(torch.tensor(params.min_rows, **f32),
                       torch.tensor(params.reg_lambda, **f32),
                       torch.tensor(params.min_split_improvement, **f32),
                       torch.tensor(dl, dtype=torch.int32, device=device))


# static depth buckets: a tree is laid out at its bucket depth and
# levels past the actual depth never split (reference DEPTH_BUCKETS)
DEPTH_BUCKETS = (6, 10, 14)


def bucket_depth(d: int) -> int:
    for b in DEPTH_BUCKETS:
        if d <= b:
            return b
    return d


class Tree(NamedTuple):
    """One complete tree; arrays padded to Lmax = 2^(D-1) internal slots
    (or stacked [T, ...] for a forest)."""
    feat: torch.Tensor        # [D, Lmax] int32 split feature
    thresh: torch.Tensor      # [D, Lmax] int32 split bin (left if bin <= t)
    na_left: torch.Tensor     # [D, Lmax] bool
    is_split: torch.Tensor    # [D, Lmax] bool
    leaf: torch.Tensor        # [2^D] float32 leaf values
    leaf_w: torch.Tensor      # [2^D] float32 training row weight per leaf
    cat_split: torch.Tensor   # [D, Lmax] bool — category SUBSET split
    left_words: torch.Tensor  # [D, Lmax, W] int32 bit pattern of the
    #                           reference's uint32 words: bit b of word k
    #                           set ⇔ bin 32k+b goes LEFT


def zero_catsplit(D: int, Lmax: int, device):
    """(cat_split, left_words) placeholders for builders that never make
    categorical subset splits (uplift)."""
    return (torch.zeros((D, Lmax), dtype=torch.bool, device=device),
            torch.zeros((D, Lmax, 1), dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class TreeParams:
    max_depth: int = 5
    min_rows: float = 10.0
    learn_rate: float = 0.1
    reg_lambda: float = 1.0
    min_split_improvement: float = 1e-5
    col_sample_rate: float = 1.0
    nbins_total: int = 65            # B incl. NA bin
    cat_feats: tuple = ()            # per-feature is-categorical flags

    @property
    def has_cats(self) -> bool:
        return any(self.cat_feats)


def _pack_leftmask(leftmask: torch.Tensor, W: int) -> torch.Tensor:
    """[L, B-1] bool → [L, W] int32 words (bit b of word k ⇔ bin 32k+b),
    the reference's uint32 bit pattern."""
    Bm1 = leftmask.shape[1]
    bpos = torch.arange(Bm1, device=leftmask.device)
    contrib = leftmask.to(torch.int64) << (bpos % 32)[None, :]
    seg = (bpos // 32)[:, None] == torch.arange(W, device=leftmask.device)
    words = (contrib[:, :, None] * seg[None].to(torch.int64)).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def row_feature_values(bins: torch.Tensor, f_r: torch.Tensor) -> torch.Tensor:
    """``bins[i, f_r[i]]`` as int32 [N] (a gather; the reference spells it
    as a masked feature sum, which is cheaper than a gather on the TPU)."""
    return bins.gather(1, f_r.long()[:, None])[:, 0].to(torch.int32)


def _mtries_mask(gen: torch.Generator, L: int, F: int, mtries: int,
                 device) -> torch.Tensor:
    """Exactly-``mtries``-per-node column mask [L, F] — the reference DRF
    per-split column subsample: each node keeps the columns of its
    ``mtries`` smallest uniform draws from ``gen``."""
    u = torch.rand((L, F), generator=gen, device=device)
    rank = torch.argsort(torch.argsort(u, dim=1, stable=True), dim=1,
                         stable=True)
    return rank < mtries


def _level_goleft(feat_d, thresh_d, nal_d, isp_d, cat_d, lw_d, nid, bins,
                  B: int):
    """Row routing for one tree level — shared by scoring and leaf
    assignment. Numeric splits compare bin <= t; categorical subset
    splits test the row's bin bit in the node's packed left-set."""
    n = nid.long()
    b_r = row_feature_values(bins, feat_d[n])
    isna = b_r == (B - 1)
    go_num = b_r <= thresh_d[n]
    W = lw_d.shape[1]
    widx = (b_r >> 5).clamp(0, W - 1).long()
    word = lw_d[n, widx]
    inset = ((word >> (b_r & 31)) & 1) == 1
    go_split = torch.where(cat_d[n], inset, go_num)
    goleft = torch.where(isp_d[n], torch.where(isna, nal_d[n], go_split),
                         True)
    return (2 * nid + torch.where(goleft, 0, 1)).to(torch.int32)


def grow_tree(bins, nb, w, g, h, col_mask, *, params: TreeParams,
              scalars: TreeScalars, mtries: int = 0,
              generator: Optional[torch.Generator] = None,
              constraints=None, interaction_sets=None,
              level_fn=fused_level, mesh=None):
    """Grow one tree; returns (Tree, final_leaf_id_per_row, gain_by_feat).

    bins [Npad, F] int8/int32; w zero on padding rows; col_mask [F] bool
    (per-tree column sampling). ``0 < mtries < F`` additionally samples
    exactly ``mtries`` columns per NODE per level (DRF semantics), drawn
    from ``generator``: the level's column mask becomes an [L, F] mask.
    ``constraints`` [F] in {-1,0,+1} activates monotone constraints
    (per-node value bounds propagate to children through the split
    midpoint; leaves are clipped into them). ``interaction_sets`` [S, F]
    bool activates interaction constraints (a node's subtree may only use
    features sharing a set with every feature on its path).
    ``level_fn`` is ``fused_level`` (kernels on CUDA tensors) or
    ``plain_level`` (the plain versions, for holding one against the
    other). On a sharded ``mesh`` the rows are this rank's: each level's
    histogram and the leaf sums are summed over the ranks, so every rank
    makes the same decisions and gets the same Tree; the returned leaf
    ids are its own rows'.
    """
    D = params.max_depth
    sc = scalars
    B = params.nbins_total
    N, F = bins.shape
    dev = bins.device
    Lmax = 2 ** (D - 1) if D > 0 else 1
    nid = torch.zeros((N,), dtype=torch.int32, device=dev)

    feats = torch.zeros((D, Lmax), dtype=torch.int32, device=dev)
    threshs = torch.full((D, Lmax), B, dtype=torch.int32, device=dev)
    na_lefts = torch.zeros((D, Lmax), dtype=torch.bool, device=dev)
    is_splits = torch.zeros((D, Lmax), dtype=torch.bool, device=dev)
    feat_ids = torch.arange(F, dtype=torch.int32, device=dev)
    is_cat = None
    if params.has_cats:
        # built from scalar compares: copying a host list to the card
        # would synchronise the stream once per tree
        is_cat = torch.zeros(F, dtype=torch.bool, device=dev)
        for j, c in enumerate(params.cat_feats):
            if c:
                is_cat |= feat_ids == j
    W = max(1, (B - 1 + 31) // 32) if params.has_cats else 1
    cat_splits = torch.zeros((D, Lmax), dtype=torch.bool, device=dev)
    left_words = torch.zeros((D, Lmax, W), dtype=torch.int32, device=dev)
    gain_by_feat = torch.zeros((F,), dtype=torch.float32, device=dev)
    lo = torch.full((1,), -torch.inf, dtype=torch.float32, device=dev)
    hi = torch.full((1,), torch.inf, dtype=torch.float32, device=dev)
    allowed = torch.ones((1, F), dtype=torch.bool, device=dev)
    pair_allow = None

    # the {w, w·g, w·h} block is level-invariant: built once per tree,
    # with (on the card) its fixed-point exponents, the same for every
    # level's histogram and the leaf sums, over every rank's rows
    stats3 = torch.stack([w, w * g, w * h], dim=1).to(torch.float32)
    exps = exponents(stats3, mesh=mesh) if stats3.is_cuda else None
    prev_hist = None
    for d in range(D):
        L = 2 ** d
        cm = col_mask
        if 0 < mtries < F:
            cm = _mtries_mask(generator, L, F, mtries, dev) & col_mask[None, :]
        if interaction_sets is not None:
            cm = (cm if cm.dim() == 2 else cm[None, :]) & allowed
        (hist, bg, bf, bt, bnal, blv, brv, leftmask, split,
         nid_next) = level_fn(
            bins, nid, stats3, prev_hist, cm, nb, is_cat, constraints, lo,
            hi, sc, d=d, n_nodes=L, n_bins=B, mesh=mesh, exps=exps)
        prev_hist = hist
        feats[d, :L] = torch.where(split, bf, 0)
        threshs[d, :L] = torch.where(split, bt, B)
        na_lefts[d, :L] = split & bnal
        is_splits[d, :L] = split
        if is_cat is not None:
            cs = is_cat[bf.long()] & split
            cat_splits[d, :L] = cs
            words = _pack_leftmask(leftmask, W)
            left_words[d, :L] = torch.where(cs[:, None], words, 0)
        gain_by_feat = gain_by_feat + torch.sum(
            torch.where(split, torch.clamp_min(bg, 0.0), 0.0)[:, None]
            * (bf[:, None] == feat_ids[None, :]), dim=0)

        # interaction-set propagation: children may use any feature
        # sharing a set with the split feature, within the path's allowance
        if interaction_sets is not None:
            if pair_allow is None:
                s = interaction_sets.to(torch.float32)
                pair_allow = torch.einsum("sf,sg->fg", s, s) > 0
            child_allow = pair_allow[bf.long()]                 # [L, F]
            child_allow = allowed & torch.where(split[:, None], child_allow,
                                                True)
            allowed = torch.repeat_interleave(child_allow, 2, dim=0)

        # bound propagation: on a constrained split the midpoint of the
        # child values caps the low side / high side
        if constraints is not None:
            c_split = constraints[bf.long()].to(torch.float32) * split
            mid = 0.5 * (blv + brv)
            hi_l = torch.where(c_split > 0, torch.minimum(hi, mid), hi)
            lo_l = torch.where(c_split < 0, torch.maximum(lo, mid), lo)
            lo_r = torch.where(c_split > 0, torch.maximum(lo, mid), lo)
            hi_r = torch.where(c_split < 0, torch.minimum(hi, mid), hi)
            lo = torch.stack([lo_l, lo_r], dim=1).reshape(-1)
            hi = torch.stack([hi_l, hi_r], dim=1).reshape(-1)
        nid = nid_next

    # leaf Newton values from the final assignment (GammaPass analogue)
    nleaf = 2 ** D
    leaf_stats = segment_sum(nid, stats3, n_nodes=nleaf, mesh=mesh, e=exps)
    G, H = leaf_stats[:, 1], leaf_stats[:, 2]
    leaf = torch.where(leaf_stats[:, 0] > 0,
                       -G / (H + sc.reg_lambda + 1e-10), 0.0)
    if constraints is not None:
        leaf = torch.minimum(hi, torch.maximum(lo, leaf))
    tree = Tree(feats, threshs, na_lefts, is_splits, leaf,
                leaf_stats[:, 0], cat_splits, left_words)
    return tree, nid, gain_by_feat


def _route(tree: Tree, bins, B: int):
    """Terminal node id per row for one tree."""
    nid = torch.zeros((bins.shape[0],), dtype=torch.int32,
                      device=bins.device)
    for d in range(tree.feat.shape[0]):
        nid = _level_goleft(tree.feat[d], tree.thresh[d], tree.na_left[d],
                            tree.is_split[d], tree.cat_split[d],
                            tree.left_words[d], nid, bins, B)
    return nid


def predict_tree(tree: Tree, bins, B: int):
    """Route binned rows through one tree → leaf values [N]."""
    return tree.leaf[_route(tree, bins, B).long()]


def stack_trees(trees) -> Tree:
    """Stack per-iteration Trees into [T, ...] arrays."""
    return Tree(*(torch.stack([getattr(t, f) for t in trees])
                  for f in Tree._fields))


def concat_forests(chunks) -> Tree:
    """Concatenate [T_i, ...] forest chunks along the tree axis."""
    chunks = list(chunks)
    if len(chunks) == 1:
        return chunks[0]
    return Tree(*(torch.cat([getattr(c, f) for c in chunks])
                  for f in Tree._fields))


def predict_forest(stacked: Tree, bins, B: int):
    """Sum of all trees' outputs, added in tree order."""
    total = torch.zeros((bins.shape[0],), dtype=torch.float32,
                        device=bins.device)
    for t in range(stacked.feat.shape[0]):
        total = total + predict_tree(Tree(*(a[t] for a in stacked)), bins, B)
    return total
