"""Isolation Forest: anomaly detection by random isolation trees.

Reference: h2o3_tpu/models/isofor.py (hex/tree/isofor/IsolationForest.java).
A tree has the complete-binary layout of models/tree.py, but its splits
are random: at each node a feature ~ U[F], a bin threshold ~ U over the
feature's real bins and an NA direction ~ Bernoulli(0.5). A node splits
while its bagged row count exceeds 1. A row's path length is the number
of splitting levels it passes plus c(n) of its leaf's count (Liu et al.);
scores normalise the total path length by the training minimum and
maximum (IsolationForestModel.normalizePathLength).

Growth is two functions: ``draw_tree`` draws a tree's random decisions
from a ``torch.Generator``, and ``grow_isolation_tree`` grows the tree
from given decisions, so a test can feed in the reference's draws. A
level is a ``segment_sum`` of the bag weights per node (64-bit fixed
point on the card) and one ``tree_partition`` launch: the reference's
routing is ``partition_plain``'s rule with no categorical subset split.
Scoring routes the same way and adds ``is_split`` along the path. The
draws differ from the reference's ``jax.random`` bits, so fits compare
by their statistics.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.binning import (BinnedMatrix, bin_frame,
                                          rebin_for_scoring)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.distribution import log_f32
from h2o3_tpu_torch.models.gbm import tree_generator
from h2o3_tpu_torch.models.model import Model, ModelBuilder, require_local
from h2o3_tpu_torch.models.tree import Tree, stack_trees, zero_catsplit
from h2o3_tpu_torch.ops.fixed_point import exponents
from h2o3_tpu_torch.ops.kernels.treekernel import tree_partition
from h2o3_tpu_torch.ops.segments import segment_sum
from h2o3_tpu_torch.parallel.device import fetch

ANOMALY = "AnomalyDetection"


def avg_path_correction(n: torch.Tensor) -> torch.Tensor:
    """c(n): the expected remaining path length in an unresolved sample
    of n rows, in float32 as the reference computes it (``log_f32`` is
    its float32 log bit for bit)."""
    n = n.to(torch.float32)
    h = log_f32(torch.clamp_min(n - 1.0, 1.0)) + 0.5772156649
    c = 2.0 * h - 2.0 * (n - 1.0) / torch.clamp_min(n, 1.0)
    return torch.where(n > 2.0, c, torch.where(n == 2.0, 1.0, 0.0))


def node_counts(nid, w, n_nodes: int, e):
    """Bag weight per node [n_nodes] (fixed point on the card, with the
    tree's exponents ``e``)."""
    return segment_sum(nid, w[:, None], n_nodes=n_nodes, e=e)[:, 0]


def draw_tree(gen: torch.Generator, nb: torch.Tensor, depth: int,
              device) -> Dict[str, torch.Tensor]:
    """A tree's random decisions, [depth, Lmax] each: ``feat`` ~ U[F],
    ``thresh`` uniform over the feature's real bins [0, nb[f] - 2] (as
    the reference draws it: u·max(nb[f] - 1, 1) truncated) and
    ``na_left`` ~ Bernoulli(0.5); slots past 2^d of level d are 0."""
    F = nb.shape[0]
    Lmax = 2 ** (depth - 1) if depth > 0 else 1
    shape = (depth, Lmax)
    f = torch.randint(0, F, shape, generator=gen, device=device,
                      dtype=torch.int64)
    u = torch.rand(shape, generator=gen, device=device)
    nal = torch.rand(shape, generator=gen, device=device) < 0.5
    live = (torch.arange(Lmax, device=device)[None, :]
            < (2 ** torch.arange(depth, device=device))[:, None])
    span = torch.clamp_min(nb[f] - 1, 1).to(torch.float32)
    t = (u * span).to(torch.int32)
    return {"feat": torch.where(live, f, 0).to(torch.int32),
            "thresh": torch.where(live, t, 0),
            "na_left": nal & live}


def grow_isolation_tree(bins, w, feat, thresh, na_left, *, B: int) -> Tree:
    """One isolation tree from given decisions ([D, Lmax] each): a node
    splits while its bag weight ``w`` exceeds 1; rows route by
    ``tree_partition``. The Tree keeps ``feat`` and ``na_left`` at every
    node and ``thresh`` where the node splits (B elsewhere), as the
    reference's does."""
    D, Lmax = feat.shape
    dev = bins.device
    nid = torch.zeros((bins.shape[0],), dtype=torch.int32, device=dev)
    e = exponents(w[:, None]) if w.is_cuda else None
    threshs = torch.full((D, Lmax), B, dtype=torch.int32, device=dev)
    is_splits = torch.zeros((D, Lmax), dtype=torch.bool, device=dev)
    for d in range(D):
        L = 2 ** d
        split = node_counts(nid, w, L, e) > 1.0
        t = torch.where(split, thresh[d, :L], B)
        threshs[d, :L] = t
        is_splits[d, :L] = split
        nid = tree_partition(
            bins, nid, feat[d, :L], t, na_left[d, :L], split,
            torch.zeros(L, dtype=torch.bool, device=dev),
            torch.zeros((L, B - 1), dtype=torch.bool, device=dev), n_bins=B)
    leaf_cnt = node_counts(nid, w, 2 ** D, e)
    return Tree(feat, threshs, na_left, is_splits,
                avg_path_correction(leaf_cnt), leaf_cnt,
                *zero_catsplit(D, Lmax, dev))


def tree_path_length(tree: Tree, bins, B: int) -> torch.Tensor:
    """Per-row isolation path length through one tree, float32 [N]."""
    D, L = tree.feat.shape
    dev = bins.device
    nid = torch.zeros((bins.shape[0],), dtype=torch.int32, device=dev)
    plen = torch.zeros((bins.shape[0],), dtype=torch.float32, device=dev)
    no_cat = zero_catsplit(D, L, dev)[0]
    for d in range(D):
        Ld = 2 ** d
        plen = plen + tree.is_split[d].index_select(0, nid.long()).to(
            torch.float32)
        nid = tree_partition(
            bins, nid, tree.feat[d, :Ld], tree.thresh[d, :Ld],
            tree.na_left[d, :Ld], tree.is_split[d, :Ld], no_cat[d, :Ld],
            torch.zeros((Ld, B - 1), dtype=torch.bool, device=dev),
            n_bins=B)
    return plen + tree.leaf.index_select(0, nid.long())


def forest_mean_length(forest: Tree, bins, B: int) -> torch.Tensor:
    """Mean path length over the trees, float32 [N] (summed in tree
    order, then divided by T)."""
    tot = torch.zeros((bins.shape[0],), dtype=torch.float32,
                      device=bins.device)
    T = forest.feat.shape[0]
    for t in range(T):
        tot = tot + tree_path_length(Tree(*(a[t] for a in forest)), bins, B)
    return tot / T


class IsolationForestModel(Model):
    algo = "isolationforest"

    def __init__(self, params, output, forest: Tree, bm: BinnedMatrix,
                 c_norm: float):
        super().__init__(params, output)
        self.forest = forest
        self.bm = bm
        self.c_norm = c_norm       # c(sample_size): the paper's normaliser

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        require_local(frame, self.algo)
        bm = rebin_for_scoring(self.bm, frame)
        ml = fetch(forest_mean_length(self.forest, bm.bins,
                                      self.bm.nbins_total))[:frame.nrows]
        mn = self.output.get("min_path_length")
        mx = self.output.get("max_path_length")
        if mn is not None and mx is not None and mx > mn:
            # (max - total) / (max - min): normalizePathLength
            score = (mx - ml * self.forest.feat.shape[0]) / (mx - mn)
        else:
            # the paper's 2^(-l / c(sample_size))
            score = 2.0 ** (-ml / max(self.c_norm, 1e-12))
        return {"predict": score, "mean_length": ml}

    def model_performance(self, frame: Frame, mask_weights=None):
        raw = self._score_raw(frame)
        return {"mean_score": float(raw["predict"].mean()),
                "mean_length": float(raw["mean_length"].mean())}


class IsolationForestEstimator(ModelBuilder):
    """h2o-py H2OIsolationForestEstimator surface. ``mtries`` and
    ``contamination`` are accepted and inert: the reference's fit reads
    neither."""

    algo = "isolationforest"
    label = "IsolationForest"

    DEFAULTS = dict(
        ntrees=50, sample_size=256, sample_rate=-1.0, max_depth=8,
        mtries=-1, nbins=64, nbins_cats=64, seed=-1,
        ignored_columns=None, contamination=-1.0,
    )
    PORTED = frozenset(DEFAULTS)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None):
        p = self.params
        dev = frame.device
        bm = bin_frame(frame, x, nbins=p["nbins"], nbins_cats=p["nbins_cats"],
                       histogram_type="uniform")
        w = frame.valid_weights()
        n = frame.nrows
        rate = float(p["sample_rate"])
        psi = int(p["sample_size"])
        if rate > 0:
            psi = max(2, int(rate * n))
        bag_rate = min(1.0, psi / max(n, 1))
        depth = int(p["max_depth"])
        seed = int(p["seed"]) if int(p["seed"]) >= 0 else 0x150F
        ntrees = int(p["ntrees"])
        B = bm.nbins_total
        trees = []
        for t in range(ntrees):
            gen = tree_generator(seed, t, dev)
            keep = torch.rand(w.shape[0], generator=gen, device=dev) \
                < bag_rate
            dr = draw_tree(gen, bm.nbins, depth, dev)
            trees.append(grow_isolation_tree(
                bm.bins, w * keep.to(torch.float32), dr["feat"],
                dr["thresh"], dr["na_left"], B=B))
        forest = stack_trees(trees)
        c_norm = float(avg_path_correction(torch.tensor([float(psi)]))[0])
        # the training total path lengths (summed over the trees) give the
        # score bounds (IsolationForest.java:238) and the training metrics
        ml = fetch(forest_mean_length(forest, bm.bins, B))[:n]
        tot = ml * ntrees
        output = {"category": ANOMALY, "response": None, "names": list(x),
                  "domain": None,
                  "min_path_length": int(np.floor(tot.min())) if n else 0,
                  "max_path_length": int(np.ceil(tot.max())) if n else 0}
        model = IsolationForestModel(p, output, forest, bm, c_norm)
        # from the totals, in the reference's float32 operations
        ml = tot / max(ntrees, 1)
        mn, mx = output["min_path_length"], output["max_path_length"]
        score = ((mx - tot) / (mx - mn)) if mx > mn \
            else 2.0 ** (-ml / max(c_norm, 1e-12))
        model.training_metrics = {
            "mean_score": float(np.mean(score)) if n else 0.0,
            "mean_length": float(np.mean(ml)) if n else 0.0}
        return model
