"""Extended Isolation Forest: isolation trees on random hyperplanes.

Reference: h2o3_tpu/models/extisofor.py (hex/tree/isoforextended/). As
Isolation Forest, but a node splits rows on an oblique hyperplane
``x·n < b`` whose normal n has ``extension_level + 1`` nonzero random
components (extension_level = 0: axis-parallel splits), which removes
the axis-aligned scoring bias (Hariri et al.). Scores share c(n) with
Isolation Forest.

Categorical columns are dropped; an NA takes its column's float32 rollup
mean (``frame/rollups.py``). A node's offset is b = n·p for a point p
drawn uniformly in the box of the per-feature minima and maxima, which
the reference takes over its padded matrix (padding rows hold the mean).
Growth is two functions, as for Isolation Forest: ``draw_tree`` draws the
normals and offsets, ``grow_ext_tree`` grows a tree from them. A level
is a ``segment_sum`` of the bag weights per node (64-bit fixed point on
the card) and the rows' projections on their nodes' normals, in plain
torch on the rows' device: there is no TPU kernel behind it. The
projections are float32 sums over F; ``proj < offset`` can differ from
the reference's only at a near-tie.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.rollups import rollup_mean
from h2o3_tpu_torch.models.gbm import tree_generator
from h2o3_tpu_torch.models.isofor import (ANOMALY, avg_path_correction,
                                          node_counts)
from h2o3_tpu_torch.models.model import Model, ModelBuilder, require_local
from h2o3_tpu_torch.models.tree import _mtries_mask
from h2o3_tpu_torch.ops.fixed_point import exponents
from h2o3_tpu_torch.parallel.device import fetch


class ExtTree(NamedTuple):
    normals: torch.Tensor    # [D, Lmax, F] float32
    offsets: torch.Tensor    # [D, Lmax] float32
    is_split: torch.Tensor   # [D, Lmax] bool
    leaf: torch.Tensor       # [2^D] float32 c(count) correction


def draw_tree(gen: torch.Generator, lo: torch.Tensor, hi: torch.Tensor,
              depth: int, ext: int) -> Dict[str, torch.Tensor]:
    """A tree's random hyperplanes: ``normals`` [D, Lmax, F], standard
    normal on exactly min(ext + 1, F) random components a node, and
    ``offsets`` [D, Lmax] = normal·p for p uniform in [lo, hi] (float32
    products summed over F); slots past 2^d of level d are 0."""
    dev = lo.device
    F = lo.shape[0]
    Lmax = 2 ** (depth - 1) if depth > 0 else 1
    wn = torch.randn((depth, Lmax, F), generator=gen, device=dev)
    keep = _mtries_mask(gen, depth * Lmax, F, min(ext + 1, F), dev)
    live = (torch.arange(Lmax, device=dev)[None, :]
            < (2 ** torch.arange(depth, device=dev))[:, None])
    wn = torch.where(keep.reshape(depth, Lmax, F) & live[:, :, None], wn,
                     0.0)
    pu = torch.rand((depth, Lmax, F), generator=gen, device=dev)
    pnt = lo + pu * (hi - lo)
    return {"normals": wn, "offsets": torch.sum(wn * pnt, dim=2)}


def grow_ext_tree(X, w, normals, offsets) -> ExtTree:
    """One extended isolation tree from given hyperplanes ([D, Lmax, F]
    normals, [D, Lmax] offsets): a node splits while its bag weight ``w``
    exceeds 1; a row goes left when its projection is below the offset."""
    D, Lmax = offsets.shape
    dev = X.device
    nid = torch.zeros((X.shape[0],), dtype=torch.int64, device=dev)
    e = exponents(w[:, None]) if w.is_cuda else None
    is_splits = torch.zeros((D, Lmax), dtype=torch.bool, device=dev)
    for d in range(D):
        L = 2 ** d
        is_splits[d, :L] = node_counts(nid, w, L, e) > 1.0
        nid = 2 * nid + torch.where(_goes_left(X, nid, normals[d], offsets[d],
                                               is_splits[d]), 0, 1)
    leaf_cnt = node_counts(nid, w, 2 ** D, e)
    return ExtTree(normals, offsets, is_splits,
                   avg_path_correction(leaf_cnt))


def _goes_left(X, nid, normals_d, offsets_d, split_d):
    proj = torch.sum(X * normals_d.index_select(0, nid), dim=1)
    return torch.where(split_d.index_select(0, nid),
                       proj < offsets_d.index_select(0, nid), True)


def ext_path_length(tree: ExtTree, X) -> torch.Tensor:
    """Per-row isolation path length through one tree, float32 [N]."""
    nid = torch.zeros((X.shape[0],), dtype=torch.int64, device=X.device)
    plen = torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
    for d in range(tree.offsets.shape[0]):
        plen = plen + tree.is_split[d].index_select(0, nid).to(torch.float32)
        nid = 2 * nid + torch.where(_goes_left(
            X, nid, tree.normals[d], tree.offsets[d], tree.is_split[d]), 0, 1)
    return plen + tree.leaf.index_select(0, nid)


def ext_forest_mean_length(forest: ExtTree, X) -> torch.Tensor:
    """Mean path length over the trees, float32 [N]."""
    tot = torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
    T = forest.offsets.shape[0]
    for t in range(T):
        tot = tot + ext_path_length(ExtTree(*(a[t] for a in forest)), X)
    return tot / T


def feature_matrix(frame: Frame, names, means=None):
    """Dense float32 [Npad, F] on the frame's device with NA (and padding)
    → the column's rollup mean (or ``means``); returns (X, means)."""
    cols, out_means = [], []
    for i, n in enumerate(names):
        c = frame.col(n)
        mu = rollup_mean(c) if means is None else means[i]
        out_means.append(mu)
        v = c.numeric_view()
        cols.append(torch.where(torch.isnan(v), mu, v))
    return torch.stack(cols, dim=1), out_means


def value_box(X, means):
    """Per-feature (min, max) of X [N, F] and the means: the reference
    takes them over its padded matrix, whose padding rows hold the means,
    so the means count whatever this frame's own padding."""
    mu = torch.tensor(means, dtype=torch.float32).to(X.device)
    return (torch.minimum(X.amin(dim=0), mu),
            torch.maximum(X.amax(dim=0), mu))


class ExtendedIsolationForestModel(Model):
    algo = "extendedisolationforest"

    def __init__(self, params, output, forest: ExtTree, c_norm: float,
                 means, features):
        super().__init__(params, output)
        self.forest = forest
        self.c_norm = c_norm
        self.means = means
        self.features = features

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        require_local(frame, self.algo)
        X, _ = feature_matrix(frame, self.features, self.means)
        ml = fetch(ext_forest_mean_length(self.forest, X))[:frame.nrows]
        score = 2.0 ** (-ml / max(self.c_norm, 1e-12))
        return {"anomaly_score": score, "mean_length": ml}

    def model_performance(self, frame: Frame, mask_weights=None):
        raw = self._score_raw(frame)
        return {"mean_score": float(raw["anomaly_score"].mean()),
                "mean_length": float(raw["mean_length"].mean())}


class ExtendedIsolationForestEstimator(ModelBuilder):
    """h2o-py H2OExtendedIsolationForestEstimator surface.
    ``score_tree_interval`` is accepted and inert, as in the reference."""

    algo = "extendedisolationforest"
    label = "ExtendedIsolationForest"

    DEFAULTS = dict(
        ntrees=100, sample_size=256, extension_level=0, seed=-1,
        ignored_columns=None, score_tree_interval=0,
    )
    PORTED = frozenset(DEFAULTS)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None):
        p = self.params
        dev = frame.device
        x = [n for n in x if not frame.col(n).is_categorical] or list(x)
        ext = int(p["extension_level"])
        if not 0 <= ext <= len(x) - 1:
            raise ValueError(
                f"extension_level must be in [0, {len(x) - 1}]")
        X, means = feature_matrix(frame, x)
        lo, hi = value_box(X, means)
        w = frame.valid_weights()
        n = frame.nrows
        psi = int(p["sample_size"])
        bag_rate = min(1.0, psi / max(n, 1))
        depth = int(np.ceil(np.log2(max(psi, 2))))
        seed = int(p["seed"]) if int(p["seed"]) >= 0 else 0xE1F
        trees = []
        for t in range(int(p["ntrees"])):
            gen = tree_generator(seed, t, dev)
            keep = torch.rand(w.shape[0], generator=gen, device=dev) \
                < bag_rate
            dr = draw_tree(gen, lo, hi, depth, ext)
            trees.append(grow_ext_tree(X, w * keep.to(torch.float32),
                                       dr["normals"], dr["offsets"]))
        forest = ExtTree(*(torch.stack([getattr(t, f) for t in trees])
                           for f in ExtTree._fields))
        c_norm = float(avg_path_correction(torch.tensor([float(psi)]))[0])
        output = {"category": ANOMALY, "response": None, "names": list(x),
                  "domain": None}
        model = ExtendedIsolationForestModel(p, output, forest, c_norm,
                                             means, list(x))
        model.training_metrics = model.model_performance(frame)
        return model
