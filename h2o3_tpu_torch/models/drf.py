"""DRF — distributed random forest: binomial, multinomial and regression.

Reference: h2o3_tpu/models/drf.py (hex/tree/drf/DRF.java). What differs
from GBM, as the reference has it:
- each tree is an independent regression tree on the raw response (the
  class-1 indicator for a binomial response; for a multinomial one, K
  class trees on the K class indicators, sharing one bag and one column
  sample), trained on a bagged row sample (``sample_rate``, default
  0.632) — no shrinkage, no margins;
- per-NODE column subsampling of exactly ``mtries`` columns (-1: sqrt(F)
  for classification, F/3 for regression), so every level hands the
  split kernel an [L, F] column mask;
- prediction = average of the per-tree leaf means (votes); multinomial
  class probabilities are the votes clipped to [0, 1] over their sum;
- training metrics are out-of-bag: every row is scored only by the trees
  whose bag excluded it.

The reference runs the forest as one compiled ``lax.scan``; here a plain
loop over trees (``bag_step``) runs eagerly on the frame's device with no
host sync inside it, each tree through the level kernels. Each tree draws
its bag, column and per-node samples from a ``torch.Generator`` seeded
from (seed, tree index); the draws differ from the reference's
``jax.random`` bits.

Around the loop (drf.py:321-558 of the reference): a ``checkpoint``
restart draws tree t of its new part as tree prior_T + t and continues
the donor's out-of-bag accumulators (``_oob``), so it is bit-equal to
one longer fit, forest and OOB metrics; ``max_runtime_secs`` stops after
a tree; cross-validation runs ``ml/cv.py``'s fast path; calibration
``ml/calibration.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.job import job_update
from h2o3_tpu_torch.frame.binning import (BinnedMatrix, bin_frame,
                                          rebin_for_scoring)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.ml.calibration import maybe_calibrate
from h2o3_tpu_torch.ml.shap import contributions_frame
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.gbm import (CHECKPOINT_NON_MODIFIABLE as
                                       _TREE_NON_MODIFIABLE,
                                       _sample_columns, tree_generator)
from h2o3_tpu_torch.models.model import (Deadline, Model, ModelBuilder,
                                         ModelCategory, adapt_domain,
                                         check_donor, checkpoint_error,
                                         infer_category, masked_weights,
                                         prior_trees, require_local,
                                         resolve_checkpoint_model)
from h2o3_tpu_torch.models.tree import (Tree, TreeParams, bucket_depth,
                                        concat_forests,
                                        feature_frequencies_frame,
                                        grow_tree, leaf_assignment_frame,
                                        predict_forest, scalars_of,
                                        stack_trees)
from h2o3_tpu_torch.parallel.device import fetch

MAX_COMPLETE_DEPTH = 14  # complete-tree layout: histograms are 2^d·F·B·3
# SharedTree's checkpoint-non-modifiable fields plus DRF's own knobs
CHECKPOINT_NON_MODIFIABLE = _TREE_NON_MODIFIABLE + (
    "mtries", "histogram_type", "binomial_double_trees")


def edge_method(histogram_type) -> str:
    """``_numeric_edges``'s method for a DRF ``histogram_type``, mapped
    as the reference maps it (drf.py:306-308)."""
    ht = str(histogram_type).lower()
    return {"auto": "quantiles", "quantilesglobal": "quantiles",
            "uniformadaptive": "uniform"}.get(ht, ht)


def bag_step(bm: BinnedMatrix, ys, w, oob_sum, oob_cnt,
             gen: torch.Generator, *, tp: TreeParams, sc,
             sample_rate: float, mtries: int):
    """One tree of the forest on the device, with no host sync: bag mask,
    per-tree column sample, then for each column k of the targets ys
    [N, K] a ``grow_tree`` with g = -y_k, h = 1 (so the Newton leaf is
    the bag-weighted mean of y_k) and per-node ``mtries`` masks drawn from
    ``gen`` in class order, and the out-of-bag accumulators. Returns (the
    K trees, oob_sum [N, K], oob_cnt, gain_by_feature)."""
    dev = w.device
    keep = torch.rand(w.shape[0], generator=gen, device=dev) < sample_rate
    wbag = w * keep.to(torch.float32)
    oob = (w > 0) & ~keep
    col_mask = _sample_columns(gen, bm.bins.shape[1], tp.col_sample_rate,
                               dev)
    oob_sum = oob_sum.clone()
    ones = torch.ones_like(w)
    trees, gains = [], 0.0
    for k in range(ys.shape[1]):
        tree, nid, gain = grow_tree(bm.bins, bm.nbins, wbag, -ys[:, k], ones,
                                    col_mask, params=tp, scalars=sc,
                                    mtries=mtries, generator=gen)
        # routing nid is bag-independent
        oob_sum[:, k] += torch.where(oob, tree.leaf[nid.long()], 0.0)
        trees.append(tree)
        gains = gains + gain
    return trees, oob_sum, oob_cnt + oob.to(torch.float32), gains


def vote_probs(votes: torch.Tensor) -> torch.Tensor:
    """Multinomial class probabilities from mean votes [N, K]: clipped to
    [0, 1], over the unclipped sum."""
    s = torch.sum(votes, dim=1, keepdim=True)
    return torch.clamp(votes, 0.0, 1.0) / torch.clamp_min(s, 1e-12)


class DRFModel(Model):
    algo = "drf"

    def __init__(self, params, output, forest: Tree, bm: BinnedMatrix):
        super().__init__(params, output)
        self.forest = forest           # [T(*K), D, Lmax], t-major
        self.bm = bm
        # (oob_sum [N, K], oob_cnt [N]) on the device: a checkpoint
        # restart continues them
        self._oob = None

    @property
    def n_class_trees(self) -> int:
        """Trees an iteration: K for multinomial, else 1."""
        if self.output["category"] == ModelCategory.MULTINOMIAL:
            return self.output["nclasses"]
        return 1

    def _mean_votes(self, bm: BinnedMatrix) -> torch.Tensor:
        """Per-class average tree output [N, K] (K = 1 unless
        multinomial)."""
        K = self.n_class_trees
        T = self.forest.feat.shape[0] // K
        # an explicit reciprocal multiply, as the reference spells it
        inv_t = torch.tensor(1.0 / T, dtype=torch.float32)
        return torch.stack([
            predict_forest(Tree(*(a.reshape((T, K) + a.shape[1:])[:, k]
                                  for a in self.forest)), bm.bins,
                           self.bm.nbins_total) * inv_t
            for k in range(K)], dim=1)

    def _probs(self, bm: BinnedMatrix) -> torch.Tensor:
        votes = self._mean_votes(bm)
        if self.output["category"] == ModelCategory.MULTINOMIAL:
            return vote_probs(votes)
        p1 = torch.clamp(votes[:, 0], 0.0, 1.0)
        return torch.stack([1.0 - p1, p1], dim=1)

    def _score_dev(self, frame: Frame) -> torch.Tensor:
        """Predictions left on the device: p1, [N, K] class
        probabilities, or the response."""
        require_local(frame, self.algo)
        bm = rebin_for_scoring(self.bm, frame)
        cat = self.output["category"]
        if cat == ModelCategory.REGRESSION:
            return self._mean_votes(bm)[:, 0]
        p = self._probs(bm)
        return p[:, 1] if cat == ModelCategory.BINOMIAL else p

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        require_local(frame, self.algo)
        bm = rebin_for_scoring(self.bm, frame)
        n = frame.nrows
        cat = self.output["category"]
        if cat == ModelCategory.REGRESSION:
            return {"predict": fetch(self._mean_votes(bm)[:, 0])[:n]}
        p = fetch(self._probs(bm))[:n]
        if cat == ModelCategory.MULTINOMIAL:
            out = {"predict": p.argmax(axis=1).astype(np.int32)}
            out.update({f"p{k}": p[:, k] for k in range(p.shape[1])})
            return out
        t = self.output.get("default_threshold", 0.5)
        return {"predict": (p[:, 1] >= t).astype(np.int32),
                "p0": p[:, 0], "p1": p[:, 1]}

    def model_performance(self, frame: Frame, mask_weights=None):
        require_local(frame, self.algo)
        y = self.output["response"]
        bm = rebin_for_scoring(self.bm, frame)
        w = frame.valid_weights()
        wc = self.params.get("weights_column")
        if wc and wc in frame:
            v = frame.col(wc).numeric_view()
            w = w * torch.where(torch.isnan(v), 0.0, v)
        w = masked_weights(w, mask_weights)
        cat = self.output["category"]
        if cat == ModelCategory.REGRESSION:
            yv = frame.col(y).numeric_view()
            w = w * torch.where(torch.isnan(yv), 0.0, 1.0)
            yv = torch.where(torch.isnan(yv), 0.0, yv)
            return mm.regression_metrics(self._mean_votes(bm)[:, 0], yv, w)
        yv = adapt_domain(frame.col(y), self.output["domain"])
        yv = np.pad(yv, (0, bm.bins.shape[0] - frame.nrows),
                    constant_values=-1)
        w = w * torch.from_numpy((yv >= 0).astype(np.float32)).to(w.device)
        yv = torch.from_numpy(np.maximum(yv, 0)).to(w.device)
        if cat == ModelCategory.MULTINOMIAL:
            return mm.multinomial_metrics(self._probs(bm), yv, w,
                                          domain=self.output["domain"])
        return mm.binomial_metrics(self._probs(bm)[:, 1],
                                   yv.to(torch.float32), w)

    def predict_leaf_node_assignment(self, frame: Frame) -> Frame:
        """Per-tree terminal node ids (h2o-py predict_leaf_node_assignment
        with type Node_ID); per-class columns T{t}.C{k} for a classifier."""
        return leaf_assignment_frame(self, frame)

    def feature_frequencies(self, frame: Frame) -> Frame:
        """Per-row feature usage counts on the decision paths (h2o-py
        feature_frequencies)."""
        return feature_frequencies_frame(self, frame)

    def predict_contributions(self, frame: Frame) -> Frame:
        """TreeSHAP contributions; a row sums to the (unclipped) mean
        vote, the reference's DRF contract. Multinomial raises."""
        return contributions_frame(
            self, frame, scale=1.0 / (self.forest.feat.shape[0]
                                      // self.n_class_trees))

    @property
    def varimp_table(self) -> List:
        return self.output.get("varimp") or []


class DRFEstimator(ModelBuilder):
    """h2o-py H2ORandomForestEstimator-compatible surface: binomial,
    multinomial and regression, with cross-validation, checkpoint
    restarts, a runtime cap, calibration and ``histogram_type``
    (``auto``/``QuantilesGlobal``: quantile edges, ``UniformAdaptive``:
    equal widths, ``Random``: XRT's random edges; any other spelling, e.g.
    ``RoundRobin``, takes the quantile branch, as in the reference).
    ``stopping_rounds``, ``stopping_metric``, ``stopping_tolerance``,
    ``binomial_double_trees`` and ``distribution`` are accepted and
    inert: the reference's fit reads none of them. Parameters outside
    ``PORTED`` keep the reference's names and defaults; setting one away
    from its default raises ``NotImplementedError``."""

    algo = "drf"
    label = "DRF"
    cv_fold_masking = True

    DEFAULTS = dict(
        max_runtime_secs=0.0,
        ntrees=50, max_depth=20, min_rows=1.0, nbins=20, nbins_cats=1024,
        mtries=-1, sample_rate=0.632, col_sample_rate_per_tree=1.0,
        min_split_improvement=1e-5, seed=-1, nfolds=0,
        weights_column=None, fold_column=None, fold_assignment="auto",
        keep_cross_validation_models=True,
        keep_cross_validation_predictions=False,
        keep_cross_validation_fold_assignment=False,
        ignored_columns=None, stopping_rounds=0, stopping_metric="auto",
        stopping_tolerance=1e-3, binomial_double_trees=False,
        distribution="auto", calibrate_model=False,
        calibration_frame=None, calibration_method="PlattScaling",
        histogram_type="auto", checkpoint=None,
    )
    PORTED = frozenset((
        "ntrees", "max_depth", "min_rows", "nbins", "nbins_cats", "mtries",
        "sample_rate", "col_sample_rate_per_tree", "min_split_improvement",
        "seed", "weights_column", "ignored_columns", "max_runtime_secs",
        "nfolds", "fold_column", "fold_assignment",
        "keep_cross_validation_models", "keep_cross_validation_predictions",
        "keep_cross_validation_fold_assignment", "checkpoint",
        "calibrate_model", "calibration_frame", "calibration_method",
        "histogram_type",
        # accepted and inert, as in the reference
        "stopping_rounds", "stopping_metric", "stopping_tolerance",
        "binomial_double_trees", "distribution"))

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None):
        p = self.params
        dev = frame.device
        category = infer_category(frame, y)
        # near leave-one-out CV folds (ml/cv.py): no OOB metrics, varimp
        # or calibration, and a depth slack of 1 level, not 3
        light = bool(getattr(self, "_cv_light", False))
        ckpt = None
        if p.get("checkpoint") is not None:
            ckpt = resolve_checkpoint_model("drf", p["checkpoint"],
                                            DRFModel)
            check_donor("drf", ckpt, y=y, x=x, category=category, params=p,
                        fields=CHECKPOINT_NON_MODIFIABLE)
        w = frame.valid_weights()
        if p.get("weights_column"):
            wc = frame.col(p["weights_column"]).numeric_view()
            w = w * torch.where(torch.isnan(wc), 0.0, wc)
        w = self._cv_masked_weights(w, frame)
        rc = frame.col(y)
        wh_host = self._host_weights(frame, y)
        resp_na_host = np.isnan(rc.host_view())
        if resp_na_host.any():
            keep = np.pad((~resp_na_host).astype(np.float32),
                          (0, frame.nrows_padded - frame.nrows))
            w = w * torch.from_numpy(keep).to(dev)
        shared_bm = getattr(self, "_cv_shared_bm", None)
        if ckpt is not None:
            bm = rebin_for_scoring(ckpt.bm, frame)
        elif shared_bm is not None:
            bm = shared_bm
        else:
            bm = bin_frame(frame, x, nbins=p["nbins"],
                           nbins_cats=p["nbins_cats"],
                           histogram_type=edge_method(p["histogram_type"]),
                           weights=wh_host)

        # complete-tree layout: a level costs 2^d histogram node slots
        # whether or not rows reach them, so the depth is capped by the
        # data size too (log2(rows) + 3 leaves room for unbalanced trees;
        # + 1 for light CV folds, whose models are dropped after scoring);
        # trees are laid out at the depth bucket, never past the caps
        depth = int(p["max_depth"])
        data_cap = int(np.ceil(np.log2(max(frame.nrows_padded, 4)))) \
            + (1 if light else 3)
        depth = min(depth, MAX_COMPLETE_DEPTH, data_cap)
        layout_depth = min(bucket_depth(depth), MAX_COMPLETE_DEPTH, data_cap)
        F = len(x)
        mtries = int(p["mtries"])
        if mtries == -1:
            mtries = (max(1, int(np.sqrt(F)))
                      if category != ModelCategory.REGRESSION
                      else max(1, F // 3))
        elif mtries <= 0:
            mtries = F
        w, w_scale = self._normalize_uniform_weights(w, wh_host)
        tp = TreeParams(
            max_depth=layout_depth,
            min_rows=float(p["min_rows"]) / w_scale,
            learn_rate=1.0, reg_lambda=0.0,
            min_split_improvement=float(p["min_split_improvement"])
            / w_scale,
            col_sample_rate=float(p["col_sample_rate_per_tree"]),
            nbins_total=bm.nbins_total,
            cat_feats=tuple(bool(v) for v in bm.is_cat))
        sc = scalars_of(tp, dev, depth_limit=depth)

        # targets [Npad, K]: the response, the class-1 indicator, or the
        # K class indicators
        npad = bm.bins.shape[0]
        yv = np.nan_to_num(rc.to_numpy())
        if category == ModelCategory.REGRESSION:
            ys = yv.astype(np.float32)[:, None]
        elif category == ModelCategory.BINOMIAL:
            ys = (yv == 1).astype(np.float32)[:, None]
        else:
            ys = (yv.astype(np.int32)[:, None]
                  == np.arange(rc.cardinality)[None, :]).astype(np.float32)
        ys = torch.from_numpy(np.pad(ys, ((0, npad - frame.nrows),
                                          (0, 0)))).to(dev)

        seed = int(p["seed"]) if int(p["seed"]) >= 0 else 0xD2F
        ntrees = int(p["ntrees"])
        sample_rate = float(p["sample_rate"])
        oob_sum = torch.zeros((npad, ys.shape[1]), dtype=torch.float32,
                              device=dev)
        oob_cnt = torch.zeros(npad, dtype=torch.float32, device=dev)
        prior_T = 0
        if ckpt is not None:
            prior_T = prior_trees("drf", ckpt, ckpt.n_class_trees, ntrees)
            ntrees -= prior_T
            if ckpt.forest.feat.shape[1] != tp.max_depth:
                raise checkpoint_error(
                    "drf", "training_frame",
                    "checkpoint restart requires a compatible training "
                    f"frame (donor trees laid out at depth "
                    f"{ckpt.forest.feat.shape[1]}, here {tp.max_depth})")
            if ckpt._oob is not None and \
                    ckpt._oob[0].shape == oob_sum.shape:
                # the accumulators continue, in one longer fit's order
                oob_sum = ckpt._oob[0].to(dev, copy=True)
                oob_cnt = ckpt._oob[1].to(dev, copy=True)
        deadline = Deadline(p.get("max_runtime_secs"), dev)
        gains = torch.zeros(F, dtype=torch.float32, device=dev)
        trees: List[Tree] = []
        for t in range(ntrees):
            step, oob_sum, oob_cnt, gain = bag_step(
                bm, ys, w, oob_sum, oob_cnt,
                tree_generator(seed, prior_T + t, dev), tp=tp, sc=sc,
                sample_rate=sample_rate, mtries=mtries)
            trees += step
            gains = gains + gain
            job_update(1.0 / ntrees, f"tree {t + 1}/{ntrees}")
            if deadline.passed():
                break
        forest = stack_trees(trees)
        if ckpt is not None:
            forest = concat_forests([ckpt.forest, forest])
        output = {"category": category, "response": y, "names": list(x),
                  "nclasses": rc.cardinality if rc.is_categorical else 1,
                  "domain": rc.domain}
        model = DRFModel(p, output, forest, bm)
        if light:
            model.output["default_threshold"] = 0.5
            model.output["varimp"] = []
            return model
        model._oob = (oob_sum, oob_cnt)

        # OOB training metrics (rows never out of bag drop out by weight)
        w_oob = w * (oob_cnt > 0).to(torch.float32)
        mean_oob = oob_sum / torch.clamp_min(oob_cnt, 1.0)[:, None]
        if category == ModelCategory.REGRESSION:
            model.training_metrics = mm.regression_metrics(
                mean_oob[:, 0], ys[:, 0], w_oob)
        elif category == ModelCategory.BINOMIAL:
            model.training_metrics = mm.binomial_metrics(
                torch.clamp(mean_oob[:, 0], 0.0, 1.0), ys[:, 0], w_oob)
            model.output["default_threshold"] = \
                model.training_metrics["max_f1_threshold"]
        else:
            model.training_metrics = mm.multinomial_metrics(
                vote_probs(mean_oob), torch.argmax(ys, dim=1), w_oob,
                domain=rc.domain)
        # scaled relative importance (hex/VarImp semantics)
        vi = fetch(gains)
        order = np.argsort(-vi)
        tot = vi.sum() or 1.0
        model.output["varimp"] = [
            (x[i], float(vi[i]), float(vi[i] / max(vi.max(), 1e-12)),
             float(vi[i] / tot)) for i in order]
        maybe_calibrate(model, p, category)
        return model
