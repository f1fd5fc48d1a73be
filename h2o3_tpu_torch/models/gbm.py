"""GBM — gradient boosting machine, binomial and regression.

Reference: h2o3_tpu/models/gbm.py (hex/tree/gbm/GBM.java): per iteration
compute gradients, grow one tree through the level kernels, scale its
leaves by the learning rate and update the margins. The reference runs
the iterations as compiled scans; here the plain loop of its fit
(gbm.py:1043-1147) runs eagerly on the frame's device, with no host
sync inside it, and the metrics tail (gbm.py:1225-1254) runs once at the
end.

Random numbers: each tree draws its row and column samples from a
``torch.Generator`` seeded from (seed, tree index) — the reference's
``_tree_keys`` contract that a tree's randomness depends on its global
index only. The draws differ from the reference's ``jax.random`` bits.

Data-parallel fit: on a frame partitioned over a sharded mesh
(``Frame.from_numpy_partitioned``) every rank runs this same loop on its
own rows; ``grow_tree`` sums each level's histogram and the leaf sums
over the ranks, so every rank grows the same trees. What must agree
across ranks comes from host views of all rows (f0, the bin edges) or
from the tree's generator, seeded alike on every rank (the column
masks); row draws come from a generator seeded from (seed, tree, rank).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.binning import (BinnedMatrix, bin_frame,
                                          rebin_for_scoring)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.distribution import get_distribution
from h2o3_tpu_torch.models.model import (Model, ModelBuilder, ModelCategory,
                                         adapt_domain, infer_category)
from h2o3_tpu_torch.models.tree import (Tree, TreeParams, bucket_depth,
                                        grow_tree, predict_forest,
                                        scalars_of, stack_trees)
from h2o3_tpu_torch.parallel.device import fetch
from h2o3_tpu_torch.parallel.mesh import fetch_replicated


def tree_generator(seed: int, tree_index: int, device: torch.device,
                   *stream: int) -> torch.Generator:
    """The generator of one tree's draws, seeded from (seed, index) and
    any further ``stream`` numbers (a rank's own row draws)."""
    state = np.random.SeedSequence([seed, tree_index, *stream]
                                   ).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) & ((1 << 63) - 1))
    return gen


def _sample_columns(gen: torch.Generator, F: int, rate: float,
                    device) -> torch.Tensor:
    """Per-tree column mask (col_sample_rate_per_tree) with one column
    always forced in, so a tree never goes featureless."""
    if rate >= 1.0:
        return torch.ones(F, dtype=torch.bool, device=device)
    mask = torch.rand(F, generator=gen, device=device) < max(rate, 0.0)
    forced = torch.randint(0, F, (), generator=gen, device=device)
    return mask | (torch.arange(F, device=device) == forced)


def boost_step(bm: BinnedMatrix, y, w, margin, gen: torch.Generator, *,
               dist, tp: TreeParams, sc, learn_rate: torch.Tensor,
               sample_rate: float, row_gen: Optional[torch.Generator] = None,
               mesh=None):
    """One boosting iteration on the device, with no host sync on one
    device: gradients → row/column samples → one tree → learning-rate-
    scaled leaves → margin update. Returns (tree, margin,
    gain_by_feature). Row draws come from ``row_gen`` (default ``gen``);
    on a sharded ``mesh`` the rows are this rank's."""
    dev = margin.device
    g = dist.grad(y, margin)
    h = dist.hess(y, margin)
    ws = w
    if sample_rate < 1.0:
        keep = torch.rand(margin.shape[0], generator=row_gen or gen,
                          device=dev) < max(sample_rate, 0.0)
        ws = w * keep.to(torch.float32)
    col_mask = _sample_columns(gen, bm.bins.shape[1], tp.col_sample_rate,
                               dev)
    tree, nid, gain = grow_tree(bm.bins, bm.nbins, ws, g, h, col_mask,
                                params=tp, scalars=sc, mesh=mesh)
    tree = tree._replace(leaf=learn_rate * tree.leaf)
    return tree, margin + tree.leaf[nid.long()], gain


class GBMModel(Model):
    algo = "gbm"

    def __init__(self, params, output, forest: Tree, bm: BinnedMatrix,
                 f0: np.float32, dist_name: str):
        super().__init__(params, output)
        self.forest = forest          # [T, D, Lmax] stacked
        self.bm = bm                  # training binning (edges reused to score)
        self.f0 = f0
        self.dist_name = dist_name

    def _margins(self, bm: BinnedMatrix) -> torch.Tensor:
        return float(self.f0) + predict_forest(self.forest, bm.bins,
                                               bm.nbins_total)

    def _link_inv(self):
        if self.output["category"] == ModelCategory.BINOMIAL:
            return get_distribution("bernoulli").link_inv
        return get_distribution(self.dist_name).link_inv

    def _predictions(self, frame: Frame) -> torch.Tensor:
        """Predictions of the rows on this rank's device."""
        return self._link_inv()(self._margins(
            rebin_for_scoring(self.bm, frame)))

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        pred = fetch_replicated(self._predictions(frame),
                                frame.mesh)[:frame.nrows]
        return self._columns(pred)

    def _score_local(self, frame: Frame) -> Dict[str, np.ndarray]:
        return self._columns(
            fetch(self._predictions(frame))[:frame.local_nrows])

    def _columns(self, pred: np.ndarray) -> Dict[str, np.ndarray]:
        if self.output["category"] == ModelCategory.BINOMIAL:
            t = self.output.get("default_threshold", 0.5)
            return {"predict": (pred >= t).astype(np.int32),
                    "p0": 1.0 - pred, "p1": pred}
        return {"predict": pred}

    def model_performance(self, frame: Frame):
        y = self.output["response"]
        bm = rebin_for_scoring(self.bm, frame)
        marg = self._margins(bm)
        w = frame.valid_weights()
        wc_name = self.params.get("weights_column")
        if wc_name and wc_name in frame:
            wc = frame.col(wc_name).numeric_view()
            w = w * torch.where(torch.isnan(wc), 0.0, wc)
        if self.output["category"] == ModelCategory.BINOMIAL:
            yv = frame.local_rows(adapt_domain(frame.col(y),
                                               self.output["domain"]), -1)
            w = w * torch.from_numpy((yv >= 0).astype(np.float32)).to(w.device)
            yt = torch.from_numpy(np.maximum(yv, 0).astype(np.float32))
            return mm.binomial_metrics(self._link_inv()(marg),
                                       yt.to(w.device), w, mesh=frame.mesh)
        dist = get_distribution(self.dist_name)
        yv = frame.col(y).numeric_view()
        w = w * torch.where(torch.isnan(yv), 0.0, 1.0)
        yv = torch.where(torch.isnan(yv), 0.0, yv)
        return mm.regression_metrics(
            dist.link_inv(marg), yv, w,
            deviance_fn=lambda yy, pp: dist.deviance(yy, marg),
            mesh=frame.mesh)


class GBMEstimator(ModelBuilder):
    """h2o-py H2OGradientBoostingEstimator-compatible surface, binomial
    and regression. Parameters outside ``PORTED`` keep the reference's
    names and defaults; setting one away from its default raises
    ``NotImplementedError``."""

    algo = "gbm"
    SHARDED = True

    DEFAULTS = dict(
        max_runtime_secs=0.0,
        ntrees=50, max_depth=5, min_rows=10.0, learn_rate=0.1,
        sample_rate=1.0, col_sample_rate_per_tree=1.0,
        nbins=64, nbins_cats=1024, distribution="auto",
        custom_distribution_func=None,
        # reg_lambda=0: the reference GammaPass has no ridge term
        min_split_improvement=1e-5, seed=-1, reg_lambda=0.0,
        nfolds=0, weights_column=None, fold_column=None,
        offset_column=None, fold_assignment="auto",
        keep_cross_validation_models=True,
        keep_cross_validation_predictions=False,
        keep_cross_validation_fold_assignment=False,
        ignored_columns=None, tweedie_power=1.5, quantile_alpha=0.5,
        huber_alpha=0.9, stopping_rounds=0, stopping_metric="auto",
        stopping_tolerance=1e-3, score_tree_interval=0, checkpoint=None,
        monotone_constraints=None, interaction_constraints=None,
        calibrate_model=False, calibration_frame=None,
        calibration_method="PlattScaling",
        check_constant_response=True,
    )
    PORTED = frozenset((
        "ntrees", "max_depth", "min_rows", "learn_rate", "sample_rate",
        "col_sample_rate_per_tree", "nbins", "nbins_cats", "distribution",
        "min_split_improvement", "seed", "reg_lambda", "weights_column"))

    def __init__(self, **params):
        unknown = set(params) - set(self.DEFAULTS)
        if unknown:
            raise ValueError(f"unknown GBM params: {sorted(unknown)}")
        for k, v in params.items():
            if k not in self.PORTED and v != self.DEFAULTS[k]:
                raise NotImplementedError(
                    f"GBM parameter '{k}' is not ported yet")
        merged = dict(self.DEFAULTS)
        merged.update(params)
        if str(merged["distribution"]).lower() not in (
                "auto", "bernoulli", "gaussian"):
            raise NotImplementedError(
                f"GBM parameter 'distribution'={merged['distribution']!r} "
                "is not ported yet (auto, bernoulli, gaussian are)")
        super().__init__(**merged)

    def _resolve_distribution(self, category: str) -> str:
        d = str(self.params["distribution"]).lower()
        if d != "auto":
            return d
        return {"Binomial": "bernoulli", "Regression": "gaussian"}[category]

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str]):
        p = self.params
        dev = frame.device
        mesh = frame.mesh
        category = infer_category(frame, y)
        if category == ModelCategory.MULTINOMIAL:
            raise NotImplementedError(
                "multinomial GBM is not ported yet (binomial and "
                "regression are)")
        dist_name = self._resolve_distribution(category)

        w = frame.valid_weights()
        if p.get("weights_column"):
            wc = frame.col(p["weights_column"]).numeric_view()
            w = w * torch.where(torch.isnan(wc), 0.0, wc)
        rc = frame.col(y)
        if p.get("check_constant_response", True) and not rc.is_categorical:
            yh = rc.host_view()
            vals = yh[~np.isnan(yh)]
            if vals.size and float(vals.min()) == float(vals.max()):
                raise ValueError(
                    "Response cannot be constant - check your response "
                    "column, or set check_constant_response=False")
        wh_host = self._host_weights(frame, y)
        resp_na_host = np.isnan(rc.host_view())
        if resp_na_host.any():
            keep = frame.local_rows((~resp_na_host).astype(np.float32))
            w = w * torch.from_numpy(keep).to(dev)
        # weighted edges: the row-weight ≡ row-multiplicity contract must
        # hold through the bin sketch too
        bm = bin_frame(frame, x, nbins=p["nbins"], nbins_cats=p["nbins_cats"],
                       weights=wh_host)
        w, w_scale = self._normalize_uniform_weights(w, wh_host)
        if w_scale != 1.0:
            wh_host = wh_host / np.float32(w_scale)

        max_depth = int(p["max_depth"])
        # laid out at the depth bucket; the actual depth masks deeper
        # levels (reference _neutral_tp / TreeScalars.depth_limit)
        tp = TreeParams(
            max_depth=bucket_depth(max_depth),
            min_rows=float(p["min_rows"]) / w_scale,
            learn_rate=float(p["learn_rate"]),
            reg_lambda=float(p["reg_lambda"]) / w_scale,
            min_split_improvement=float(p["min_split_improvement"])
            / w_scale,
            col_sample_rate=float(p["col_sample_rate_per_tree"]),
            nbins_total=bm.nbins_total,
            cat_feats=tuple(bool(v) for v in bm.is_cat))
        sc = scalars_of(tp, dev, depth_limit=max_depth)
        learn_rate = torch.tensor(tp.learn_rate, dtype=torch.float32,
                                  device=dev)
        sample_rate = float(p["sample_rate"])
        seed = int(p["seed"]) if int(p["seed"]) >= 0 else 0xDEC0DE
        ntrees = int(p["ntrees"])
        output = {"category": category, "response": y, "names": list(x),
                  "nclasses": rc.cardinality if rc.is_categorical else 1,
                  "domain": rc.domain}

        dist = get_distribution("bernoulli" if category ==
                                ModelCategory.BINOMIAL else dist_name)
        yv = np.nan_to_num(rc.to_numpy()).astype(np.float32)
        # host weighted mean from the weight mirror — no device sync
        mean_y = (float(np.sum(yv * wh_host))
                  / max(float(np.sum(wh_host)), 1e-12))
        y_dev = torch.from_numpy(frame.local_rows(yv)).to(dev)
        f0 = np.float32(dist.init_margin(mean_y))
        output["init_f"] = float(f0)
        margin = torch.full((bm.bins.shape[0],), float(f0),
                            dtype=torch.float32, device=dev)

        trees: List[Tree] = []
        gains = torch.zeros(len(x), dtype=torch.float32, device=dev)
        for t in range(ntrees):
            gen = tree_generator(seed, t, dev)
            row_gen = (tree_generator(seed, t, dev, mesh.rank)
                       if frame.partitioned else gen)
            tree, margin, gain = boost_step(
                bm, y_dev, w, margin, gen, dist=dist, tp=tp, sc=sc,
                learn_rate=learn_rate, sample_rate=sample_rate,
                row_gen=row_gen, mesh=mesh)
            gains = gains + gain
            trees.append(tree)
        forest = stack_trees(trees)

        model = GBMModel(p, output, forest, bm, f0, dist_name)
        mfin = model._margins(bm)
        if category == ModelCategory.BINOMIAL:
            model.training_metrics = mm.binomial_metrics(
                dist.link_inv(mfin), y_dev, w, mesh=mesh)
            model.output["default_threshold"] = \
                model.training_metrics["max_f1_threshold"]
        else:
            model.training_metrics = mm.regression_metrics(
                dist.link_inv(mfin), y_dev, w,
                deviance_fn=lambda yy, pp: dist.deviance(yy, mfin),
                mesh=mesh)
        model.output["scoring_history"] = []
        # scaled relative importance (hex/VarImp semantics)
        vi = fetch(gains)
        order = np.argsort(-vi)
        tot = vi.sum() or 1.0
        model.output["varimp"] = [
            (x[i], float(vi[i]), float(vi[i] / max(vi.max(), 1e-12)),
             float(vi[i] / tot)) for i in order]
        return model
