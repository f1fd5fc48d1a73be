"""GBM — gradient boosting machine: binomial, multinomial and regression.

Reference: h2o3_tpu/models/gbm.py (hex/tree/gbm/GBM.java): per iteration
compute gradients, grow one tree through the level kernels (K class
trees on softmax gradients for a multinomial response), scale its
leaves by the learning rate and update the margins. The reference runs
the iterations as compiled scans; here the plain loop of its fit runs
eagerly on the frame's device, and the metrics tail (gbm.py:1225-1256)
runs once at the end.

Early stopping (``stopping_rounds`` > 0): every ``score_tree_interval``
trees (5 when 0) the weighted mean deviance of the validation frame, or
of the training rows without one, goes into ``scoring_history`` and the
``EarlyStopper``; the fit stops right after the tree at which it fires,
as the reference's ``_stop_point`` truncates its scored scans. Each
scoring event reads one number on the host; without stopping the loop
makes no host sync.

Random numbers: each iteration draws its row and column samples from a
``torch.Generator`` seeded from (seed, tree index) — the reference's
``_tree_keys`` contract that a tree's randomness depends on its global
index only — and a multinomial iteration's K class trees share them.
The draws differ from the reference's ``jax.random`` bits.

Data-parallel fit: on a frame partitioned over a sharded mesh
(``Frame.from_numpy_partitioned``) every rank runs this same loop on its
own rows; ``grow_tree`` sums each level's histogram and the leaf sums
over the ranks, so every rank grows the same trees. What must agree
across ranks comes from host views of all rows (f0 and the class priors,
the bin edges) or from the tree's generator, seeded alike on every rank
(the column masks); row draws come from a generator seeded from (seed,
tree, rank).
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
from h2o3_tpu_torch.models.model import (EarlyStopper, Model, ModelBuilder,
                                         ModelCategory, adapt_domain,
                                         infer_category)
from h2o3_tpu_torch.models.tree import (Tree, TreeParams, bucket_depth,
                                        grow_tree, predict_forest,
                                        predict_tree, scalars_of,
                                        stack_trees)
from h2o3_tpu_torch.parallel.device import fetch
from h2o3_tpu_torch.parallel.map_reduce import all_reduce
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


def _sample_rows(w, gen: torch.Generator, rate: float):
    """Row-sampled weights (sample_rate): a uniform draw a row."""
    if rate >= 1.0:
        return w
    keep = torch.rand(w.shape[0], generator=gen, device=w.device) \
        < max(rate, 0.0)
    return w * keep.to(torch.float32)


def boost_step(bm: BinnedMatrix, y, w, margin, gen: torch.Generator, *,
               dist, tp: TreeParams, sc, learn_rate: torch.Tensor,
               sample_rate: float, row_gen: Optional[torch.Generator] = None,
               mesh=None):
    """One boosting iteration on the device, with no host sync on one
    device: gradients → row/column samples → one tree → learning-rate-
    scaled leaves → margin update. Returns (tree, margin,
    gain_by_feature). Row draws come from ``row_gen`` (default ``gen``);
    on a sharded ``mesh`` the rows are this rank's."""
    g = dist.grad(y, margin)
    h = dist.hess(y, margin)
    ws = _sample_rows(w, row_gen or gen, sample_rate)
    col_mask = _sample_columns(gen, bm.bins.shape[1], tp.col_sample_rate,
                               margin.device)
    tree, nid, gain = grow_tree(bm.bins, bm.nbins, ws, g, h, col_mask,
                                params=tp, scalars=sc, mesh=mesh)
    tree = tree._replace(leaf=learn_rate * tree.leaf)
    return tree, margin + tree.leaf[nid.long()], gain


def boost_step_multi(bm: BinnedMatrix, y_int, w, margins,
                     gen: torch.Generator, *, tp: TreeParams, sc,
                     learn_rate: torch.Tensor, sample_rate: float,
                     row_gen: Optional[torch.Generator] = None, mesh=None):
    """One multinomial iteration (gbm.py:361-394): one row and one column
    sample, the softmax of the iteration's starting margins [N, K], then
    K class trees on g_k = p_k - 1[y=k], h_k = p_k(1 - p_k), each
    learning-rate scaled into margin column k. No host sync on one
    device. Returns (the K trees, margins, gain_by_feature)."""
    p = torch.softmax(margins, dim=1)
    ws = _sample_rows(w, row_gen or gen, sample_rate)
    col_mask = _sample_columns(gen, bm.bins.shape[1], tp.col_sample_rate,
                               margins.device)
    margins = margins.clone()
    trees, gains = [], 0.0
    for k in range(margins.shape[1]):
        yk = (y_int == k).to(torch.float32)
        pk = p[:, k]
        tree, nid, gain = grow_tree(bm.bins, bm.nbins, ws, pk - yk,
                                    pk * (1.0 - pk), col_mask, params=tp,
                                    scalars=sc, mesh=mesh)
        tree = tree._replace(leaf=learn_rate * tree.leaf)
        margins[:, k] += tree.leaf[nid.long()]
        trees.append(tree)
        gains = gains + gain
    return trees, margins, gains


def mean_deviance(dev_rows, w, mesh=None) -> float:
    """Weighted mean of per-row deviances over every rank's rows (float32
    terms, float64 sums): one host read."""
    s = torch.stack([w * dev_rows, w]).to(torch.float64).sum(dim=1)
    tot, sw = all_reduce(s, mesh).cpu().tolist()
    return tot / max(sw, 1e-12)


def multinomial_deviance(margins, y_int, w, mesh=None) -> float:
    """-2·w·log(clip(p_y, 1e-7)) averaged by weight, p = softmax."""
    py = torch.softmax(margins, dim=1).gather(1, y_int.long()[:, None])[:, 0]
    return mean_deviance(-2.0 * torch.log(torch.clamp(py, 1e-7, 1.0)), w,
                         mesh)


class GBMModel(Model):
    algo = "gbm"

    def __init__(self, params, output, forest: Tree, bm: BinnedMatrix,
                 f0, dist_name: str):
        super().__init__(params, output)
        self.forest = forest          # [T(*K), D, Lmax] stacked, t-major
        self.bm = bm                  # training binning (edges reused to score)
        self.f0 = f0                  # np.float32, or [K] for multinomial
        self.dist_name = dist_name

    @property
    def multinomial(self) -> bool:
        return self.output["category"] == ModelCategory.MULTINOMIAL

    def _margins(self, bm: BinnedMatrix) -> torch.Tensor:
        """Margins [N], or [N, K] for multinomial (class k's trees are
        rows k, K + k, 2K + k, ... of the forest)."""
        B = bm.nbins_total
        if not self.multinomial:
            return float(self.f0) + predict_forest(self.forest, bm.bins, B)
        K = self.output["nclasses"]
        T = self.forest.feat.shape[0] // K
        outs = [predict_forest(Tree(*(a.reshape((T, K) + a.shape[1:])[:, k]
                                      for a in self.forest)), bm.bins, B)
                for k in range(K)]
        f0 = torch.as_tensor(np.asarray(self.f0, np.float32),
                             device=bm.bins.device)
        return f0[None, :] + torch.stack(outs, dim=1)

    def _dist(self):
        """The family scoring uses: bernoulli for a binomial response,
        else the model's own (with its shape parameter)."""
        if self.output["category"] == ModelCategory.BINOMIAL:
            return get_distribution("bernoulli")
        return get_distribution(self.dist_name, **self.params)

    def _link(self, marg: torch.Tensor) -> torch.Tensor:
        if self.multinomial:
            return torch.softmax(marg, dim=1)
        return self._dist().link_inv(marg)

    def _predictions(self, frame: Frame) -> torch.Tensor:
        """Predictions of the rows on this rank's device: p1, [N, K]
        class probabilities, or the response."""
        return self._link(self._margins(rebin_for_scoring(self.bm, frame)))

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
        if self.multinomial:
            out = {"predict": pred.argmax(axis=1).astype(np.int32)}
            out.update({f"p{k}": pred[:, k] for k in range(pred.shape[1])})
            return out
        return {"predict": pred}

    def model_performance(self, frame: Frame):
        y = self.output["response"]
        marg = self._margins(rebin_for_scoring(self.bm, frame))
        w = frame.valid_weights()
        wc_name = self.params.get("weights_column")
        if wc_name and wc_name in frame:
            wc = frame.col(wc_name).numeric_view()
            w = w * torch.where(torch.isnan(wc), 0.0, wc)
        if self.output["category"] == ModelCategory.REGRESSION:
            dist = self._dist()
            yv = frame.col(y).numeric_view()
            w = w * torch.where(torch.isnan(yv), 0.0, 1.0)
            yv = torch.where(torch.isnan(yv), 0.0, yv)
            return mm.regression_metrics(
                dist.link_inv(marg), yv, w,
                deviance_fn=lambda yy, pp: dist.deviance(yy, marg),
                mesh=frame.mesh)
        yv = frame.local_rows(adapt_domain(frame.col(y),
                                           self.output["domain"]), -1)
        w = w * torch.from_numpy((yv >= 0).astype(np.float32)).to(w.device)
        yv = np.maximum(yv, 0)
        if self.multinomial:
            return mm.multinomial_metrics(
                self._link(marg), torch.from_numpy(yv).to(w.device), w,
                mesh=frame.mesh, domain=self.output["domain"])
        yt = torch.from_numpy(yv.astype(np.float32)).to(w.device)
        return mm.binomial_metrics(self._link(marg), yt, w, mesh=frame.mesh)


class GBMEstimator(ModelBuilder):
    """h2o-py H2OGradientBoostingEstimator-compatible surface: binomial,
    multinomial and regression (gaussian, poisson, gamma, tweedie,
    laplace, quantile, huber), with early stopping on a validation frame
    or the training rows. Parameters outside ``PORTED`` keep the
    reference's names and defaults; setting one away from its default
    raises ``NotImplementedError``, as does ``distribution="custom"``."""

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
    # stopping_metric stays unported: the reference stops on the deviance
    # whatever it names
    PORTED = frozenset((
        "ntrees", "max_depth", "min_rows", "learn_rate", "sample_rate",
        "col_sample_rate_per_tree", "nbins", "nbins_cats", "distribution",
        "min_split_improvement", "seed", "reg_lambda", "weights_column",
        "tweedie_power", "quantile_alpha", "huber_alpha", "stopping_rounds",
        "stopping_tolerance", "score_tree_interval"))

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
        if str(merged["distribution"]).lower() == "custom":
            raise NotImplementedError(
                "GBM parameter 'distribution'='custom' is not ported yet: "
                "it resolves an uploaded function through the job/KV layer")
        super().__init__(**merged)

    def _resolve_distribution(self, category: str) -> str:
        d = str(self.params["distribution"]).lower()
        if d != "auto":
            return d
        return {"Binomial": "bernoulli", "Multinomial": "multinomial",
                "Regression": "gaussian"}[category]

    @staticmethod
    def _validation_inputs(vframe: Frame, bm: BinnedMatrix, rc, y: str):
        """(bins, response, weights) of the validation frame's rows on its
        device: the training binning, the response in the training
        domain (class codes; NA and unseen levels weigh 0)."""
        vbm = rebin_for_scoring(bm, vframe)
        vw = vframe.valid_weights()
        vc = vframe.col(y)
        if vc.is_categorical:
            vy = vframe.local_rows(adapt_domain(vc, rc.domain), -1)
            vw = vw * torch.from_numpy((vy >= 0).astype(np.float32)).to(
                vw.device)
            vy = torch.from_numpy(np.maximum(vy, 0)).to(vw.device)
        else:
            v = vc.numeric_view()
            vw = vw * torch.where(torch.isnan(v), 0.0, 1.0)
            vy = torch.where(torch.isnan(v), 0.0, v)
        return vbm.bins, vy, vw

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None):
        p = self.params
        dev = frame.device
        mesh = frame.mesh
        category = infer_category(frame, y)
        multinomial = category == ModelCategory.MULTINOMIAL
        dist_name = ("multinomial" if multinomial
                     else self._resolve_distribution(category))

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

        if multinomial:
            K = rc.cardinality
            codes = np.nan_to_num(rc.to_numpy()).astype(np.int32)
            # weighted class priors over the rows that train, from the
            # host weight mirror (no device sync)
            counts = np.bincount(codes, weights=wh_host,
                                 minlength=K).astype(np.float64)
            pri = np.clip(counts / max(counts.sum(), 1e-12), 1e-10, 1.0)
            f0 = np.log(pri).astype(np.float32)
            y_dev = torch.from_numpy(frame.local_rows(codes)).to(dev)
            margin = torch.as_tensor(f0, device=dev)[None, :].expand(
                bm.bins.shape[0], K).contiguous()
            dist = None
        else:
            dist = get_distribution("bernoulli" if category ==
                                    ModelCategory.BINOMIAL else dist_name,
                                    **p)
            yv = np.nan_to_num(rc.to_numpy()).astype(np.float32)
            # host weighted mean from the weight mirror — no device sync
            mean_y = (float(np.sum(yv * wh_host))
                      / max(float(np.sum(wh_host)), 1e-12))
            y_dev = torch.from_numpy(frame.local_rows(yv)).to(dev)
            f0 = np.float32(dist.init_margin(mean_y))
            output["init_f"] = float(f0)
            margin = torch.full((bm.bins.shape[0],), float(f0),
                                dtype=torch.float32, device=dev)

        def deviance(marg, yy, ww, on_mesh) -> float:
            if multinomial:
                return multinomial_deviance(marg, yy, ww, on_mesh)
            return mean_deviance(dist.deviance(yy, marg), ww, on_mesh)

        stopper = EarlyStopper(int(p["stopping_rounds"]),
                               float(p["stopping_tolerance"]))
        interval = int(p["score_tree_interval"]) or 5
        scoring_history: List[dict] = []
        # early stopping watches the validation frame when given, else
        # the training rows (reference ScoreKeeper semantics)
        val = None
        if validation_frame is not None and stopper.enabled:
            vbins, vy, vw = self._validation_inputs(validation_frame, bm, rc,
                                                    y)
            vmargin = torch.as_tensor(np.asarray(f0, np.float32),
                                      device=dev).expand(
                (vbins.shape[0],) + margin.shape[1:]).contiguous()
            val = (vbins, vy, vw, validation_frame.mesh)

        trees: List[Tree] = []
        gains = torch.zeros(len(x), dtype=torch.float32, device=dev)
        for t in range(ntrees):
            gen = tree_generator(seed, t, dev)
            row_gen = (tree_generator(seed, t, dev, mesh.rank)
                       if frame.partitioned else gen)
            kw = dict(tp=tp, sc=sc, learn_rate=learn_rate,
                      sample_rate=sample_rate, row_gen=row_gen, mesh=mesh)
            if multinomial:
                step, margin, gain = boost_step_multi(bm, y_dev, w, margin,
                                                      gen, **kw)
            else:
                tree, margin, gain = boost_step(bm, y_dev, w, margin, gen,
                                                dist=dist, **kw)
                step = [tree]
            trees += step
            gains = gains + gain
            if not stopper.enabled:
                continue
            if val is not None:
                vmargin = vmargin.clone()
                for k, tree in enumerate(step):
                    v = predict_tree(tree, val[0], bm.nbins_total)
                    if multinomial:
                        vmargin[:, k] += v
                    else:
                        vmargin += v
            if (t + 1) % interval == 0:
                dv = (deviance(vmargin, val[1], val[2], val[3])
                      if val is not None
                      else deviance(margin, y_dev, w, mesh))
                scoring_history.append({"ntrees": t + 1, "deviance": dv})
                if stopper.should_stop(dv):
                    break
        forest = stack_trees(trees)

        model = GBMModel(p, output, forest, bm, f0, dist_name)
        # metrics from the forest (margins recomputed tree by tree)
        mfin = model._margins(bm)
        pfin = model._link(mfin)
        if multinomial:
            model.training_metrics = mm.multinomial_metrics(
                pfin, y_dev, w, mesh=mesh, domain=rc.domain)
        elif category == ModelCategory.BINOMIAL:
            model.training_metrics = mm.binomial_metrics(pfin, y_dev, w,
                                                         mesh=mesh)
            model.output["default_threshold"] = \
                model.training_metrics["max_f1_threshold"]
        else:
            model.training_metrics = mm.regression_metrics(
                pfin, y_dev, w,
                deviance_fn=lambda yy, pp: dist.deviance(yy, mfin),
                mesh=mesh)
        model.output["scoring_history"] = scoring_history
        # scaled relative importance (hex/VarImp semantics)
        vi = fetch(gains)
        order = np.argsort(-vi)
        tot = vi.sum() or 1.0
        model.output["varimp"] = [
            (x[i], float(vi[i]), float(vi[i] / max(vi.max(), 1e-12)),
             float(vi[i] / tot)) for i in order]
        return model
