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
The draws differ from the reference's ``jax.random`` bits. So a
checkpoint restart draws tree t of its new part as tree prior_T + t of
one longer fit, and a ``max_runtime_secs`` cap that does not bind
leaves the forest as it is without one (``Deadline`` waits for the
device only when a cap is set).

The training surface around the loop (gbm.py:736-1258 of the
reference): ``offset_column`` (a per-row base margin; f0 is the Newton
solve of the offset-adjusted prior), ``monotone_constraints`` and
``interaction_constraints`` (``grow_tree``'s per-node bounds and
per-path feature sets), ``checkpoint`` (rebinned with the donor's edges,
margins resumed from its forest), ``max_runtime_secs``, cross-validation
(``ml/cv.py``'s fast path: ``cv_fold_masking``) and calibration
(``ml/calibration.py``).

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

import types
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
from h2o3_tpu_torch.models.distribution import get_distribution
from h2o3_tpu_torch.models.model import (Deadline, EarlyStopper, Model,
                                         ModelBuilder, ModelCategory,
                                         adapt_domain, check_donor,
                                         infer_category, masked_weights,
                                         prior_trees, require_local,
                                         resolve_checkpoint_model, rowwise)
from h2o3_tpu_torch.models.tree import (Tree, TreeParams, _tree_at,
                                        bucket_depth, concat_forests,
                                        feature_frequencies_frame,
                                        grow_tree, grow_trees_batched,
                                        keep_layout,
                                        leaf_assignment_frame,
                                        predict_forest, predict_tree,
                                        scalars_of, stack_trees)
from h2o3_tpu_torch.parallel.device import fetch
from h2o3_tpu_torch.parallel.map_reduce import all_reduce
from h2o3_tpu_torch.parallel.mesh import fetch_replicated

# SharedTree's checkpoint-non-modifiable parameters: structural knobs a
# restart cannot change without invalidating the donor's trees or edges
CHECKPOINT_NON_MODIFIABLE = ("max_depth", "min_rows", "nbins",
                             "nbins_cats", "sample_rate")


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
               mesh=None, constraints=None, interaction_sets=None):
    """One boosting iteration on the device, with no host sync on one
    device: gradients → row/column samples → one tree → learning-rate-
    scaled leaves → margin update. Returns (tree, margin,
    gain_by_feature). Row draws come from ``row_gen`` (default ``gen``);
    on a sharded ``mesh`` the rows are this rank's. ``constraints`` and
    ``interaction_sets`` go to ``grow_tree``."""
    g = dist.grad(y, margin)
    h = dist.hess(y, margin)
    ws = _sample_rows(w, row_gen or gen, sample_rate)
    col_mask = _sample_columns(gen, bm.bins.shape[1], tp.col_sample_rate,
                               margin.device)
    tree, nid, gain = grow_tree(bm.bins, bm.nbins, ws, g, h, col_mask,
                                params=tp, scalars=sc, mesh=mesh,
                                constraints=constraints,
                                interaction_sets=interaction_sets)
    tree = tree._replace(leaf=learn_rate * tree.leaf)
    return tree, margin + tree.leaf[nid.long()], gain


def boost_step_multi(bm: BinnedMatrix, y_int, w, margins,
                     gen: torch.Generator, *, tp: TreeParams, sc,
                     learn_rate: torch.Tensor, sample_rate: float,
                     row_gen: Optional[torch.Generator] = None, mesh=None,
                     interaction_sets=None):
    """One multinomial iteration (gbm.py:361-394): one row and one column
    sample, the softmax of the iteration's starting margins [N, K], then
    K class trees on g_k = p_k - 1[y=k], h_k = p_k(1 - p_k), each
    learning-rate scaled into margin column k and each with its own
    interaction-set allowance. No host sync on one device. Returns (the
    K trees, margins, gain_by_feature)."""
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
                                    scalars=sc, mesh=mesh,
                                    interaction_sets=interaction_sets)
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


def frame_offset(frame: Frame, column: Optional[str]):
    """The per-row margin offset of ``frame``'s ``column`` on this rank's
    rows (NA → 0), or None without one."""
    if not column or column not in frame:
        return None
    o = np.nan_to_num(frame.col(column).host_view()).astype(np.float32)
    return torch.from_numpy(frame.local_rows(o)).to(frame.device)


def offset_init(dist, y, w, off, mean_y: float, mesh=None) -> np.float32:
    """f0 with the offset in place: 25 Newton steps from the prior on the
    weighted float32 gradient and hessian sums over every rank's rows
    (the reference's DistributionFactory init task role); one host
    read."""
    c = torch.tensor(dist.init_margin(mean_y), dtype=torch.float32,
                     device=w.device)
    for _ in range(25):
        s = torch.stack([torch.sum(w * dist.grad(y, off + c)),
                         torch.sum(w * dist.hess(y, off + c))])
        gsum, hsum = all_reduce(s, mesh)
        c = c - gsum / torch.clamp_min(hsum, 1e-12)
    return np.float32(c.item())


def build_constraints(p, x: Sequence[str], frame: Frame, category: str,
                      device) -> Optional[torch.Tensor]:
    """Monotone constraints [F] int8 in {-1, 0, +1} on ``device``, or
    None (GBM.java monotone_constraints: numeric features only, not for
    multinomial). Takes the dict form and h2o-py's KeyValue list
    ``[{'key': col, 'value': ±1}, ...]``."""
    mc = p.get("monotone_constraints") or {}
    if isinstance(mc, (list, tuple)):
        mc = {kv["key"]: kv["value"] for kv in mc}
    if not mc:
        return None
    unknown_cols = set(mc) - set(x)
    if unknown_cols:
        raise ValueError(f"monotone_constraints columns not in "
                         f"predictors: {sorted(unknown_cols)}")
    bad = [c for c in mc if frame.col(c).is_categorical]
    if bad:
        raise ValueError("monotone_constraints require numeric "
                         f"columns; categorical: {sorted(bad)}")
    if category == ModelCategory.MULTINOMIAL:
        raise ValueError("monotone_constraints are not supported "
                         "for multinomial distributions")
    arr = np.zeros(len(x), np.int8)
    for c, d in mc.items():
        arr[list(x).index(c)] = int(np.sign(d))
    return torch.from_numpy(arr).to(device)


def build_interaction_sets(p, x: Sequence[str],
                           device) -> Optional[torch.Tensor]:
    """Interaction-constraint sets [S, F] bool on ``device``, or None
    (hex/tree/GlobalInteractionConstraints): listed groups may interact
    within themselves; every unlisted feature is a set of its own."""
    ic = p.get("interaction_constraints")
    if not ic:
        return None
    x = list(x)
    listed = {c for grp in ic for c in grp}
    unknown_cols = listed - set(x)
    if unknown_cols:
        raise ValueError("interaction_constraints columns not in "
                         f"predictors: {sorted(unknown_cols)}")
    groups = [list(grp) for grp in ic] + [[c] for c in x if c not in listed]
    S = np.zeros((len(groups), len(x)), bool)
    for si, grp in enumerate(groups):
        for c in grp:
            S[si, x.index(c)] = True
    return torch.from_numpy(S).to(device)


class GBMModel(Model):
    algo = "gbm"

    def __init__(self, params, output, forest: Tree, bm: BinnedMatrix,
                 f0, dist_name: str):
        super().__init__(params, output)
        # [T(*K), D, Lmax] stacked, t-major; past the last depth bucket
        # a HeapTree forest [T(*K), 2^D - 1] (tree.keep_layout)
        self.forest = forest
        self.bm = bm                  # training binning (edges reused to score)
        self.f0 = f0                  # np.float32, or [K] for multinomial
        self.dist_name = dist_name

    @property
    def multinomial(self) -> bool:
        return self.output["category"] == ModelCategory.MULTINOMIAL

    @property
    def n_class_trees(self) -> int:
        """Trees an iteration: K for multinomial, else 1."""
        return self.output["nclasses"] if self.multinomial else 1

    def _margins(self, bm: BinnedMatrix, offset=None) -> torch.Tensor:
        """Margins [N], or [N, K] for multinomial (class k's trees are
        rows k, K + k, 2K + k, ... of the forest), plus the per-row
        ``offset``."""
        B = bm.nbins_total
        if not self.multinomial:
            m = float(self.f0) + predict_forest(self.forest, bm.bins, B)
            return m if offset is None else m + offset
        K = self.output["nclasses"]
        T = self.forest.feat.shape[0] // K
        outs = [predict_forest(type(self.forest)(
            *(a.reshape((T, K) + a.shape[1:])[:, k] for a in self.forest)),
            bm.bins, B) for k in range(K)]
        f0 = torch.as_tensor(np.asarray(self.f0, np.float32),
                             device=bm.bins.device)
        m = f0[None, :] + torch.stack(outs, dim=1)
        return m if offset is None else m + offset[:, None]

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

    def _frame_margins(self, frame: Frame) -> torch.Tensor:
        """Margins of the rows on this rank's device, with the frame's
        offset column (hex/Model applies the offset at scoring too)."""
        return self._margins(rebin_for_scoring(self.bm, frame),
                             frame_offset(frame,
                                          self.params.get("offset_column")))

    def _serve_input(self, frame: Frame) -> torch.Tensor:
        """The rows binned with the training edges: the device input of
        ``_serve_dev`` (the serving engine's prep too)."""
        return rebin_for_scoring(self.bm, frame).bins

    def _serve_dev(self, bins: torch.Tensor) -> torch.Tensor:
        """The device half of scoring, shared by ``predict`` (without an
        offset) and the serving engine: p1, [N, K] class probabilities
        or the response of binned rows."""
        B = self.bm.nbins_total
        return rowwise(lambda b: self._link(self._margins(
            types.SimpleNamespace(bins=b, nbins_total=B))), bins)

    def _serve_finish(self, fetched: np.ndarray, n: int
                      ) -> Dict[str, np.ndarray]:
        """The host half of scoring: the prediction columns of the first
        ``n`` rows of ``_serve_dev``'s fetched output."""
        return self._columns(fetched[:n])

    def _score_dev(self, frame: Frame) -> torch.Tensor:
        """Predictions of the rows on this rank's device, left there: p1,
        [N, K] class probabilities, or the response."""
        off = frame_offset(frame, self.params.get("offset_column"))
        if off is None:
            return self._serve_dev(self._serve_input(frame))
        return self._link(self._frame_margins(frame))

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        pred = fetch_replicated(self._score_dev(frame), frame.mesh)
        return self._serve_finish(pred, frame.nrows)

    def _score_local(self, frame: Frame) -> Dict[str, np.ndarray]:
        return self._columns(
            fetch(self._score_dev(frame))[:frame.local_nrows])

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

    def predict_leaf_node_assignment(self, frame: Frame) -> Frame:
        """Per-tree terminal node ids (h2o-py predict_leaf_node_assignment
        with type Node_ID); per-class columns T{t}.C{k} for a classifier."""
        return leaf_assignment_frame(self, frame)

    def feature_frequencies(self, frame: Frame) -> Frame:
        """Per-row feature usage counts on the decision paths (h2o-py
        feature_frequencies)."""
        return feature_frequencies_frame(self, frame)

    def staged_predict_proba(self, frame: Frame) -> Frame:
        """Probabilities (or the response) after each iteration (h2o-py
        staged_predict_proba): T{t}.C{k} per class for multinomial, T{t}.C1
        = p0 for binomial (the reference's first-class convention), T{t}
        for regression; offsets added. The margins stay on the device,
        with one fetch at the end; each stage adds f0 to the running sum
        of the trees, as ``predict`` adds it to the forest's, so the last
        stage is ``predict``'s."""
        require_local(frame, self.algo)
        bm = rebin_for_scoring(self.bm, frame)
        n = frame.nrows
        B = bm.nbins_total
        K = self.n_class_trees
        T = self.forest.feat.shape[0] // K
        dev = bm.bins.device
        f0 = torch.as_tensor(np.asarray(self.f0, np.float32), device=dev)
        off = frame_offset(frame, self.params.get("offset_column"))
        acc = torch.zeros((bm.bins.shape[0], K), dtype=torch.float32,
                          device=dev)
        stages = []
        for t in range(T):
            acc = acc + torch.stack([
                predict_tree(_tree_at(self.forest, t * K + k), bm.bins, B)
                for k in range(K)], dim=1)
            marg = f0 + acc if self.multinomial else f0 + acc[:, 0]
            if off is not None:
                marg = marg + (off[:, None] if self.multinomial else off)
            stages.append(self._link(marg))
        probs = fetch(torch.stack(stages))[:, :n]
        cat = self.output["category"]
        cols = {}
        for t in range(T):
            if self.multinomial:
                for k in range(K):
                    cols[f"T{t + 1}.C{k + 1}"] = probs[t, :, k]
            elif cat == ModelCategory.BINOMIAL:
                cols[f"T{t + 1}.C1"] = 1.0 - probs[t]       # p0
            else:
                cols[f"T{t + 1}"] = probs[t]
        return Frame.from_numpy(cols, device=frame.device)

    def predict_contributions(self, frame: Frame) -> Frame:
        """TreeSHAP contributions (h2o-py predict_contributions): a column
        a feature and BiasTerm, summing to the link-space margin."""
        if self.multinomial:
            raise ValueError("predict_contributions supports only "
                             "regression and binomial models "
                             "(got Multinomial)")
        return contributions_frame(self, frame, bias_offset=float(self.f0))

    def model_performance(self, frame: Frame, mask_weights=None):
        y = self.output["response"]
        marg = self._frame_margins(frame)
        w = frame.valid_weights()
        wc_name = self.params.get("weights_column")
        if wc_name and wc_name in frame:
            wc = frame.col(wc_name).numeric_view()
            w = w * torch.where(torch.isnan(wc), 0.0, wc)
        w = masked_weights(w, mask_weights)
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
    or the training rows, cross-validation, checkpoint restarts, an
    offset column, monotone and interaction constraints, a runtime cap
    and calibration. Parameters outside ``PORTED`` keep the reference's
    names and defaults; setting one away from its default raises
    ``NotImplementedError``, as does ``distribution="custom"``."""

    algo = "gbm"
    label = "GBM"
    SHARDED = True
    cv_fold_masking = True

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
        "ignored_columns", "tweedie_power", "quantile_alpha", "huber_alpha",
        "stopping_rounds", "stopping_tolerance", "score_tree_interval",
        "max_runtime_secs",
        "nfolds", "fold_column", "fold_assignment",
        "keep_cross_validation_models", "checkpoint", "offset_column",
        "monotone_constraints", "interaction_constraints",
        "calibrate_model", "calibration_frame", "calibration_method",
        "custom_distribution_func", "keep_cross_validation_predictions",
        "keep_cross_validation_fold_assignment"))

    def _resolve_distribution(self, category: str) -> str:
        d = str(self.params["distribution"]).lower()
        if d != "auto":
            return d
        return {"Binomial": "bernoulli", "Multinomial": "multinomial",
                "Regression": "gaussian"}[category]

    @staticmethod
    def _validation_inputs(vframe: Frame, bm: BinnedMatrix, rc, y: str):
        """(binned matrix, response, weights) of the validation frame's
        rows on its device: the training binning, the response in the
        training domain (class codes; NA and unseen levels weigh 0)."""
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
        return vbm, vy, vw

    def _train_weights(self, frame: Frame, y: str):
        """(device weights, host weight mirror) of the rows that train:
        the weights column, the CV fold mask and the response's NAs; a
        constant numeric response raises first."""
        p = self.params
        w = frame.valid_weights()
        if p.get("weights_column"):
            wc = frame.col(p["weights_column"]).numeric_view()
            w = w * torch.where(torch.isnan(wc), 0.0, wc)
        w = self._cv_masked_weights(w, frame)
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
            w = w * torch.from_numpy(keep).to(frame.device)
        return w, wh_host

    def _donor(self, x, y, category: str, dist_name: str):
        """The checkpoint model this fit continues, checked, or None."""
        ck = self.params.get("checkpoint")
        if ck is None:
            return None
        donor = resolve_checkpoint_model("gbm", ck, GBMModel)
        check_donor("gbm", donor, y=y, x=x, category=category,
                    params=self.params, fields=CHECKPOINT_NON_MODIFIABLE,
                    dist_name=(donor.dist_name, dist_name))
        return donor

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None):
        p = self.params
        dev = frame.device
        mesh = frame.mesh
        category = infer_category(frame, y)
        multinomial = category == ModelCategory.MULTINOMIAL
        dist_name = ("multinomial" if multinomial
                     else self._resolve_distribution(category))
        # near leave-one-out CV folds (ml/cv.py): no training metrics,
        # varimp or threshold, whose host reads each fold would pay
        light = bool(getattr(self, "_cv_light", False))
        ckpt = self._donor(x, y, category, dist_name)

        w, wh_host = self._train_weights(frame, y)
        rc = frame.col(y)
        shared_bm = getattr(self, "_cv_shared_bm", None)
        if ckpt is not None:
            # the donor's edges keep its trees valid
            bm = rebin_for_scoring(ckpt.bm, frame)
        elif shared_bm is not None:
            bm = shared_bm          # a CV fold: the main model's binning
        else:
            # weighted edges: the row-weight ≡ row-multiplicity contract
            # must hold through the bin sketch too
            bm = bin_frame(frame, x, nbins=p["nbins"],
                           nbins_cats=p["nbins_cats"], weights=wh_host)
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
        constraints = build_constraints(p, x, frame, category, dev)
        interaction_sets = build_interaction_sets(p, x, dev)
        seed = int(p["seed"]) if int(p["seed"]) >= 0 else 0xDEC0DE
        ntrees = int(p["ntrees"])
        prior_T = 0
        if ckpt is not None:
            prior_T = prior_trees("gbm", ckpt, ckpt.n_class_trees, ntrees)
            ntrees -= prior_T
        deadline = Deadline(p.get("max_runtime_secs"), dev)
        output = {"category": category, "response": y, "names": list(x),
                  "nclasses": rc.cardinality if rc.is_categorical else 1,
                  "domain": rc.domain}

        off = None
        if multinomial:
            K = rc.cardinality
            codes = np.nan_to_num(rc.to_numpy()).astype(np.int32)
            y_dev = torch.from_numpy(frame.local_rows(codes)).to(dev)
            if ckpt is not None:
                f0 = ckpt.f0
                margin = ckpt._margins(bm)
            else:
                # weighted class priors over the rows that train, from
                # the host weight mirror (no device sync)
                counts = np.bincount(codes, weights=wh_host,
                                     minlength=K).astype(np.float64)
                pri = np.clip(counts / max(counts.sum(), 1e-12), 1e-10, 1.0)
                f0 = np.log(pri).astype(np.float32)
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
            # offset_column: a per-row base margin (GBM.java offset
            # handling), f0 solved with it in place
            off = frame_offset(frame, p.get("offset_column"))
            if ckpt is not None:
                f0 = ckpt.f0
                margin = ckpt._margins(bm, off)
            elif off is None:
                f0 = np.float32(dist.init_margin(mean_y))
                margin = torch.full((bm.bins.shape[0],), float(f0),
                                    dtype=torch.float32, device=dev)
            else:
                f0 = offset_init(dist, y_dev, w, off, mean_y, mesh)
                margin = off + float(f0)
            output["init_f"] = float(f0)

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
            vbm, vy, vw = self._validation_inputs(validation_frame, bm, rc,
                                                  y)
            voff = (None if multinomial else frame_offset(
                validation_frame, p.get("offset_column")))
            if ckpt is not None:    # the donor forest's part included
                vmargin = ckpt._margins(vbm, voff)
            else:
                vmargin = torch.as_tensor(np.asarray(f0, np.float32),
                                          device=dev).expand(
                    (vbm.bins.shape[0],) + margin.shape[1:]).contiguous()
                if voff is not None:
                    vmargin = vmargin + voff
            val = (vbm.bins, vy, vw, validation_frame.mesh)

        trees: List[Tree] = []
        gains = torch.zeros(len(x), dtype=torch.float32, device=dev)
        for t in range(ntrees):
            # tree t of a restart is tree prior_T + t of one longer fit
            gen = tree_generator(seed, prior_T + t, dev)
            row_gen = (tree_generator(seed, prior_T + t, dev, mesh.rank)
                       if frame.partitioned else gen)
            kw = dict(tp=tp, sc=sc, learn_rate=learn_rate,
                      sample_rate=sample_rate, row_gen=row_gen, mesh=mesh,
                      interaction_sets=interaction_sets)
            if multinomial:
                step, margin, gain = boost_step_multi(bm, y_dev, w, margin,
                                                      gen, **kw)
            else:
                tree, margin, gain = boost_step(bm, y_dev, w, margin, gen,
                                                dist=dist,
                                                constraints=constraints,
                                                **kw)
                step = [tree]
            # a tree past the last depth bucket is kept without its
            # layout's padding (tree.keep_layout)
            trees += [keep_layout(s) for s in step]
            gains = gains + gain
            if stopper.enabled:
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
            job_update(1.0 / ntrees, f"tree {t + 1}/{ntrees}")
            if deadline.passed():
                break
        forest = stack_trees(trees)
        if ckpt is not None:
            forest = concat_forests([ckpt.forest, forest])

        model = GBMModel(p, output, forest, bm, f0, dist_name)
        model.output["scoring_history"] = scoring_history
        if light:
            model.output["default_threshold"] = 0.5
            model.output["varimp"] = None
        else:
            self._training_tail(model, bm, off, y_dev, w, dist, x, gains,
                                mesh)
        maybe_calibrate(model, p, category)
        return model

    @staticmethod
    def _training_tail(model: GBMModel, bm, off, y_dev, w, dist, x,
                       gains, mesh, mfin=None) -> None:
        """Training metrics from the forest (margins recomputed tree by
        tree: the loop's may include trees early stopping dropped; or
        ``mfin``, the same values made another way), the max-F1
        threshold and the scaled relative importance."""
        if mfin is None:
            mfin = model._margins(bm, off)
        pfin = model._link(mfin)
        category = model.output["category"]
        if model.multinomial:
            model.training_metrics = mm.multinomial_metrics(
                pfin, y_dev, w, mesh=mesh, domain=model.output["domain"])
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
        # scaled relative importance (hex/VarImp semantics)
        vi = fetch(gains)
        order = np.argsort(-vi)
        tot = vi.sum() or 1.0
        model.output["varimp"] = [
            (x[i], float(vi[i]), float(vi[i] / max(vi.max(), 1e-12)),
             float(vi[i] / tot)) for i in order]


# ---- model-batched training (parallel/model_batch.py's GBM trainer) ----

# bytes one model of a batch takes per (node, feature, bin) of its deepest
# level (that level's histogram, the previous level's, the left-child
# histogram and its int64 accumulator: 12 + 6 + 6 + 12 over its L nodes)
# and per row (node ids, stats, weights, gradients, margin, temporaries)
_LEVEL_CELL_BYTES = 36
_ROW_BYTES = 64


def models_per_pass(n_rows: int, n_feat: int, n_bins: int, depth: int,
                    device) -> Optional[int]:
    """How many models' trees one level loop grows at once on ``device``:
    half the card's free memory (``torch.cuda.mem_get_info``) over one
    model's peak at the layout depth, at least 1; None (all) on the CPU.
    A depth-20 model alone takes ~24 GB at its last level (F = 10,
    B = 126), so a deep bucket trains a few models a pass."""
    if device.type != "cuda":
        return None
    L = 2 ** max(depth - 1, 0)
    W = max(1, (n_bins - 1 + 31) // 32)
    per = (_LEVEL_CELL_BYTES * L * n_feat * n_bins
           + depth * L * (11 + 4 * W) + 8 * 2 ** depth + _ROW_BYTES * n_rows)
    return max(1, int(torch.cuda.mem_get_info(device)[0] // 2 // per))


def mean_deviances(devs, w) -> List[float]:
    """``mean_deviance`` of each model's per-row deviances ``devs`` (one
    [N] tensor a model, one device) with one host read for all: each
    model's two sums are the ones ``mean_deviance`` takes."""
    s = torch.stack([torch.stack([w * d, w]).to(torch.float64).sum(dim=1)
                     for d in devs]).cpu().tolist()
    return [tot / max(sw, 1e-12) for tot, sw in s]


def fit_gbm_batched(builder_cls, params_list: List[dict], frame: Frame,
                    y: Optional[str] = None,
                    x: Optional[Sequence[str]] = None,
                    validation_frame: Optional[Frame] = None
                    ) -> List[GBMModel]:
    """Train a shape bucket of GBM combos together (reference:
    h2o3_tpu/models/gbm.py ``fit_gbm_batched``, one ``vmap`` of its
    boosting scan): one preamble (weights, binning, the initial margin,
    the offset), then per tree each live model's gradients and samples
    and ONE level loop for all of them (``tree.grow_trees_batched``: the
    model-axis kernels, a launch a level for the whole bucket).

    Every model is its sequential ``GBMEstimator._fit``, bit for bit:
    the same preamble, its own ``tree_generator(seed, t)`` draws, the
    same tree arithmetic, and early stopping at the same tree. The
    scoring events of all live models share one host read; a model that
    stops leaves the batch (the others' bits do not depend on it). A
    bucket whose deepest level would not fit in half the card's free
    memory trains ``models_per_pass`` models a pass.

    Raises ``parallel.model_batch.BatchIneligible`` where the batch
    cannot express the fit (the reference's cases: a structural knob that
    varies, CV, a checkpoint, a custom distribution, a runtime cap,
    ``max_depth`` across depth buckets, multinomial, early stopping on a
    validation frame; and a frame partitioned over a mesh), and where a
    combo would fail on its own (``model_batch.combo_errors``: its
    checks and host preamble). Models come back in ``params_list``
    order, not stored in the DKV."""
    from h2o3_tpu_torch.parallel.model_batch import (BATCHABLE_KNOBS,
                                                     BatchIneligible,
                                                     combo_errors)
    with combo_errors():
        builders = [builder_cls(**p) for p in params_list]
        M = len(builders)
        b0 = builders[0]
        p0 = b0.params
        batchable = BATCHABLE_KNOBS["gbm"]
        for b in builders[1:]:
            for k, v in b.params.items():
                if k not in batchable and v != p0.get(k):
                    raise BatchIneligible(f"structural param '{k}' varies")
        for b in builders:
            p = b.params
            if int(p.get("nfolds") or 0) >= 2 or p.get("fold_column"):
                raise BatchIneligible("cross-validation")
            if p.get("checkpoint") is not None:
                raise BatchIneligible("checkpoint restart")
            if p.get("custom_distribution_func") or \
                    str(p.get("distribution")).lower() == "custom":
                raise BatchIneligible("custom distribution")
            if float(p.get("max_runtime_secs") or 0.0) > 0:
                raise BatchIneligible("per-model runtime cap")
        depths = [int(b.params["max_depth"]) for b in builders]
        if len({bucket_depth(d) for d in depths}) != 1:
            raise BatchIneligible("max_depth spans depth buckets")
        if frame.partitioned:
            raise BatchIneligible("frame partitioned over a mesh")
        x = b0.resolve_x(frame, x, y)
        category = infer_category(frame, y)
        if category == ModelCategory.MULTINOMIAL:
            raise BatchIneligible("multinomial (per-class tree loop)")
        dist_name = b0._resolve_distribution(category)
        stopper_on = int(p0["stopping_rounds"]) > 0
        if stopper_on and validation_frame is not None:
            raise BatchIneligible("validation-frame early stopping")

        # ---- the shared preamble (GBMEstimator._fit's, once) -------------
        dev = frame.device
        mesh = frame.mesh
        w, wh_host = b0._train_weights(frame, y)
        rc = frame.col(y)
        bm = bin_frame(frame, x, nbins=p0["nbins"],
                       nbins_cats=p0["nbins_cats"], weights=wh_host)
        w, w_scale = b0._normalize_uniform_weights(w, wh_host)
        if w_scale != 1.0:
            wh_host = wh_host / np.float32(w_scale)
        dist = get_distribution(
            "bernoulli" if category == ModelCategory.BINOMIAL else dist_name,
            **p0)
        yv = np.nan_to_num(rc.to_numpy()).astype(np.float32)
        mean_y = (float(np.sum(yv * wh_host))
                  / max(float(np.sum(wh_host)), 1e-12))
        y_dev = torch.from_numpy(frame.local_rows(yv)).to(dev)
        off = frame_offset(frame, p0.get("offset_column"))
        if off is None:
            f0 = np.float32(dist.init_margin(mean_y))
            margin0 = torch.full((bm.bins.shape[0],), float(f0),
                                 dtype=torch.float32, device=dev)
        else:
            f0 = offset_init(dist, y_dev, w, off, mean_y, mesh)
            margin0 = off + float(f0)
        output = {"category": category, "response": y, "names": list(x),
                  "nclasses": rc.cardinality if rc.is_categorical else 1,
                  "domain": rc.domain, "init_f": float(f0)}
        constraints = build_constraints(p0, x, frame, category, dev)
        interaction_sets = build_interaction_sets(p0, x, dev)

    # ---- per-model knobs ---------------------------------------------
    D = bucket_depth(depths[0])
    tp = TreeParams(max_depth=D, nbins_total=bm.nbins_total,
                    cat_feats=tuple(bool(v) for v in bm.is_cat))
    f32 = dict(dtype=torch.float32, device=dev)
    knobs = torch.tensor([[float(b.params["min_rows"]) / w_scale,
                           float(b.params["reg_lambda"]) / w_scale,
                           float(b.params["min_split_improvement"])
                           / w_scale] for b in builders], **f32)
    depth_limit = torch.tensor(depths, dtype=torch.int32, device=dev)
    learn_rate = torch.tensor([float(b.params["learn_rate"])
                               for b in builders], **f32)
    seeds = [int(b.params["seed"]) if int(b.params["seed"]) >= 0
             else 0xDEC0DE for b in builders]
    ntrees = int(p0["ntrees"])
    interval = int(p0["score_tree_interval"]) or 5
    stoppers = [EarlyStopper(int(p0["stopping_rounds"]),
                             float(p0["stopping_tolerance"]))
                for _ in range(M)]
    histories: List[List[dict]] = [[] for _ in range(M)]
    margins = [margin0] * M
    # each model's forest on its training rows, summed tree by tree from
    # zero as predict_forest sums it: the leaf values its rows fell in
    # while growing are the ones predict_tree routes them to
    scores = [torch.zeros_like(margin0) for _ in range(M)]
    trees: List[List[Tree]] = [[] for _ in range(M)]
    gains = [torch.zeros(len(x), **f32) for _ in range(M)]
    N, F = bm.bins.shape
    per_pass = models_per_pass(N, F, bm.nbins_total, D, dev) or M
    alive = list(range(M))
    for t in range(ntrees):
        for lo in range(0, len(alive), per_pass):
            part = alive[lo:lo + per_pass]
            ws, gs, hs, cms = [], [], [], []
            for m in part:
                gen = tree_generator(seeds[m], t, dev)
                gs.append(dist.grad(y_dev, margins[m]))
                hs.append(dist.hess(y_dev, margins[m]))
                ws.append(_sample_rows(w, gen, float(
                    builders[m].params["sample_rate"])))
                cms.append(_sample_columns(gen, F, float(
                    builders[m].params["col_sample_rate_per_tree"]), dev))
            idx = torch.tensor(part, device=dev)
            tb, nid, gb = grow_trees_batched(
                bm.bins, bm.nbins, torch.stack(ws), torch.stack(gs),
                torch.stack(hs), torch.stack(cms), params=tp,
                knobs=knobs.index_select(0, idx),
                depth_limit=depth_limit.index_select(0, idx),
                constraints=constraints, interaction_sets=interaction_sets)
            leaf = learn_rate.index_select(0, idx)[:, None] * tb.leaf
            for j, m in enumerate(part):
                tree = _tree_at(tb, j)._replace(leaf=leaf[j])
                v = leaf[j][nid[j].long()]
                margins[m] = margins[m] + v
                scores[m] = scores[m] + v
                trees[m].append(keep_layout(tree))
                gains[m] = gains[m] + gb[j]
        if stopper_on and (t + 1) % interval == 0:
            devs = mean_deviances([dist.deviance(y_dev, margins[m])
                                   for m in alive], w)
            for m, dv in zip(list(alive), devs):
                histories[m].append({"ntrees": t + 1, "deviance": dv})
                if stoppers[m].should_stop(dv):
                    alive.remove(m)
        job_update(1.0 / ntrees, f"tree {t + 1}/{ntrees} of {M} models")
        if not alive:
            break

    models = []
    for m, b in enumerate(builders):
        model = GBMModel(b.params, dict(output), stack_trees(trees[m]), bm,
                         f0, dist_name)
        model.output["scoring_history"] = histories[m]
        mfin = float(f0) + scores[m]       # GBMModel._margins' arithmetic
        GBMEstimator._training_tail(model, bm, off, y_dev, w, dist, x,
                                    gains[m], mesh,
                                    mfin if off is None else mfin + off)
        maybe_calibrate(model, b.params, category)
        if validation_frame is not None:
            model.validation_metrics = model.model_performance(
                validation_frame)
        models.append(model)
    return models
