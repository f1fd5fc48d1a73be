"""n-fold cross-validation — the supervised computeCrossValidation path.

Reference: h2o3_tpu/ml/cv.py (hex/ModelBuilder.java:603): assign folds,
train one model per fold on the rows outside it, score each fold's
held-out rows, merge the holdout predictions into the CV metrics, and
train the main model on all rows. Fold models run one after another.

The fast path (builders with ``cv_fold_masking``: GBM, DRF and GLM)
trains the main model first and then every fold model on the PARENT
frame, its held-out rows at weight 0 and the main model's
``BinnedMatrix`` shared, so a CV fit bins once (GLM's folds share the
full-frame standardization). Other builders, checkpoint restarts and
penalized GLM (its folds standardize per fold: the penalty couples to
the sigma scaling) train each fold on a subset frame. Near leave-one-out
CV (``light``) drops each fold's training metrics, varimp and holdout
metrics, and fetches the holdout scores once for the whole sweep.

GLM's lambda search under CV fits the main model once to fix one
full-frame lambda path, walks every fold along that same path, sums each
lambda's holdout deviance over the folds, and refits the main model at
the lambda of the least sum (GLM.java's xval-deviance selection).

Unsupervised CV (KMeans with ``nfolds``, ``y`` None) trains a model on
each fold's training rows and then the main model; its CV metrics are a
copy of the main model's training metrics without ``centroid_stats``,
as the reference serves them.

The fold models are ``_cv_models``, named ``<main key>_cv_<i>``
(``output["cv_model_keys"]``; ``train`` stores them with the main model);
``keep_cross_validation_predictions`` stores each fold's holdout
predictions and the merged ones as frames (``cv_predictions_keys``,
``cv_holdout_frame_key``), ``keep_cross_validation_fold_assignment`` the
fold of each row (``cv_fold_assignment_key``). Not ported: the cluster
scheduler of the reference (ROADMAP A #12/#13).
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.core.kv import make_key
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.model import (ModelCategory, adapt_domain,
                                         infer_category)
from h2o3_tpu_torch.parallel.device import fetch
from h2o3_tpu_torch.parallel.mesh import LOCAL, padded_rows


def fold_assignment(n: int, nfolds: int, scheme: str = "modulo",
                    seed: int = 0xF01D,
                    y: Optional[np.ndarray] = None) -> np.ndarray:
    """Fold ids per row (FoldAssignment schemes: Modulo, Random,
    Stratified), drawn as the reference draws them."""
    if scheme == "modulo":
        return (np.arange(n) % nfolds).astype(np.int32)
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    if scheme == "stratified" and y is not None:
        folds = np.zeros(n, np.int32)
        for cls in np.unique(y):
            idx = np.where(y == cls)[0]
            rng.shuffle(idx)
            folds[idx] = np.arange(len(idx)) % nfolds
        return folds
    return rng.randint(0, nfolds, size=n).astype(np.int32)


def _raw_values(col) -> np.ndarray:
    """A column's values as the reference's device data holds them:
    float32 numbers, categorical codes, 0 at NA."""
    host = np.nan_to_num(col.host_view())
    return host if col.is_categorical else host.astype(np.float32)


def subset_frame(frame: Frame, keep: np.ndarray,
                 pad_to: Optional[int] = None) -> Frame:
    """The rows ``keep`` of ``frame`` as a new frame on its device, from
    the host views (numbers rounded to float32, as the reference subsets
    its float32 device data); ``pad_to`` pads it to a chosen row count."""
    arrays, domains = {}, {}
    for name in frame.names:
        c = frame.col(name)
        v = c.host_view()[keep]
        if c.is_categorical:
            arrays[name] = np.where(np.isnan(v), -1, v).astype(np.int32)
            domains[name] = c.domain
        else:
            arrays[name] = v.astype(np.float32).astype(np.float64)
    return Frame.from_numpy(arrays, domains=domains, device=frame.device,
                            pad_to=pad_to)


def _cv_seed(p: dict) -> int:
    """The fold seed: an unset seed draws a real random one
    (getOrMakeRealSeed), so two unseeded random-fold runs differ."""
    raw = p.get("seed")
    if raw is None or int(raw) < 0:
        return int(np.random.SeedSequence().entropy % (2 ** 31))
    return int(raw)


def _holdout_columns(preds: dict, category: str, K: int) -> np.ndarray:
    if category == ModelCategory.BINOMIAL:
        return preds["p1"]
    if category == ModelCategory.MULTINOMIAL:
        return np.stack([preds[f"p{k}"] for k in range(K)], axis=1)
    return preds["predict"]


def _summary_rows(fold_metrics) -> list:
    """[metric, mean, sd, fold 1, ..., fold n] for every numeric metric
    of any fold, one slot per fold (None where a fold lacks it)."""
    keys = sorted({k for d in fold_metrics for k, v in d.items()
                   if isinstance(v, (int, float))})
    rows = []
    for k in keys:
        per_fold = [float(d[k]) if isinstance(d.get(k), (int, float))
                    else None for d in fold_metrics]
        vals = [v for v in per_fold if v is not None]
        rows.append([k, float(np.mean(vals)), float(np.std(vals))]
                    + per_fold)
    return rows


def _glm_path_holdout_deviance(m, te: Frame, y: str, p: dict) -> np.ndarray:
    """Per-lambda deviance of a GLM fold model's coefficient path on its
    holdout frame, with the user weights and the offset column, as the
    CV metrics weigh them."""
    X1 = m._design(te)                           # [npad, P+1]
    n = te.nrows
    w = np.ones(n, np.float32)
    wc = p.get("weights_column")
    if wc and wc in te:
        w = w * np.nan_to_num(te.col(wc).to_numpy()).astype(np.float32)
    yc = te.col(y)
    if m.output["category"] == ModelCategory.BINOMIAL:
        yv = adapt_domain(yc, m.output["domain"])
        w = w * (yv >= 0)
        yv = np.maximum(yv, 0).astype(np.float32)
    else:
        yraw = yc.to_numpy()
        w = w * (~np.isnan(yraw))
        yv = np.nan_to_num(yraw).astype(np.float32)
    dev = X1.device
    etas = X1 @ torch.as_tensor(m._coef_path.T.astype(np.float32)).to(dev)
    off = m._frame_offset(te)
    if off is not None:
        etas = etas + off[:, None]
    yt = torch.from_numpy(te.local_rows(yv, 0.0)).to(dev)
    devs = fetch(m.family.deviance(yt[:, None], m.family.linkinv(etas)))
    return (te.local_rows(w, 0.0)[:, None] * devs).sum(axis=0)


def _unsupervised_cv(builder, frame: Frame, x: Sequence[str],
                     folds: np.ndarray, nfolds: int, params: dict,
                     validation_frame: Optional[Frame]):
    """A model on each fold's training rows, then the main model; the CV
    metrics are the main model's training metrics with
    ``centroid_stats`` None (reference ``h2o3_tpu/ml/cv.py``'s
    unsupervised branch)."""
    cv_models = [builder.__class__(**params)._fit(
        subset_frame(frame, folds != f, pad_to=frame.nrows_padded),
        list(x), None) for f in range(nfolds)]
    final = builder.__class__(**params)._fit(
        frame, list(x), None, validation_frame=validation_frame)
    cvm = copy.copy(final.training_metrics)
    if cvm is not None:
        cvm.extra = dict(cvm.extra, centroid_stats=None)
    final.cross_validation_metrics = cvm
    final.output["nfolds"] = nfolds
    _name_cv_models(final, cv_models)
    final._cv_folds = folds
    return final


def _name_cv_models(final, cv_models) -> None:
    """Keep the fold models as ``_cv_models``, named ``<main key>_cv_<i>``
    into ``output["cv_model_keys"]`` (``train`` stores them with the main
    model)."""
    final._cv_models = cv_models
    final._key_folds()


def _frame_key(cols: dict, device) -> str:
    """A new keyed frame of host columns on ``device``; its key."""
    return Frame.from_numpy(cols, device=device,
                            key=make_key("frame")).key


def _keep_cv_frames(final, p: dict, holdout: np.ndarray, folds: np.ndarray,
                    fold_preds: list, category: str, device) -> None:
    """``keep_cross_validation_predictions``: each fold's predictions
    (all rows, zero off the fold) and the merged holdout predictions as
    keyed frames; ``keep_cross_validation_fold_assignment``: the fold of
    each row. Output keys as the reference names them."""
    n = holdout.shape[0]
    pred_keys = []
    if p.get("keep_cross_validation_predictions"):
        for idx, preds in fold_preds:
            cols = {}
            for name, arr in preds.items():
                a = np.asarray(arr)
                if a.dtype.kind not in "fiu":
                    continue
                full = np.zeros(n, np.float64)
                full[idx] = a[:len(idx)]
                cols[name] = full
            pred_keys.append(_frame_key(cols, device))
        if category == ModelCategory.MULTINOMIAL:
            hcols = {"predict": holdout.argmax(axis=1).astype(np.float64),
                     **{f"p{k}": holdout[:, k].astype(np.float64)
                        for k in range(holdout.shape[1])}}
        elif category == ModelCategory.BINOMIAL:
            t = final.output.get("default_threshold", 0.5)
            hcols = {"predict": (holdout >= t).astype(np.float64),
                     "p0": (1.0 - holdout).astype(np.float64),
                     "p1": holdout.astype(np.float64)}
        else:
            hcols = {"predict": holdout.astype(np.float64)}
        final.output["cv_holdout_frame_key"] = _frame_key(hcols, device)
    else:
        final.output["cv_holdout_frame_key"] = None
    final.output["cv_fold_assignment_key"] = (
        _frame_key({"fold_assignment": folds.astype(np.float64)}, device)
        if p.get("keep_cross_validation_fold_assignment") else None)
    final.output["cv_holdout_predictions"] = None
    final.output["cv_predictions_keys"] = pred_keys or None


def train_with_cv(builder, frame: Frame, x: Sequence[str], y: str,
                  nfolds: int, validation_frame: Optional[Frame] = None):
    """Train ``nfolds`` fold models and the main model; the main model
    carries ``cross_validation_metrics``, ``output["cv_summary_rows"]``
    and ``_cv_holdout`` / ``_cv_folds`` / ``_cv_models``. A
    ``validation_frame`` goes to the main model only."""
    p = dict(builder.params)
    scheme = str(p.get("fold_assignment", "auto") or "auto").lower()
    if scheme == "auto":
        scheme = "random"       # AUTO resolves to seeded Random
    seed = _cv_seed(p)
    category = infer_category(frame, y)
    n = frame.nrows
    if p.get("fold_column"):
        folds = _raw_values(frame.col(p["fold_column"])).astype(np.int32)
        nfolds = int(folds.max()) + 1
    else:
        yv = (_raw_values(frame.col(y)) if scheme == "stratified"
              else None)
        folds = fold_assignment(n, nfolds, scheme, seed, yv)

    sub_params = {**p, "nfolds": 0, "fold_column": None}
    if y is None:
        return _unsupervised_cv(builder, frame, x, folds, nfolds,
                                sub_params, validation_frame)
    main_params = dict(sub_params)
    cap = float(p.get("max_runtime_secs") or 0.0)
    if cap > 0:
        # the cap covers the whole CV fit: the main model keeps half,
        # the folds share the other half
        sub_params["max_runtime_secs"] = cap / 2.0 / max(nfolds, 1)
        main_params["max_runtime_secs"] = cap / 2.0
    K = frame.col(y).cardinality if category == ModelCategory.MULTINOMIAL \
        else 1
    holdout = np.zeros((n, K) if K > 1 else (n,), np.float32)

    glm = builder.algo == "glm"
    penalized_glm = glm and (p.get("lambda_search") or
                             p.get("lambda_") not in (None, 0, 0.0))
    fast = bool(getattr(builder, "cv_fold_masking", False)) \
        and p.get("checkpoint") is None and not penalized_glm
    final = shared_bm = None
    if fast:
        # the main model first: the folds reuse its binning
        final = builder.__class__(**main_params)._fit(
            frame, list(x), y, validation_frame=validation_frame)
        shared_bm = getattr(final, "bm", None)
    light = fast and nfolds >= max(100, 0.5 * n)
    shared_path = None
    if glm and p.get("lambda_search") and not fast:
        # one full-frame lambda path for every fold
        shared_path = getattr(builder.__class__(**sub_params)._fit(
            frame, list(x), y), "_lambda_path_vals", None)
    path_devs = []

    cv_models, fold_metrics, dev_scores, fold_preds = [], [], [], []
    keep_preds = bool(p.get("keep_cross_validation_predictions"))
    max_fold = int(np.max(np.bincount(folds, minlength=nfolds)))
    for f in range(nfolds):
        mask_tr = folds != f
        idx = np.where(~mask_tr)[0]
        if fast:
            sub = builder.__class__(**sub_params)
            sub._cv_fold_mask = mask_tr
            sub._cv_shared_bm = shared_bm
            sub._cv_light = light
            m = sub._fit(frame, list(x), y)
            if light and not keep_preds:
                # kept on the device; one fetch after the sweep
                dev_scores.append((idx, m._score_dev(frame)))
                fold_metrics.append({})
                continue
            preds = {k: np.asarray(v)[idx]
                     for k, v in m._score_raw(frame).items()}
            if light:
                fold_metrics.append({})
                fold_preds.append((idx, preds))
                holdout[idx] = _holdout_columns(preds, category, K)
                continue
            hold_w = np.zeros(frame.nrows_padded, np.float32)
            hold_w[idx] = 1.0
            fm = m.model_performance(frame, mask_weights=hold_w)
        else:
            tr = subset_frame(frame, mask_tr, pad_to=frame.nrows_padded)
            te = subset_frame(frame, ~mask_tr,
                              pad_to=padded_rows(max_fold, LOCAL, 8))
            sub = builder.__class__(**sub_params)
            if shared_path:
                sub.params["_lambda_path_override"] = shared_path
            m = sub._fit(tr, list(x), y)
            if shared_path and getattr(m, "_coef_path", None) is not None:
                path_devs.append(_glm_path_holdout_deviance(m, te, y, p))
            preds = m._score_raw(te)
            fm = m.model_performance(te)
        cv_models.append(m)
        fold_metrics.append(fm.to_dict())
        if keep_preds:
            fold_preds.append((idx, preds))
        holdout[idx] = _holdout_columns(preds, category, K)
    if dev_scores:
        fetched = fetch(torch.stack([s for _, s in dev_scores]))
        for (idx, _), arr in zip(dev_scores, fetched):
            holdout[idx] = arr[idx]

    if final is None:
        fb = builder.__class__(**main_params)
        if path_devs:
            # the lambda of the least summed holdout deviance
            tot = np.sum(np.stack(path_devs), axis=0)
            fb.params["_lambda_path_override"] = shared_path
            fb.params["_cv_selected_lambda"] = float(
                shared_path[int(np.argmin(tot))])
        final = fb._fit(frame, list(x), y, validation_frame=validation_frame)

    # CV metrics over the merged holdout predictions: NA responses out,
    # user weights in, as the training metrics weigh them
    yc = frame.col(y)
    wv = np.ones(n, np.float32)
    wc = p.get("weights_column")
    if wc and wc in frame:
        wv = np.nan_to_num(frame.col(wc).to_numpy()).astype(np.float32)
    if category == ModelCategory.REGRESSION:
        yraw = yc.to_numpy()
        wv = wv * (~np.isnan(yraw)).astype(np.float32)
        final.cross_validation_metrics = mm.regression_metrics(
            holdout, np.nan_to_num(yraw).astype(np.float32), wv)
    else:
        yv = adapt_domain(yc, yc.domain)
        wv = wv * (yv >= 0)
        yv = np.maximum(yv, 0)
        if category == ModelCategory.BINOMIAL:
            final.cross_validation_metrics = mm.binomial_metrics(
                holdout, yv.astype(np.float32), wv)
        else:
            final.cross_validation_metrics = mm.multinomial_metrics(
                holdout, yv, wv, domain=yc.domain)
    final.output["nfolds"] = nfolds
    final.output["cv_summary_rows"] = _summary_rows(fold_metrics)
    final.output["cv_summary_nfolds"] = nfolds
    _keep_cv_frames(final, p, holdout, folds, fold_preds, category,
                    frame.device)
    _name_cv_models(final, cv_models)
    final._cv_holdout = holdout
    final._cv_folds = folds
    return final
