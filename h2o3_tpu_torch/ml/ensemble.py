"""StackedEnsemble — a metalearner over the base models' CV holdout
predictions.

Reference: h2o3_tpu/ml/ensemble.py (hex/ensemble/StackedEnsemble.java:29).
The level-one training frame holds each base model's cross-validation
HOLDOUT predictions (``_cv_holdout``: p1 for binomial, every class's
probability for multinomial, the prediction for regression; host
float32) in columns named by model key, and the response, on the
training frame's device, so the metalearner never sees a base model's
in-bag fit. The default metalearner is the GLM with ``lambda_=0``; any
registered algorithm may be named. Scoring builds the level-one frame
from the base models' predictions on the scored frame.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from h2o3_tpu_torch.core.job import job_update
from h2o3_tpu_torch.core.kv import DKV
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import get_builder
from h2o3_tpu_torch.models.model import Model, ModelBuilder, ModelCategory


def _level_one_columns(model, frame: Optional[Frame]) -> Dict[str, np.ndarray]:
    """A base model's level-one columns: its CV holdout predictions
    (``frame`` None, training) or its predictions on ``frame``."""
    cat = model.output["category"]
    mid = model.key
    if frame is None:
        h = model._cv_holdout
        if cat == ModelCategory.MULTINOMIAL:
            return {f"{mid}_p{k}": h[:, k] for k in range(h.shape[1])}
        return {mid: h}
    preds = model._score_raw(frame)
    if cat == ModelCategory.BINOMIAL:
        return {mid: np.asarray(preds["p1"])}
    if cat == ModelCategory.MULTINOMIAL:
        K = model.output["nclasses"]
        return {f"{mid}_p{k}": np.asarray(preds[f"p{k}"]) for k in range(K)}
    return {mid: np.asarray(preds["predict"])}


def _with_response(arrs: Dict[str, np.ndarray], yc, y: str, n: int,
                   device) -> Frame:
    """The level-one columns and the response column on ``device``; NA
    responses stay NA (the metalearner drops those rows, as any builder
    does)."""
    arrs = dict(arrs)
    if yc.is_categorical:
        codes = yc.host_view()[:n]             # float codes, NaN at NA
        arrs[y] = np.where(np.isnan(codes), -1, codes).astype(np.int32)
        return Frame.from_numpy(arrs, domains={y: yc.domain},
                                device=device)
    arrs[y] = yc.to_numpy()
    return Frame.from_numpy(arrs, device=device)


class StackedEnsembleModel(Model):
    algo = "stackedensemble"

    def __init__(self, params, output, base_models: List,
                 metalearner: Model):
        super().__init__(params, output)
        self.base_models = base_models
        self.metalearner = metalearner

    def _store(self, key: str) -> None:
        """Store the ensemble and its metalearner (``output
        ["metalearner"]``); the base models are stored by their own
        fits."""
        self.metalearner._store(self.metalearner.key)
        super()._store(key)

    def _owned_keys(self):
        return super()._owned_keys() + [self.metalearner.key]

    def _level_one(self, frame: Frame) -> Frame:
        cols: Dict[str, np.ndarray] = {}
        for m in self.base_models:
            cols.update(_level_one_columns(m, frame))
        return Frame.from_numpy(cols, device=frame.device)

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        return self.metalearner._score_raw(self._level_one(frame))

    def model_performance(self, frame: Frame, mask_weights=None):
        l1f = self._level_one(frame)
        y = self.output["response"]
        arrs = {n: l1f.col(n).to_numpy() for n in l1f.names}
        l1y = _with_response(arrs, frame.col(y), y, frame.nrows,
                             frame.device)
        return self.metalearner.model_performance(l1y,
                                                  mask_weights=mask_weights)


class StackedEnsembleEstimator(ModelBuilder):
    """h2o-py H2OStackedEnsembleEstimator surface: ``base_models`` are
    Models or their keys, each trained with ``nfolds`` >= 2 on the same
    rows."""

    algo = "stackedensemble"
    label = "StackedEnsemble"

    DEFAULTS = dict(
        base_models=(), metalearner_algorithm="AUTO",
        metalearner_params=None, metalearner_nfolds=0, seed=-1,
        ignored_columns=None,
    )
    PORTED = frozenset(DEFAULTS)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        p = self.params
        base = [m if isinstance(m, Model) else DKV.get(m)
                for m in p["base_models"]]
        if len(base) < 2:
            raise ValueError("StackedEnsemble needs >= 2 base models")
        for m in base:
            if getattr(m, "_cv_holdout", None) is None:
                raise ValueError(
                    f"base model {m.key} lacks CV holdout predictions; "
                    "train base models with nfolds >= 2")
        cat = base[0].output["category"]

        # the level-one training frame from the CV holdouts
        cols: Dict[str, np.ndarray] = {}
        for m in base:
            cols.update(_level_one_columns(m, None))
        l1f = _with_response(cols, frame.col(y), y, frame.nrows,
                             frame.device)

        meta_algo = str(p["metalearner_algorithm"]).lower()
        meta_params = dict(p["metalearner_params"] or {})
        if meta_algo == "auto":
            meta_algo = "glm"
            meta_params.setdefault("lambda_", 0.0)
        if int(p["metalearner_nfolds"]):
            meta_params["nfolds"] = int(p["metalearner_nfolds"])
        builder = get_builder(meta_algo)(**meta_params)
        job_update(0.5, "training metalearner")
        meta = builder.train(l1f, y=y)

        output = {"category": cat, "response": y,
                  "names": [m.key for m in base],
                  "nclasses": base[0].output.get("nclasses", 1),
                  "domain": base[0].output.get("domain"),
                  "metalearner": meta.key,
                  "base_models": [m.key for m in base]}
        model = StackedEnsembleModel(p, output, base, meta)
        model.training_metrics = meta.training_metrics
        model.cross_validation_metrics = meta.cross_validation_metrics
        if validation_frame is not None:
            model.validation_metrics = model.model_performance(
                validation_frame)
        return model
