"""Isotonic regression — pool-adjacent-violators.

Reference: h2o3_tpu/models/isotonic.py (hex/isotonic/): the (x, y, w)
triples aggregate to unique-x buckets, weighted PAV runs over them, and
scoring interpolates linearly between the thresholds, clamped to the
training range (``out_of_bounds="na"``: NA outside it).

Host numpy, as in the reference: PAV is sequential and its input is at
most the number of distinct x. The inputs are the columns' float32
values (the reference's ``numeric_view``), read from their host views
(a float32 cast of the float64 view is the device data bit for bit), so
the thresholds and fitted values are the reference's EXACTLY and no
device is touched. The metrics are ``models/metrics.regression_metrics``
on the host.

Not ported: its MOJO and serving (ROADMAP A #10), a partitioned frame
(A #12).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.model import (Model, ModelBuilder, ModelCategory,
                                         require_local)


def _f32_view(frame: Frame, name: str) -> np.ndarray:
    """A column's float32 values, NaN at NA, over the logical rows."""
    return frame.col(name).host_view().astype(np.float32)


def _pav(x: np.ndarray, y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted PAV on sorted-unique x: the isotonic fitted values."""
    means, weights, counts = [], [], []
    for i in range(len(x)):
        m, wt, c = y[i], w[i], 1
        while means and means[-1] > m:
            pm, pw, pc = means.pop(), weights.pop(), counts.pop()
            m = (m * wt + pm * pw) / (wt + pw)
            wt += pw
            c += pc
        means.append(m)
        weights.append(wt)
        counts.append(c)
    out = np.empty_like(y)
    j = 0
    for m, c in zip(means, counts):
        out[j:j + c] = m
        j += c
    return out


class IsotonicRegressionModel(Model):
    algo = "isotonicregression"

    def __init__(self, params, output, thresholds_x, thresholds_y):
        super().__init__(params, output)
        self.tx = thresholds_x
        self.ty = thresholds_y

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        require_local(frame, self.algo)
        x = _f32_view(frame, self.output["names"][0])
        pred = np.interp(np.clip(x, self.tx[0], self.tx[-1]), self.tx,
                         self.ty)
        pred[np.isnan(x)] = np.nan
        if str(self.params.get("out_of_bounds", "clip")).lower() == "na":
            pred[(x < self.tx[0]) | (x > self.tx[-1])] = np.nan
        return {"predict": pred}

    def model_performance(self, frame: Frame, mask_weights=None):
        pred = self._score_raw(frame)["predict"]
        yv = _f32_view(frame, self.output["response"])
        ok = ~(np.isnan(pred) | np.isnan(yv))
        w = ok.astype(np.float32)
        if mask_weights is not None:
            w = w * np.asarray(mask_weights, np.float32)[:frame.nrows]
        return mm.regression_metrics(np.where(ok, pred, 0.0),
                                     np.where(ok, yv, 0.0), w)


class IsotonicRegressionEstimator(ModelBuilder):
    """h2o-py H2OIsotonicRegressionEstimator surface."""

    algo = "isotonicregression"
    label = "Isotonic"

    DEFAULTS = dict(
        out_of_bounds="clip", weights_column=None, ignored_columns=None,
        nfolds=0, fold_column=None, fold_assignment="auto", seed=-1,
    )
    PORTED = frozenset(DEFAULTS)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        if len(x) != 1:
            raise ValueError("IsotonicRegression takes exactly one feature")
        require_local(frame, self.label)
        p = self.params
        xv, yv = _f32_view(frame, x[0]), _f32_view(frame, y)
        w = np.ones(frame.nrows, np.float32)
        if p.get("weights_column"):
            w = w * np.nan_to_num(_f32_view(frame, p["weights_column"]))
        ok = ~(np.isnan(xv) | np.isnan(yv)) & (w > 0)
        xv, yv, w = xv[ok], yv[ok], w[ok]
        # duplicates aggregate to unique x (weighted means), then PAV
        order = np.argsort(xv, kind="stable")
        xs, ys, ws = xv[order], yv[order], w[order]
        ux, inv = np.unique(xs, return_inverse=True)
        wy = np.bincount(inv, weights=ws * ys)
        ww = np.bincount(inv, weights=ws)
        fitted = _pav(ux, wy / np.maximum(ww, 1e-12), ww)
        output = {"category": ModelCategory.REGRESSION, "response": y,
                  "names": list(x), "domain": None,
                  "thresholds_x": ux.tolist(),
                  "thresholds_y": fitted.tolist()}
        model = IsotonicRegressionModel(p, output, ux, fitted)
        model.training_metrics = model.model_performance(frame)
        return model
