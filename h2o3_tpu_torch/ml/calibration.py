"""Probability calibration for binomial tree models.

Reference: h2o3_tpu/ml/calibration.py (hex/tree/SharedTree
calibrate_model / calibration_frame / calibration_method): after
training, fit Platt scaling (a one-feature logistic regression on the
raw scores, CalibrationHelper) or an isotonic regression mapping raw
probabilities to calibrated ones; scoring then adds ``cal_p0`` /
``cal_p1`` columns (``Model._finish_predict``). The fits are the
reference's numpy code, run on the host over the fetched ``p1``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame, resolve_frame


def fit_platt(p_raw: np.ndarray, y01: np.ndarray,
              iters: int = 50) -> Tuple[float, float]:
    """Newton logistic fit of y on logit(p): returns (a, b) with
    cal_p = sigmoid(a * logit(p) + b)."""
    z = np.log(np.clip(p_raw, 1e-7, 1 - 1e-7)
               / np.clip(1 - p_raw, 1e-7, 1 - 1e-7))
    a, b = 1.0, 0.0
    for _ in range(iters):
        eta = a * z + b
        mu = 1.0 / (1.0 + np.exp(-np.clip(eta, -30, 30)))
        wv = np.maximum(mu * (1 - mu), 1e-9)
        g = np.array([np.sum((mu - y01) * z), np.sum(mu - y01)])
        H = np.array([[np.sum(wv * z * z), np.sum(wv * z)],
                      [np.sum(wv * z), np.sum(wv)]])
        try:
            step = np.linalg.solve(H + 1e-9 * np.eye(2), g)
        except np.linalg.LinAlgError:
            break
        a, b = a - step[0], b - step[1]
        if np.abs(step).max() < 1e-10:
            break
    return float(a), float(b)


def fit_isotonic(p_raw: np.ndarray, y01: np.ndarray):
    """Pool-adjacent-violators p → E[y] map; returns (x, y) step
    points."""
    order = np.argsort(p_raw, kind="stable")
    x = p_raw[order].astype(np.float64)
    y = y01[order].astype(np.float64)
    v, ww, xx = [], [], []
    for i in range(len(y)):
        v.append(y[i]); ww.append(1.0); xx.append(x[i])
        while len(v) > 1 and v[-2] > v[-1]:
            m = (v[-2] * ww[-2] + v[-1] * ww[-1]) / (ww[-2] + ww[-1])
            wnew = ww[-2] + ww[-1]
            xnew = xx[-1]
            v.pop(); ww.pop(); xx.pop()
            v[-1], ww[-1], xx[-1] = m, wnew, xnew
    return np.asarray(xx), np.asarray(v)


class Calibrator:
    """Fitted calibration map attached to a binomial model."""

    def __init__(self, method: str, params):
        self.method = method
        self.params = params

    def apply(self, p1: np.ndarray) -> np.ndarray:
        if self.method == "plattscaling":
            a, b = self.params
            z = np.log(np.clip(p1, 1e-7, 1 - 1e-7)
                       / np.clip(1 - p1, 1e-7, 1 - 1e-7))
            return 1.0 / (1.0 + np.exp(-np.clip(a * z + b, -30, 30)))
        xs, ys = self.params
        if len(xs) == 0:
            return p1
        return np.interp(np.clip(p1, xs[0], xs[-1]), xs, ys)


def maybe_calibrate(model, params: dict, category: str) -> None:
    """GBM/DRF post-train hook: validate and fit the calibrator when
    ``calibrate_model`` is set (CalibrationHelper.initCalibration
    validation)."""
    if not params.get("calibrate_model"):
        return
    if category != "Binomial":
        raise ValueError("calibrate_model is only supported for binomial "
                         f"models (got {category})")
    cf = params.get("calibration_frame")
    if cf is None:
        raise ValueError("calibrate_model requires calibration_frame")
    cf = resolve_frame(cf, "calibration_frame")
    calibrate_model(model, cf,
                    method=params.get("calibration_method", "PlattScaling"))


def calibrate_model(model, calibration_frame: Frame,
                    method: str = "PlattScaling") -> Calibrator:
    """Fit and attach a calibrator (CalibrationHelper
    .buildCalibrationModel); ``model.predict`` gains ``cal_p0`` /
    ``cal_p1`` afterwards."""
    from h2o3_tpu_torch.models.model import adapt_domain
    y = model.output["response"]
    p1 = np.asarray(model._score_raw(calibration_frame)["p1"],
                    dtype=np.float64)
    yv = adapt_domain(calibration_frame.col(y), model.output["domain"])
    ok = yv >= 0
    m = str(method).lower().replace("_", "")
    if m == "plattscaling":
        cal = Calibrator(m, fit_platt(p1[ok], yv[ok].astype(float)))
    elif m in ("isotonicregression", "isotonic"):
        cal = Calibrator("isotonic", fit_isotonic(p1[ok],
                                                  yv[ok].astype(float)))
    else:
        raise ValueError(f"unknown calibration_method '{method}'")
    model.calibrator = cal
    return cal
