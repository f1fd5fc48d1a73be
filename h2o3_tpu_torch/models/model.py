"""Model / ModelBuilder — the fit-and-score core of hex.Model/ModelBuilder.

Reference: h2o3_tpu/models/model.py. The same lifecycle:

    model = GBMEstimator(**params).train(frame, y="col")
    preds = model.predict(frame)              # Frame of predictions
    mm    = model.model_performance(frame)    # ModelMetrics

The port keeps only the fit: no Job, DKV, memory governor, recovery,
telemetry or cross-validation around it. A ``ModelBuilder`` with ``SHARDED``
trains on a frame partitioned over a sharded mesh; its model scores one
(``predict`` returns a frame partitioned like its input).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame


class ModelCategory:
    BINOMIAL = "Binomial"
    MULTINOMIAL = "Multinomial"
    REGRESSION = "Regression"


def infer_category(frame: Frame, y: Optional[str]) -> str:
    """Response-type sniffing (reference ModelBuilder.init)."""
    c = frame.col(y)
    if c.is_categorical:
        return (ModelCategory.BINOMIAL if c.cardinality == 2
                else ModelCategory.MULTINOMIAL)
    return ModelCategory.REGRESSION


def adapt_domain(test_col, train_domain: List[str]) -> np.ndarray:
    """Map test categorical codes into the training domain; unseen or
    missing → -1 (the adaptTestForTrain domain-mapping pass)."""
    host = test_col.host_view()
    na = np.isnan(host)
    codes = np.where(na, 0, host).astype(np.int32)
    if test_col.domain != train_domain:
        lut = {lvl: i for i, lvl in enumerate(train_domain)}
        mapping = np.array([lut.get(lvl, -1)
                            for lvl in (test_col.domain or [])], np.int32)
        codes = mapping[codes] if len(mapping) else \
            np.full(test_col.nrows, -1, np.int32)
    return np.where(na, -1, codes).astype(np.int32)


class Model:
    """Trained-model base (hex/Model.java)."""

    algo: str = "base"

    def __init__(self, params: dict, output: dict):
        self.params = params
        self.output = output           # domains, names, varimp, ...
        self.training_metrics = None
        self.validation_metrics = None

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        """Prediction columns of all the frame's rows, on the host."""
        raise NotImplementedError

    def _score_local(self, frame: Frame) -> Dict[str, np.ndarray]:
        """Prediction columns of the logical rows on this rank's device."""
        raise NotImplementedError(
            f"{self.algo}: scoring a frame partitioned over a sharded mesh "
            "is not ported yet")

    def predict(self, frame: Frame) -> Frame:
        """Bulk scoring → prediction Frame on the scored frame's device,
        partitioned like the scored frame."""
        domains = {}
        if self.output.get("domain"):
            domains["predict"] = self.output["domain"]
        if frame.partitioned:
            return Frame.from_numpy_partitioned(
                self._score_local(frame), frame.nrows, domains=domains,
                block=frame.block, mesh=frame.mesh)
        return Frame.from_numpy(self._score_raw(frame), domains=domains,
                                device=frame.device)

    def model_performance(self, frame: Frame):
        raise NotImplementedError


def require_local(frame: Frame, algo: str) -> None:
    """Raise for a frame partitioned over a sharded mesh: ``algo`` does
    not run on one yet."""
    if frame.partitioned:
        raise NotImplementedError(
            f"{algo} on a frame partitioned over a sharded mesh is not "
            "ported yet")


class EarlyStopper:
    """Metric-based early stopping (reference hex/ScoreKeeper.stopEarly +
    the stopping_rounds/stopping_tolerance contract of SharedTree).

    Lower-is-better metric; stops when the best of the last ``rounds``
    scoring events fails to improve on the prior best by a relative
    ``tol``.
    """

    def __init__(self, rounds: int, tol: float = 1e-3):
        self.rounds = int(rounds)
        self.tol = float(tol)
        self.history: List[float] = []

    @property
    def enabled(self) -> bool:
        return self.rounds > 0

    def should_stop(self, value: float) -> bool:
        self.history.append(float(value))
        if not self.enabled or len(self.history) <= self.rounds:
            return False
        recent = min(self.history[-self.rounds:])
        before = min(self.history[: -self.rounds])
        denom = abs(before) if before else 1.0
        return (before - recent) / denom < self.tol


class ModelBuilder:
    """Training lifecycle base (hex/ModelBuilder.java): ``train`` resolves
    the predictors, runs ``_fit`` and scores the validation frame."""

    algo: str = "base"
    SHARDED = False     # trains on a frame partitioned over ranks

    def __init__(self, **params):
        self.params = params

    def _fit(self, frame: Frame, x: Sequence[str], y: str,
             validation_frame: Optional[Frame] = None):
        """The fit; ``validation_frame`` is for estimators that watch it
        while they train (GBM's early stopping)."""
        raise NotImplementedError

    def _host_weights(self, frame: Frame, y: Optional[str]) -> np.ndarray:
        """HOST mirror of the effective training weights: user weight
        column × response-NA exclusion, [frame.nrows] float32."""
        wc_name = self.params.get("weights_column")
        if wc_name and wc_name in frame:
            wh = np.nan_to_num(
                frame.col(wc_name).to_numpy()).astype(np.float32)
        else:
            wh = np.ones(frame.nrows, np.float32)
        if y is not None and y in frame:
            wh = wh * (~np.isnan(frame.col(y).host_view())).astype(
                np.float32)
        return wh

    def _normalize_uniform_weights(self, w: torch.Tensor,
                                   wh_host: np.ndarray):
        """(w', scale): a constant weight column rescales to exactly 1.0
        so 'uniform weights ≡ no weights' holds bit for bit; callers
        divide every ABSOLUTE training threshold (min_rows,
        min_split_improvement, reg_lambda) by the returned scale."""
        pos = wh_host[wh_host > 0]
        if pos.size and pos.min() == pos.max() and float(pos[0]) != 1.0:
            s = float(pos[0])
            return w / s, s
        return w, 1.0

    def resolve_x(self, frame: Frame, x: Optional[Sequence[str]],
                  y: Optional[str]) -> List[str]:
        drop = {y, self.params.get("weights_column")}
        drop |= set(self.params.get("ignored_columns") or [])
        if x is None:
            x = frame.names
        else:
            x = [n if isinstance(n, str) else frame.names[n] for n in x]
        return [n for n in x if n not in drop]

    def train(self, training_frame: Frame, y: Optional[str] = None,
              x: Optional[Sequence[str]] = None,
              validation_frame: Optional[Frame] = None):
        """Fit on ``training_frame`` (on its device) → Model; with a
        ``validation_frame`` the model's ``validation_metrics`` score it."""
        if not self.SHARDED:
            require_local(training_frame, self.algo)
        model = self._fit(training_frame,
                          self.resolve_x(training_frame, x, y), y,
                          validation_frame=validation_frame)
        if validation_frame is not None:
            model.validation_metrics = model.model_performance(
                validation_frame)
        return model
