"""Model / ModelBuilder — the fit-and-score core of hex.Model/ModelBuilder.

Reference: h2o3_tpu/models/model.py. The same lifecycle:

    model = GBMEstimator(**params).train(frame, y="col")
    preds = model.predict(frame)              # Frame of predictions
    mm    = model.model_performance(frame)    # ModelMetrics

The port keeps the fit and n-fold cross-validation (``nfolds`` or a
``fold_column``: ``ml/cv.py``): no Job, DKV, memory governor, recovery or
telemetry around it, so a ``checkpoint`` or a ``calibration_frame`` is a
Model or a Frame, never a key. A ``ModelBuilder`` with ``SHARDED`` trains
on a frame partitioned over a sharded mesh; its model scores one
(``predict`` returns a frame partitioned like its input).
"""

from __future__ import annotations

import time
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


def checkpoint_error(algo: str, field: str, message: str) -> ValueError:
    """H2O-shaped checkpoint validation error (as h2o-py surfaces
    H2OModelBuilderIllegalArgumentException: ``Illegal argument(s) for
    <ALGO> model ... Details: ERRR on field: _<field>: <message>``)."""
    return ValueError(
        f"Illegal argument(s) for {algo.upper()} model: "
        f"Details: ERRR on field: _{field}: {message}")


def validate_checkpoint_params(algo: str, donor_params: Dict,
                               params: Dict, fields) -> None:
    """Reject changes to checkpoint-non-modifiable parameters ("Field _x
    cannot be modified if checkpoint is provided!")."""
    for f in fields:
        old = donor_params.get(f)
        new = params.get(f)
        if old != new:
            raise checkpoint_error(
                algo, f,
                f"Field _{f} cannot be modified if checkpoint is "
                f"provided (checkpoint model: {old!r}, request: {new!r})")


def resolve_checkpoint_model(algo: str, ck, model_cls):
    """Type-check the donor model behind ``checkpoint=``: a Model
    instance (the reference also takes its DKV key; keys need the KV
    layer, which is not ported)."""
    if isinstance(ck, str):
        raise NotImplementedError(
            f"{algo}: checkpoint by model key is not ported yet: keys live "
            "in the KV layer; pass the Model itself")
    if not isinstance(ck, model_cls) or getattr(ck, "algo", None) != algo:
        raise checkpoint_error(
            algo, "checkpoint",
            f"Checkpoint model '{ck!r}' not found or not a {algo} model")
    return ck


def check_donor(algo: str, donor, *, y: str, x: Sequence[str],
                category: str, params: Dict, fields,
                dist_name: Optional[tuple] = None) -> None:
    """What a checkpoint restart may not change: the response, the
    predictor set, the model category, the distribution (``dist_name``:
    the donor's and the request's) and the non-modifiable fields."""
    if donor.output["response"] != y:
        raise checkpoint_error(
            algo, "response_column",
            "Field _response_column cannot be modified if checkpoint is "
            "provided (checkpoint response mismatch: "
            f"{donor.output['response']!r} vs {y!r})")
    if list(donor.bm.names) != list(x):
        raise checkpoint_error(
            algo, "ignored_columns",
            "The predictor set cannot be modified if checkpoint is "
            "provided (checkpoint feature set mismatch)")
    if donor.output["category"] != category:
        raise checkpoint_error(
            algo, "response_column",
            "checkpoint model category mismatch "
            f"({donor.output['category']} vs {category})")
    if dist_name is not None and dist_name[0] != dist_name[1]:
        raise checkpoint_error(
            algo, "distribution",
            "Field _distribution cannot be modified if checkpoint is "
            "provided: distribution cannot change across checkpoint "
            f"restart ({dist_name[0]} vs {dist_name[1]})")
    validate_checkpoint_params(algo, donor.params, params, fields)


def prior_trees(algo: str, donor, K: int, ntrees: int) -> int:
    """The donor's tree count (iterations: its forest rows over the K
    class trees of one), which ``ntrees`` must exceed."""
    prior = donor.forest.feat.shape[0] // max(K, 1)
    if ntrees <= prior:
        raise checkpoint_error(
            algo, "ntrees",
            f"If checkpoint is provided, ntrees ({ntrees}) must exceed "
            f"the checkpoint model's tree count ({prior})")
    return prior


class Deadline:
    """``max_runtime_secs``: a graceful stop after the tree at which the
    cap has passed, keeping the trees built so far (at least one). The
    tree loop queues its work without waiting for the device, so each
    check first waits for the device's queue: what the cap measures is
    then what the device did. Without a cap nothing waits."""

    def __init__(self, secs: float, device: torch.device):
        secs = float(secs or 0.0)
        self.device = device
        self.at = time.monotonic() + secs if secs > 0 else None

    def passed(self) -> bool:
        if self.at is None:
            return False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.monotonic() > self.at


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
        self.cross_validation_metrics = None
        self.calibrator = None         # ml/calibration.Calibrator

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        """Prediction columns of all the frame's rows, on the host."""
        raise NotImplementedError

    def _score_local(self, frame: Frame) -> Dict[str, np.ndarray]:
        """Prediction columns of the logical rows on this rank's device."""
        raise NotImplementedError(
            f"{self.algo}: scoring a frame partitioned over a sharded mesh "
            "is not ported yet")

    def _finish_predict(self, cols: Dict[str, np.ndarray]
                        ) -> Dict[str, np.ndarray]:
        """Prediction columns plus, with a calibrator attached, the
        calibrated probabilities ``cal_p0``/``cal_p1``."""
        if self.calibrator is None or "p1" not in cols:
            return cols
        cp1 = self.calibrator.apply(np.asarray(cols["p1"], np.float64))
        return {**cols, "cal_p0": 1.0 - cp1, "cal_p1": cp1}

    def predict(self, frame: Frame) -> Frame:
        """Bulk scoring → prediction Frame on the scored frame's device,
        partitioned like the scored frame."""
        domains = {}
        if self.output.get("domain"):
            domains["predict"] = self.output["domain"]
        if frame.partitioned:
            return Frame.from_numpy_partitioned(
                self._finish_predict(self._score_local(frame)), frame.nrows,
                domains=domains, block=frame.block, mesh=frame.mesh)
        return Frame.from_numpy(self._finish_predict(self._score_raw(frame)),
                                domains=domains, device=frame.device)

    def model_performance(self, frame: Frame, mask_weights=None):
        """Metrics on ``frame``; ``mask_weights`` ([nrows_padded] host
        floats) restricts them to a row subset (the CV fast path scores a
        fold's held-out rows on the parent frame)."""
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


def masked_weights(w: torch.Tensor, mask_weights):
    """``w`` times a [nrows_padded] host row mask (None: ``w``)."""
    if mask_weights is None:
        return w
    return w * torch.as_tensor(np.asarray(mask_weights, np.float32),
                               device=w.device)


class ModelBuilder:
    """Training lifecycle base (hex/ModelBuilder.java): ``train`` resolves
    the predictors, runs ``_fit`` (or n-fold cross-validation) and scores
    the validation frame. Each parameter of ``PORTED`` off its default
    is ported; any other raises ``NotImplementedError`` (with the reason
    ``UNPORTED_WHY`` gives, if any)."""

    algo: str = "base"
    label: str = "base"  # the estimator's name in messages
    SHARDED = False     # trains on a frame partitioned over ranks
    # ml/cv.py fast path: fold models train on the parent frame with the
    # held-out rows weighted 0 and the main model's binning shared
    cv_fold_masking = False
    DEFAULTS: Dict = {}
    PORTED = frozenset()
    UNPORTED_WHY = {
        "keep_cross_validation_predictions":
            "the reference returns them as frame keys, and keys live in "
            "the KV layer",
        "keep_cross_validation_fold_assignment":
            "the reference returns it as a frame key, and keys live in "
            "the KV layer",
    }
    # parameters a fit on a partitioned frame does not take yet: fold
    # masks and a donor model would be needed on every rank, calibration
    # scores a frame of its own, and ranks reading a wall-clock cap on
    # their own clocks would stop at different trees
    LOCAL_ONLY = ("nfolds", "fold_column", "checkpoint", "calibrate_model",
                  "max_runtime_secs")

    def __init__(self, **params):
        unknown = set(params) - set(self.DEFAULTS)
        if unknown:
            raise ValueError(
                f"unknown {self.label} params: {sorted(unknown)}")
        for k, v in params.items():
            if k not in self.PORTED and v != self.DEFAULTS[k]:
                why = self.UNPORTED_WHY.get(k)
                raise NotImplementedError(
                    f"{self.label} parameter '{k}' is not ported yet"
                    + (f": {why}" if why else ""))
        self.params = {**self.DEFAULTS, **params}

    def _fit(self, frame: Frame, x: Sequence[str], y: str,
             validation_frame: Optional[Frame] = None):
        """The fit; ``validation_frame`` is for estimators that watch it
        while they train (GBM's early stopping)."""
        raise NotImplementedError

    def _cv_masked_weights(self, w: torch.Tensor, frame: Frame):
        """CV fast path (ml/cv.py): a fold model trains on the parent
        frame with its held-out rows weighted 0."""
        fold_mask = getattr(self, "_cv_fold_mask", None)
        if fold_mask is None:
            return w
        fm = np.zeros(frame.nrows_padded, np.float32)
        fm[:frame.nrows] = fold_mask
        return masked_weights(w, fm)

    def _host_weights(self, frame: Frame, y: Optional[str]) -> np.ndarray:
        """HOST mirror of the effective training weights: user weight
        column × CV fold mask × response-NA exclusion, [frame.nrows]
        float32."""
        wc_name = self.params.get("weights_column")
        if wc_name and wc_name in frame:
            wh = np.nan_to_num(
                frame.col(wc_name).to_numpy()).astype(np.float32)
        else:
            wh = np.ones(frame.nrows, np.float32)
        fold_mask = getattr(self, "_cv_fold_mask", None)
        if fold_mask is not None:
            wh = wh * fold_mask.astype(np.float32)
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
        drop = {y, self.params.get("weights_column"),
                self.params.get("fold_column"),
                self.params.get("offset_column")}
        drop |= set(self.params.get("ignored_columns") or [])
        if x is None:
            x = frame.names
        else:
            x = [n if isinstance(n, str) else frame.names[n] for n in x]
        # strings can't enter math paths (the reference drops them)
        return [n for n in x if n not in drop
                and frame.col(n).type != "string"]

    def _check_folds(self, frame: Frame) -> int:
        """The fold count ``train`` runs (0 or 1: no cross-validation),
        after the reference's four validation errors. A ``fold_column``
        forces cross-validation."""
        p = self.params
        nfolds = int(p.get("nfolds") or 0)
        if p.get("fold_column") and nfolds < 2:
            nfolds = 2      # the fold column gives the real count
        if nfolds == 1 or nfolds < 0:
            raise ValueError(
                "nfolds must be either 0 or >1 (got %d)" % nfolds)
        if nfolds > frame.nrows:
            raise ValueError(
                "nfolds (%d) cannot exceed the number of rows (%d)"
                % (nfolds, frame.nrows))
        if p.get("fold_column") and int(p.get("nfolds") or 0) > 0:
            raise ValueError(
                "only one of nfolds or fold_column may be specified")
        if p.get("fold_column") and str(
                p.get("fold_assignment", "auto") or "auto").lower() != "auto":
            raise ValueError(
                "fold_assignment is incompatible with fold_column "
                "(hex/ModelBuilder fold-spec validation)")
        return nfolds

    def train(self, training_frame: Frame, y: Optional[str] = None,
              x: Optional[Sequence[str]] = None,
              validation_frame: Optional[Frame] = None):
        """Fit on ``training_frame`` (on its device) → Model; with
        ``nfolds`` >= 2 or a ``fold_column`` the model carries
        ``cross_validation_metrics``; with a ``validation_frame`` its
        ``validation_metrics`` score it."""
        if training_frame.partitioned:
            if not self.SHARDED:
                require_local(training_frame, self.algo)
            for k in self.LOCAL_ONLY:
                if self.params.get(k) != self.DEFAULTS.get(k):
                    raise NotImplementedError(
                        f"{self.label} parameter '{k}' on a frame "
                        "partitioned over a sharded mesh is not ported yet")
        x = self.resolve_x(training_frame, x, y)
        nfolds = self._check_folds(training_frame)
        if nfolds >= 2:
            from h2o3_tpu_torch.ml.cv import train_with_cv
            model = train_with_cv(self, training_frame, x, y, nfolds,
                                  validation_frame=validation_frame)
        else:
            model = self._fit(training_frame, x, y,
                              validation_frame=validation_frame)
        if validation_frame is not None:
            model.validation_metrics = model.model_performance(
                validation_frame)
        return model
