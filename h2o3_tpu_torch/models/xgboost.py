"""XGBoost-compatible facade over the port's histogram GBM.

Reference: h2o3_tpu/models/xgboost.py (hex/tree/xgboost/XGBoost.java).
H2O's XGBoost drives the native library; here, as in the reference, the
histogram GBM already is the histogram-method gradient booster, so the
facade only translates the h2o-py XGBoost names onto ``GBMEstimator``:

  ntrees/nrounds → ntrees          eta/learn_rate → learn_rate
  max_depth → max_depth            reg_lambda/lambda_ → reg_lambda
  subsample/sample_rate → sample_rate
  colsample_bytree/col_sample_rate_per_tree → col_sample_rate_per_tree
  min_rows/min_child_weight → min_rows
  max_bins → nbins                 gamma/min_split_improvement → m_s_i

Booster variants, DART, GPU ids and the other knobs of ``_INERT`` are
accepted, logged and ignored. A mapped parameter the port's GBM does not
take yet raises what ``GBMEstimator`` raises. A fit is the equivalent
GBM fit, through the same level kernels, and its model a ``GBMModel``
with ``output["facade"] = "xgboost"``.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.gbm import GBMEstimator

log = logging.getLogger("h2o3_tpu_torch.xgboost")

_DIRECT = {"ntrees", "max_depth", "seed", "nfolds", "weights_column",
           "max_runtime_secs",
           "fold_column", "fold_assignment", "ignored_columns",
           "stopping_rounds", "stopping_metric", "stopping_tolerance",
           "distribution", "min_rows", "learn_rate", "sample_rate",
           "reg_lambda", "col_sample_rate_per_tree", "nbins",
           # the donor is a GBMModel: restarts run through models/gbm.py
           "checkpoint"}

_ALIASES = {
    "nrounds": "ntrees",
    "eta": "learn_rate",
    "learn_rate": "learn_rate",
    "subsample": "sample_rate",
    "colsample_bytree": "col_sample_rate_per_tree",
    "min_child_weight": "min_rows",
    "max_bins": "nbins",
    "gamma": "min_split_improvement",
    "min_split_improvement": "min_split_improvement",
    "reg_lambda": "reg_lambda",
    "lambda_": "reg_lambda",
    "monotone_constraints": "monotone_constraints",
    "calibrate_model": "calibrate_model",
    "calibration_frame": "calibration_frame",
    "calibration_method": "calibration_method",
    "interaction_constraints": "interaction_constraints",
}

# accepted for wire compatibility, no effect on the histogram GBM
_INERT = {"booster", "tree_method", "grow_policy", "backend", "gpu_id",
          "dmatrix_type", "categorical_encoding", "score_tree_interval",
          "colsample_bylevel", "col_sample_rate", "reg_alpha",
          "scale_pos_weight", "max_leaves", "sample_type",
          "normalize_type", "rate_drop", "one_drop", "skip_drop",
          "nthread", "save_matrix_directory",
          "max_delta_step"}


class XGBoostEstimator:
    """h2o-py H2OXGBoostEstimator surface mapped onto ``GBMEstimator``."""

    algo = "xgboost"

    @classmethod
    def accepted_params(cls) -> set:
        return _DIRECT | set(_ALIASES) | _INERT

    def __init__(self, **params):
        gbm_params = {}
        ignored = []
        for k, v in params.items():
            if k in _ALIASES:
                gbm_params[_ALIASES[k]] = v
            elif k in _DIRECT:
                gbm_params[k] = v
            elif k in _INERT:
                ignored.append(k)
            else:
                raise ValueError(f"unknown XGBoost param: {k}")
        if ignored:
            log.info("XGBoost params accepted but inert on the histogram "
                     "GBM: %s", sorted(ignored))
        self._gbm = GBMEstimator(**gbm_params)
        self.params = dict(params)

    def set_max_runtime(self, secs: float) -> None:
        self.params["max_runtime_secs"] = float(secs)
        self._gbm.params["max_runtime_secs"] = float(secs)

    def train(self, training_frame: Frame, y: Optional[str] = None,
              x: Optional[Sequence[str]] = None,
              validation_frame: Optional[Frame] = None,
              background: bool = False, dest_key: Optional[str] = None):
        """The GBM's ``train``; in the background it returns the GBM's
        Job, whose model lacks ``output["facade"]`` (as in the
        reference)."""
        model = self._gbm.train(training_frame, y=y, x=x,
                                validation_frame=validation_frame,
                                background=background, dest_key=dest_key)
        if not background:
            model.output["facade"] = "xgboost"
        return model
