"""The XGBoost facade of the PyTorch port (on the CPU) against the
reference package's: the same accepted names, aliases and errors, and
whole fits.

Both packages get the same numpy columns (the data of
``test_torch_gbm.py``) with sampling off; at ``max_bins=40`` neither
case has a near-tie split (at 32 the gaussian one has a plateau of
equal-gain thresholds whose pick follows the summation order). The
forests' integer fields must be EXACTLY equal, leaf values within rtol
1e-5 and predictions within 1e-6; the port's facade forest is bit-equal
to its own ``GBMEstimator`` on the mapped parameters."""

import logging

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models.xgboost import XGBoostEstimator as RefXGB
from h2o3_tpu_torch.models import xgboost as port_xgb
from h2o3_tpu_torch.models.tree import Tree

from tests.test_torch_gbm import _assert_forests
from torch_ranks import mixed_cols, regression_cols

XGB = dict(nrounds=4, max_depth=4, seed=11, subsample=1.0,
           colsample_bytree=1.0, eta=0.3, reg_lambda=0.5, gamma=1e-3,
           max_bins=40)
# the GBM names XGB maps to
GBM = dict(ntrees=4, max_depth=4, seed=11, sample_rate=1.0,
           col_sample_rate_per_tree=1.0, learn_rate=0.3, reg_lambda=0.5,
           min_split_improvement=1e-3, nbins=40)
CASES = {
    "binomial": (lambda: mixed_cols(seed=6), {}),
    "gaussian": (regression_cols, dict(distribution="gaussian",
                                       min_child_weight=5.0)),
}


def test_accepted_params_equal_the_reference():
    assert h2o3_tpu_torch.XGBoostEstimator.accepted_params() == \
        RefXGB.accepted_params()


ALIAS_VALUES = {
    "nrounds": 7, "eta": 0.05, "learn_rate": 0.2, "subsample": 0.8,
    "colsample_bytree": 0.6, "min_child_weight": 3.0, "max_bins": 40,
    "gamma": 0.01, "min_split_improvement": 0.02, "reg_lambda": 2.0,
    "lambda_": 1.5, "monotone_constraints": {"x1": 1},
    "calibrate_model": True, "calibration_frame": None,
    "calibration_method": "IsotonicRegression",
    "interaction_constraints": [["x0", "x1"]],
}


@pytest.mark.parametrize("alias", sorted(ALIAS_VALUES))
def test_alias_maps_to_the_same_gbm_parameter(alias):
    value = ALIAS_VALUES[alias]
    ref = RefXGB(**{alias: value})._gbm.params
    port = h2o3_tpu_torch.XGBoostEstimator(**{alias: value})._gbm.params
    target = port_xgb._ALIASES[alias]
    assert port[target] == ref[target] == value


def test_unknown_key_raises_in_both():
    for cls in (RefXGB, h2o3_tpu_torch.XGBoostEstimator):
        with pytest.raises(ValueError, match="unknown XGBoost param"):
            cls(not_a_param=1)


def test_mapped_parameter_gbm_refuses_raises_as_gbm():
    """stopping_metric off "auto" is a GBM parameter the port does not
    take yet: the facade raises what GBMEstimator raises."""
    with pytest.raises(NotImplementedError, match="stopping_metric"):
        h2o3_tpu_torch.GBMEstimator(stopping_metric="AUC")
    with pytest.raises(NotImplementedError, match="stopping_metric"):
        h2o3_tpu_torch.XGBoostEstimator(stopping_metric="AUC")


def _frames(cols, cats):
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=cats),
            h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                            device="cpu"))


@pytest.mark.parametrize("kind", sorted(CASES))
def test_forest_equals_reference_and_port_gbm(kind):
    make, extra = CASES[kind]
    cols, cats = make()
    fr_r, fr_p = _frames(cols, cats)
    kw = dict(XGB, **extra)
    m_r = RefXGB(**kw).train(fr_r, y="y")
    m_p = h2o3_tpu_torch.XGBoostEstimator(**kw).train(fr_p, y="y")
    assert m_p.output["facade"] == m_r.output["facade"] == "xgboost"
    _assert_forests(m_r, m_p)
    assert m_p.forest.is_split.sum() > 10
    col = "p1" if kind == "binomial" else "predict"
    np.testing.assert_allclose(m_p.predict(fr_p).col(col).to_numpy(),
                               m_r.predict(fr_r).col(col).to_numpy(),
                               atol=1e-6)
    gbm_kw = dict(GBM, **{("min_rows" if k == "min_child_weight" else k): v
                          for k, v in extra.items()})
    m_g = h2o3_tpu_torch.GBMEstimator(**gbm_kw).train(fr_p, y="y")
    for f in Tree._fields:
        assert torch.equal(getattr(m_p.forest, f), getattr(m_g.forest, f)), f
    keys = ("AUC", "logloss") if kind == "binomial" else ("MSE", "r2")
    for k in keys:
        assert m_p.training_metrics[k] == m_g.training_metrics[k], k


def test_inert_keys_are_logged_and_change_nothing(caplog):
    cols, cats = mixed_cols(n=400, seed=6)
    _, fr = _frames(cols, cats)
    kw = dict(nrounds=2, max_depth=3, seed=3)
    plain = h2o3_tpu_torch.XGBoostEstimator(**kw).train(fr, y="y")
    with caplog.at_level(logging.INFO, logger="h2o3_tpu_torch.xgboost"):
        m = h2o3_tpu_torch.XGBoostEstimator(
            booster="gbtree", tree_method="hist", reg_alpha=0.5,
            nthread=4, **kw).train(fr, y="y")
    assert "booster" in caplog.text and "reg_alpha" in caplog.text
    for f in Tree._fields:
        assert torch.equal(getattr(m.forest, f), getattr(plain.forest, f)), f
