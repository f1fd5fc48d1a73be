"""Custom distributions and custom metrics (``h2o3_tpu_torch/core/udf.py``)
against the reference's (``h2o3_tpu/core/udf.py``; its own test is
``tests/test_udf.py``).

A custom distribution with gaussian semantics gives the built-in
gaussian's forest bit for bit in the port, and, uploaded to each package
(torch callables to the port, jnp ones to the reference), the same
forest as the reference's custom fit (integer fields EXACT, leaves
within rtol 1e-5, as ``tests/test_torch_gbm.py`` holds the built-in
families; sampling off, the regression columns of that file). An
asymmetric loss shifts the predictions as its gradient says; uploaded
metrics resolve from ``"python:<key>"`` references.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch as h2o
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from torch_ranks import regression_cols

from test_torch_gbm import PARAMS, _assert_forests

CPU = "cpu"


class PortGaussian:
    def link(self):
        return "identity"

    def gradient(self, y, f):
        return f - y

    def hessian(self, y, f):
        return torch.ones_like(f)

    def deviance(self, y, f):
        return (y - f) ** 2

    def init(self, m):
        return m


class RefGaussian(PortGaussian):
    def hessian(self, y, f):
        return jnp.ones_like(f)


class OverpredictPenalty:
    """Overprediction costs 9x underprediction: predictions go low."""

    def link(self):
        return "identity"

    def gradient(self, y, f):
        return torch.where(f > y, 9.0, -1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fr(n=3000, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(n)
    return h2o.Frame.from_numpy({"x": x, "y": 3.0 * x + r.randn(n)},
                                device=CPU)


def test_custom_gaussian_equals_builtin_and_the_reference():
    cols, cats = regression_cols()
    kw = dict(min_rows=5.0, **PARAMS)
    fr_p = h2o.Frame.from_numpy(cols, categorical=cats, device=CPU)
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    ref_p = h2o.upload_custom_distribution(PortGaussian)
    assert ref_p.startswith("python:")
    builtin = h2o.GBMEstimator(distribution="gaussian", **kw).train(
        fr_p, y="y")
    custom = h2o.GBMEstimator(distribution="custom",
                              custom_distribution_func=ref_p, **kw).train(
        fr_p, y="y")
    for f in builtin.forest._fields:
        assert torch.equal(getattr(builtin.forest, f),
                           getattr(custom.forest, f)), f
    assert custom.dist_name == "custom"
    np.testing.assert_array_equal(
        custom.predict(fr_p).col("predict").to_numpy(),
        builtin.predict(fr_p).col("predict").to_numpy())
    ref_r = h2o3_tpu.upload_custom_distribution(RefGaussian)
    m_r = RefGBM(distribution="custom", custom_distribution_func=ref_r,
                 **kw).train(fr_r, y="y")
    _assert_forests(m_r, custom)


def test_custom_asymmetric_loss_shifts_predictions():
    fr = _fr(seed=3)
    ref = h2o.upload_custom_distribution(OverpredictPenalty())
    m = h2o.GBMEstimator(ntrees=40, max_depth=3, learn_rate=0.3,
                         distribution="custom",
                         custom_distribution_func=ref).train(fr, x=["x"],
                                                             y="y")
    resid = fr.col("y").to_numpy() - m.predict(fr).col("predict").to_numpy()
    # the gradient balances at P(f > y) = 0.1: ~90% of residuals positive
    assert (resid > 0).mean() > 0.75, (resid > 0).mean()


def test_custom_metric_reference_and_callable():
    fr = _fr(seed=5)

    def mae(y, preds, w):
        return float(np.mean(np.abs(y - preds["predict"])))

    ref = h2o.upload_custom_metric(mae)
    m = h2o.GBMEstimator(ntrees=3, max_depth=3).train(
        fr, x=["x"], y="y", custom_metric_func=ref)
    assert m.output["custom_metric"] > 0
    assert m.training_metrics["custom"] == m.output["custom_metric"]
    m2 = h2o.GBMEstimator(ntrees=3, max_depth=3).train(
        fr, x=["x"], y="y", custom_metric_func=mae)
    assert m2.output["custom_metric"] == m.output["custom_metric"]
    assert m.output["custom_metric"] == pytest.approx(
        m.training_metrics["mae"], rel=1e-6)


def test_custom_distribution_validation():
    with pytest.raises(ValueError):
        h2o.upload_custom_distribution(object())
    with pytest.raises(ValueError):
        h2o.upload_custom_metric("not callable")
    with pytest.raises(ValueError, match="custom_distribution_func"):
        h2o.GBMEstimator(distribution="custom").train(_fr(), x=["x"],
                                                      y="y")
    with pytest.raises(ValueError, match="no uploaded UDF"):
        h2o.GBMEstimator(distribution="custom",
                         custom_distribution_func="python:nope").train(
            _fr(), x=["x"], y="y")
