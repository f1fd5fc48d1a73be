"""Isotonic Regression in the PyTorch port (on the CPU) against the
reference package.

Host numpy in both: the same float32 inputs (the port reads the float32
cast of each column's float64 host view, which is the reference's
``numeric_view`` bit for bit), the same stable sort, ``np.unique``
aggregation and PAV. So thresholds, fitted values and predictions are
EXACT. The metrics are float64 sums of float32 terms in another order:
within 1e-6 relative.
"""

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import isotonic as ref_iso
from h2o3_tpu_torch.models import isotonic as port_iso
from h2o3_tpu_torch.models.convert import isotonic_model_from_arrays

METRIC_TOL = 1e-6


def iso_cols(n=3000, seed=1, nas=True, weights=False):
    """x on a 0.1 grid (duplicates), y rising by 0.03 a unit with noise;
    NAs in x and y, and optional weights with zeros."""
    r = np.random.RandomState(seed)
    x = np.round(r.uniform(0, 100, n), 1)
    y = 0.03 * x + r.randn(n)
    if nas:
        x[::97] = np.nan
        y[5::89] = np.nan
    cols = {"x": x, "y": y}
    if weights:
        cols["w"] = np.where(r.rand(n) < 0.1, 0.0, r.uniform(0.5, 2, n))
    return cols


def _fit(cols, **kw):
    fr_r = h2o3_tpu.Frame.from_numpy(cols)
    m_r = ref_iso.IsotonicRegressionEstimator(**kw).train(fr_r, y="y",
                                                          x=["x"])
    fr_p = h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu")
    m_p = h2o3_tpu_torch.IsotonicRegressionEstimator(**kw).train(
        fr_p, y="y", x=["x"])
    return m_r, fr_r, m_p, fr_p


def _metrics_close(a, b):
    a, b = a.to_dict(), b.to_dict()
    for k, v in a.items():
        if isinstance(v, float):
            assert b[k] == pytest.approx(v, rel=METRIC_TOL, abs=1e-12,
                                         nan_ok=True), k


@pytest.mark.parametrize("case", ["plain", "nas", "weights"])
def test_thresholds_fitted_values_and_predictions_exact(case):
    cols = iso_cols(nas=case != "plain", weights=case == "weights")
    kw = {"weights_column": "w"} if case == "weights" else {}
    m_r, fr_r, m_p, fr_p = _fit(cols, **kw)
    assert m_p.tx.dtype == m_r.tx.dtype == np.float32
    np.testing.assert_array_equal(m_p.tx, m_r.tx)
    np.testing.assert_array_equal(m_p.ty, m_r.ty)
    assert np.all(np.diff(m_p.ty) >= 0)
    assert m_p.output["thresholds_x"] == m_r.output["thresholds_x"]
    assert m_p.output["thresholds_y"] == m_r.output["thresholds_y"]
    np.testing.assert_array_equal(
        m_p.predict(fr_p).col("predict").to_numpy(),
        m_r.predict(fr_r).col("predict").to_numpy())
    _metrics_close(m_r.training_metrics, m_p.training_metrics)


@pytest.mark.parametrize("oob", ["clip", "na"])
def test_out_of_bounds(oob):
    """A new frame reaching past the training range: clipped to the end
    thresholds, or NA."""
    m_r, _, m_p, _ = _fit(iso_cols(), out_of_bounds=oob)
    new = {"x": np.array([-5.0, 0.05, 33.3, 99.95, 150.0, np.nan]),
           "y": np.arange(6.0)}
    s_r = m_r._score_raw(h2o3_tpu.Frame.from_numpy(new))["predict"]
    s_p = m_p._score_raw(h2o3_tpu_torch.Frame.from_numpy(
        new, device="cpu"))["predict"]
    np.testing.assert_array_equal(s_p, s_r)
    assert np.isnan(s_p[-1])
    assert np.isnan(s_p[0]) == (oob == "na") == np.isnan(s_p[4])


def test_pav_is_the_references():
    r = np.random.RandomState(3)
    for n in (1, 2, 50, 400):
        x = np.arange(n, dtype=np.float64)
        y = r.randn(n)
        w = r.uniform(0.1, 3, n)
        np.testing.assert_array_equal(port_iso._pav(x, y, w),
                                      ref_iso._pav(x, y, w))


def test_cross_validation_matches_the_reference():
    """nfolds=3 on NA-free rows (an NA x scores NA, and the CV metrics of
    both packages are then NaN): the merged holdout metrics."""
    m_r, _, m_p, _ = _fit(iso_cols(nas=False), nfolds=3, seed=2)
    _metrics_close(m_r.cross_validation_metrics,
                   m_p.cross_validation_metrics)
    assert np.isfinite(m_p.cross_validation_metrics["MSE"])


def test_reference_model_carried_across_scores_alike():
    m_r, fr_r, _, fr_p = _fit(iso_cols(), out_of_bounds="na")
    m_c = isotonic_model_from_arrays(dict(
        thresholds_x=m_r.tx, thresholds_y=m_r.ty, output=dict(m_r.output),
        params=dict(m_r.params)))
    np.testing.assert_array_equal(m_c._score_raw(fr_p)["predict"],
                                  m_r._score_raw(fr_r)["predict"])


def test_one_feature_only():
    cols = dict(iso_cols(n=100), z=np.arange(100.0))
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu")
    with pytest.raises(ValueError, match="exactly one feature"):
        h2o3_tpu_torch.IsotonicRegressionEstimator().train(fr, y="y")
    with pytest.raises(ValueError, match="unknown Isotonic params"):
        h2o3_tpu_torch.IsotonicRegressionEstimator(increasing=False)
