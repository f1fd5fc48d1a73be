"""Calibration parity of the PyTorch port (on the CPU) against the
reference package: Platt scaling and isotonic regression
(``h2o3_tpu_torch/ml/calibration.py``) and the ``cal_p0`` / ``cal_p1``
columns a calibrated model's ``predict`` adds.

The fits are the reference's numpy code: on the same scores they give
the same (a, b) and the same isotonic steps. DRF's binomial scores carry
across bit for bit (``models/convert.py``), so a converted reference DRF
calibrates in the port exactly as in the reference: ``cal_p1`` within
1e-9. A GBM trained in each package scores within 1e-6, so its Platt
(a, b) agree within 1e-4 and ``cal_p1`` within 1e-5; its isotonic map
is a step function, on which scores an ulp apart may take different
steps, so there the port's steps are held equal to the reference code's
fit on the port's own scores."""

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.ml import calibration as ref_cal
from h2o3_tpu.models.drf import DRFEstimator as RefDRF
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu_torch.ml import calibration as cal
from h2o3_tpu_torch.models.convert import drf_model_from_arrays

from test_torch_drf import _ref_arrays as _drf_arrays
from torch_ranks import mixed_cols
from torch_threads import one_torch_thread  # noqa: F401 - autouse

METHODS = ("PlattScaling", "IsotonicRegression")


def _frames(seed):
    cols, cats = mixed_cols(n=600, seed=seed)
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=cats),
            h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                            device="cpu"))


def test_fits_equal_reference_on_the_same_scores():
    r = np.random.RandomState(3)
    p = r.rand(5000)
    y = (r.rand(5000) < p ** 1.5).astype(float)
    assert cal.fit_platt(p, y) == ref_cal.fit_platt(p, y)
    for a, b in zip(cal.fit_isotonic(p, y), ref_cal.fit_isotonic(p, y)):
        np.testing.assert_array_equal(a, b)
    for m in ("plattscaling", "isotonic"):
        fit = cal.fit_platt if m == "plattscaling" else cal.fit_isotonic
        c, rc = cal.Calibrator(m, fit(p, y)), ref_cal.Calibrator(m, fit(p, y))
        np.testing.assert_array_equal(c.apply(p[:100]), rc.apply(p[:100]))


@pytest.mark.parametrize("method", METHODS)
def test_converted_drf_calibrates_as_the_reference(method):
    """A reference DRF calibrated on its own calibration frame: the port
    fits the same calibrator on the converted model's scores, and a
    converted calibrated model predicts the same cal_p0 / cal_p1."""
    (fr_r, _), (cf_r, cf_p) = _frames(6), _frames(9)
    m_r = RefDRF(ntrees=4, max_depth=5, seed=2, calibrate_model=True,
                 calibration_frame=cf_r,
                 calibration_method=method).train(fr_r, y="y")
    d = _drf_arrays(m_r)
    plain = drf_model_from_arrays(d, device="cpu")
    cal.calibrate_model(plain, cf_p, method)
    for a, b in zip(plain.calibrator.params, m_r.calibrator.params):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    d["calibrator"] = (m_r.calibrator.method, m_r.calibrator.params)
    carried = drf_model_from_arrays(d, device="cpu")
    p_r = m_r.predict(cf_r)
    for m in (plain, carried):
        p_p = m.predict(cf_p)
        assert p_p.names == p_r.names
        for c in ("cal_p0", "cal_p1"):
            np.testing.assert_allclose(p_p.col(c).to_numpy(),
                                       p_r.col(c).to_numpy(), rtol=0,
                                       atol=1e-9, err_msg=c)


@pytest.mark.parametrize("method", METHODS)
def test_gbm_calibrate_model_matches_reference(method):
    (fr_r, fr_p), (cf_r, cf_p) = _frames(6), _frames(9)
    kw = dict(ntrees=4, max_depth=4, seed=11, calibrate_model=True,
              calibration_method=method)
    m_r = RefGBM(calibration_frame=cf_r, **kw).train(fr_r, y="y")
    m_p = h2o3_tpu_torch.GBMEstimator(calibration_frame=cf_p, **kw).train(
        fr_p, y="y")
    cp_r = m_r.predict(cf_r).col("cal_p1").to_numpy()
    cp_p = m_p.predict(cf_p).col("cal_p1").to_numpy()
    assert ((cp_p >= 0) & (cp_p <= 1)).all()
    if method == "PlattScaling":
        np.testing.assert_allclose(m_p.calibrator.params,
                                   m_r.calibrator.params, atol=1e-4)
        np.testing.assert_allclose(cp_p, cp_r, atol=1e-5)
        return
    p1 = np.asarray(m_p._score_raw(cf_p)["p1"], np.float64)
    y = (cf_p.col("y").to_numpy() == 1).astype(float)
    for a, b in zip(m_p.calibrator.params, ref_cal.fit_isotonic(p1, y)):
        np.testing.assert_array_equal(a, b)


def test_calibration_errors():
    _, fr = _frames(6)
    _, cf = _frames(9)
    with pytest.raises(ValueError, match="requires calibration_frame"):
        h2o3_tpu_torch.GBMEstimator(ntrees=1, calibrate_model=True).train(
            fr, y="y")
    with pytest.raises(ValueError, match="no frame under the key"):
        h2o3_tpu_torch.GBMEstimator(ntrees=1, calibrate_model=True,
                                    calibration_frame="frame_key").train(
            fr, y="y")
    # a frame's DKV key calibrates as the frame does
    h2o3_tpu_torch.DKV.put("cal_frame_key", cf)
    by_key, by_frame = (h2o3_tpu_torch.GBMEstimator(
        ntrees=1, calibrate_model=True, calibration_frame=c).train(fr, y="y")
        for c in ("cal_frame_key", cf))
    np.testing.assert_array_equal(
        by_key.predict(fr).col("cal_p1").to_numpy(),
        by_frame.predict(fr).col("cal_p1").to_numpy())
    h2o3_tpu_torch.DKV.remove("cal_frame_key")
    with pytest.raises(ValueError, match="unknown calibration_method"):
        h2o3_tpu_torch.GBMEstimator(ntrees=1, calibrate_model=True,
                                    calibration_frame=cf,
                                    calibration_method="magic").train(
            fr, y="y")
    from torch_ranks import regression_cols
    cols, cats = regression_cols(n=200)
    rf = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    with pytest.raises(ValueError, match="only supported for binomial"):
        h2o3_tpu_torch.DRFEstimator(ntrees=1, calibrate_model=True,
                                    calibration_frame=rf).train(rf, y="y")
