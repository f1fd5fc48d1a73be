"""Cross-validation parity of the PyTorch port (on the CPU) against the
reference package (``h2o3_tpu_torch/ml/cv.py`` against
``h2o3_tpu/ml/cv.py``).

Both packages get the same numpy columns. The folds are drawn alike
(``fold_assignment`` is the reference's numpy code). The fits are
deterministic (no row or column sampling; DRF scores every column) and
the data is tie-free (each case's seed chosen so that no fold model meets
a near-tie split in either summation order, under this suite's 8-device
environment), so every fold model grows the reference's trees:
holdout predictions within 1e-6, the CV metrics and the per-fold
summary rows within 1e-6 (float32 sums in another order)."""

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.ml import cv as ref_cv
from h2o3_tpu.models.drf import DRFEstimator as RefDRF
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu_torch.frame import binning
from h2o3_tpu_torch.ml import cv
from h2o3_tpu_torch.models import drf as drf_mod
from h2o3_tpu_torch.models import gbm as gbm_mod

from torch_ranks import mixed_cols, multi_cols, regression_cols

GBM_KW = dict(ntrees=4, max_depth=4, seed=11, sample_rate=1.0,
              col_sample_rate_per_tree=1.0)
DRF_KW = dict(ntrees=4, max_depth=5, seed=11, sample_rate=1.0, mtries=5)
METRICS = {"Binomial": ("AUC", "logloss", "MSE"),
           "Regression": ("MSE", "mae", "mean_residual_deviance"),
           "Multinomial": ("logloss", "MSE", "mean_per_class_error")}


def _frames(cols, cats):
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=cats),
            h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                            device="cpu"))


def _cv_both(ref_cls, port_cls, cols, cats, **kw):
    fr_r, fr_p = _frames(cols, cats)
    return (ref_cls(**kw).train(fr_r, y="y"),
            port_cls(**kw).train(fr_p, y="y"))


def _assert_cv_equal(m_r, m_p, nfolds):
    np.testing.assert_array_equal(m_p._cv_folds, m_r._cv_folds)
    np.testing.assert_allclose(m_p._cv_holdout, m_r._cv_holdout, rtol=0,
                               atol=1e-6)
    cat = m_p.output["category"]
    for k in METRICS[cat]:
        assert m_p.cross_validation_metrics[k] == pytest.approx(
            m_r.cross_validation_metrics[k], rel=1e-6, abs=1e-6), k
    assert m_p.cross_validation_metrics.nobs == \
        m_r.cross_validation_metrics.nobs
    rows_r = {r[0]: r for r in m_r.output["cv_summary_rows"]}
    rows_p = {r[0]: r for r in m_p.output["cv_summary_rows"]}
    assert set(rows_p) == set(rows_r)
    for k, row in rows_r.items():
        assert len(rows_p[k]) == 3 + nfolds
        np.testing.assert_allclose(np.array(rows_p[k][1:], float),
                                   np.array(row[1:], float), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert len(m_p._cv_models) == len(m_r._cv_models) == nfolds
    assert m_p.output["nfolds"] == m_r.output["nfolds"] == nfolds


@pytest.mark.parametrize("scheme", ["modulo", "random", "stratified"])
def test_fold_assignment_matches_reference(scheme):
    y = np.random.RandomState(4).randint(0, 3, 997)
    for nfolds, seed in ((3, 1), (5, 0xF01D), (10, 123456789012)):
        np.testing.assert_array_equal(
            cv.fold_assignment(997, nfolds, scheme, seed, y),
            ref_cv.fold_assignment(997, nfolds, scheme, seed, y))


@pytest.mark.parametrize("algo", ["gbm", "drf"])
def test_binomial_cv_matches_reference(algo, monkeypatch):
    """Modulo folds: the fast path (main model first, folds on the parent
    frame with the held-out rows at weight 0) bins once a CV fit."""
    calls = []
    real = binning.bin_frame

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    for mod in (binning, gbm_mod, drf_mod):
        monkeypatch.setattr(mod, "bin_frame", counted)
    ref_cls, port_cls, kw = ((RefGBM, h2o3_tpu_torch.GBMEstimator, GBM_KW)
                             if algo == "gbm" else
                             (RefDRF, h2o3_tpu_torch.DRFEstimator, DRF_KW))
    cols, cats = mixed_cols(seed=5)
    m_r, m_p = _cv_both(ref_cls, port_cls, cols, cats, nfolds=3,
                        fold_assignment="modulo", **kw)
    assert len(calls) == 1
    _assert_cv_equal(m_r, m_p, 3)
    # the main model is the plain fit on all rows
    plain = port_cls(**kw).train(_frames(cols, cats)[1], y="y")
    for f in ("feat", "thresh", "is_split"):
        np.testing.assert_array_equal(getattr(m_p.forest, f).numpy(),
                                      getattr(plain.forest, f).numpy())


@pytest.mark.parametrize("case", ["regression", "multinomial",
                                  "fold_column", "stratified"])
def test_cv_cases_match_reference(case):
    kw = dict(GBM_KW, nfolds=3, fold_assignment="modulo")
    if case == "regression":
        cols, cats = regression_cols(seed=2)
        kw.update(distribution="gaussian", min_rows=5.0)
    elif case == "multinomial":
        cols, cats = multi_cols(seed=2)
    else:
        cols, cats = mixed_cols(seed=0)
        if case == "fold_column":
            cols = dict(cols, fold=np.arange(len(cols["y"])) % 4)
            kw.update(nfolds=0, fold_column="fold")
            kw.pop("fold_assignment")
        else:
            kw.update(fold_assignment="stratified")
    m_r, m_p = _cv_both(RefGBM, h2o3_tpu_torch.GBMEstimator, cols, cats,
                        **kw)
    _assert_cv_equal(m_r, m_p, 4 if case == "fold_column" else 3)
    if case == "fold_column":
        assert "fold" not in m_p.output["names"]


def test_subset_frame_path_matches_reference(monkeypatch):
    """Builders without ``cv_fold_masking`` train each fold on a subset
    frame (its own binning) and score a holdout frame."""
    monkeypatch.setattr(RefGBM, "cv_fold_masking", False)
    monkeypatch.setattr(h2o3_tpu_torch.GBMEstimator, "cv_fold_masking",
                        False)
    cols, cats = mixed_cols(seed=3)
    m_r, m_p = _cv_both(RefGBM, h2o3_tpu_torch.GBMEstimator, cols, cats,
                        nfolds=3, fold_assignment="modulo", **GBM_KW)
    _assert_cv_equal(m_r, m_p, 3)


def test_near_leave_one_out_cv_matches_reference():
    """nfolds >= max(100, nrows / 2): the light sweep (no per-fold
    metrics, one fetch of the holdout scores at the end)."""
    cols, cats = mixed_cols(n=120, seed=6)
    kw = dict(ntrees=2, max_depth=2, seed=11, min_rows=2.0, nfolds=100,
              fold_assignment="modulo")
    m_r, m_p = _cv_both(RefGBM, h2o3_tpu_torch.GBMEstimator, cols, cats,
                        **kw)
    np.testing.assert_allclose(m_p._cv_holdout, m_r._cv_holdout, rtol=0,
                               atol=1e-6)
    for k in METRICS["Binomial"]:
        assert m_p.cross_validation_metrics[k] == pytest.approx(
            m_r.cross_validation_metrics[k], rel=1e-6, abs=1e-6), k
    assert m_p._cv_models == [] and m_p.output["cv_summary_rows"] == []


@pytest.mark.parametrize("kw,message", [
    (dict(nfolds=1), "nfolds must be either 0 or >1"),
    (dict(nfolds=-2), "nfolds must be either 0 or >1"),
    (dict(nfolds=10_000), "cannot exceed the number of rows"),
    (dict(nfolds=3, fold_column="fold"), "only one of nfolds or fold_column"),
    (dict(fold_column="fold", fold_assignment="modulo"),
     "fold_assignment is incompatible with fold_column"),
], ids=["one", "negative", "above_nrows", "both", "assignment_with_column"])
def test_cv_validation_errors_match_reference(kw, message):
    cols, cats = mixed_cols(n=200, seed=1)
    cols = dict(cols, fold=np.arange(200) % 3)
    fr_r, fr_p = _frames(cols, cats)
    with pytest.raises(Exception, match=message) as ref_err:
        RefGBM(ntrees=1, **kw).train(fr_r, y="y")
    with pytest.raises(ValueError, match=message) as port_err:
        h2o3_tpu_torch.GBMEstimator(ntrees=1, **kw).train(fr_p, y="y")
    assert str(port_err.value) in str(ref_err.value)


def test_unported_cv_outputs_raise():
    """The CV outputs that are frame keys came with the DKV: each flag
    stores its frame, which holds ``_cv_holdout`` / ``_cv_folds``."""
    cols, cats = mixed_cols(n=300, seed=1)
    _, fr = _frames(cols, cats)
    for cls in (h2o3_tpu_torch.GBMEstimator, h2o3_tpu_torch.DRFEstimator):
        m = cls(nfolds=3, ntrees=2, seed=1,
                keep_cross_validation_predictions=True,
                keep_cross_validation_fold_assignment=True).train(fr, y="y")
        hold = h2o3_tpu_torch.DKV.get(m.output["cv_holdout_frame_key"])
        np.testing.assert_array_equal(hold.col("p1").to_numpy(),
                                      m._cv_holdout.astype(np.float64))
        fa = h2o3_tpu_torch.DKV.get(m.output["cv_fold_assignment_key"])
        np.testing.assert_array_equal(
            fa.col("fold_assignment").to_numpy(),
            m._cv_folds.astype(np.float64))
        assert len(m.output["cv_predictions_keys"]) == 3


def test_cv_seed_and_runtime_split():
    """An unset seed draws a real random fold seed; a runtime cap gives
    the main model half and the folds the other half."""
    cols, cats = mixed_cols(n=300, seed=1)
    _, fr = _frames(cols, cats)
    a, b = (h2o3_tpu_torch.GBMEstimator(ntrees=2, nfolds=3).train(fr, y="y")
            for _ in range(2))
    assert not np.array_equal(a._cv_folds, b._cv_folds)
    caps = []
    real = gbm_mod.GBMEstimator._fit

    def spy(self, *args, **kw):
        caps.append(self.params["max_runtime_secs"])
        return real(self, *args, **kw)

    gbm_mod.GBMEstimator._fit = spy
    try:
        h2o3_tpu_torch.GBMEstimator(ntrees=2, nfolds=4, seed=1,
                                    max_runtime_secs=80.0).train(fr, y="y")
    finally:
        gbm_mod.GBMEstimator._fit = real
    assert caps == [40.0] + [10.0] * 4
