"""StackedEnsemble (``h2o3_tpu_torch/ml/ensemble.py``) against the
reference's (``h2o3_tpu/ml/ensemble.py``), over the reference's OWN base
models: a GLM and a GBM trained with nfolds=3 by the reference and
carried across with their CV holdout predictions
(``models/convert.py``), so both packages stack the same level-one
frame. The metalearner's coefficients agree within COEF_TOL
(``tests/test_torch_glm.py``'s) and the ensemble's probabilities within
PRED_TOL (a regression's predictions within COEF_TOL·max(1, |pred|):
its level-one values are predictions on the response's scale, which
carry the coefficients' tolerance over),
for a binomial, a multinomial and a regression response. A base
model's multinomial level-one columns sum to 1, collinear with the
intercept, so an unpenalized multinomial metalearner's coefficients are
not unique: that case holds a ridge metalearner (``lambda_`` 1e-3), the
others the default GLM (``lambda_`` 0). The
level-one frame is built on the training frame's device; an ensemble
over base models without CV raises as the reference's does.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch as h2o
from h2o3_tpu.ml.ensemble import StackedEnsembleEstimator as RefSE
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu.models.glm import GLMEstimator as RefGLM
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.ml import ensemble
from h2o3_tpu_torch.models.convert import (gbm_model_from_arrays,
                                           glm_model_from_arrays)

from test_torch_gbm import _ref_arrays as gbm_arrays
from test_torch_glm import ref_arrays as glm_arrays

COEF_TOL = 1e-4
PRED_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _one_device():
    """The reference's fits on a one-device mesh."""
    token = ref_mesh._MESH_OVERRIDE.set(
        ref_mesh.make_mesh(jax.devices()[:1]))
    try:
        yield
    finally:
        ref_mesh._MESH_OVERRIDE.reset(token)


def _cols(kind, n=1500, seed=2):
    r = np.random.RandomState(seed)
    X = r.randn(n, 4)
    z = X @ np.array([1.2, -0.9, 0.6, 0.0]) + 0.4 * np.sin(3 * X[:, 3])
    cols = {f"x{i}": X[:, i] for i in range(4)}
    if kind == "binomial":
        y = (r.rand(n) < 1 / (1 + np.exp(-z))).astype(int)
        cols["y"] = np.array(["N", "Y"], object)[y]
    elif kind == "multinomial":
        y = np.digitize(z + 0.5 * r.randn(n), [-0.7, 0.7])
        cols["y"] = np.array(["lo", "mid", "hi"], object)[y]
    else:
        cols["y"] = z + 0.3 * r.randn(n)
    return cols


def _carried(m_r, to_port, arrays):
    d = arrays(m_r)
    d.update(cv_holdout=m_r._cv_holdout, cv_folds=m_r._cv_folds)
    return to_port(d)


@pytest.mark.parametrize("kind", ["binomial", "multinomial", "regression"])
def test_ensemble_over_the_references_base_models(kind):
    cols = _cols(kind)
    cats = [] if kind == "regression" else ["y"]
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    fr_p = h2o.Frame.from_numpy(cols, categorical=cats, device="cpu")
    meta = {"lambda_": 1e-3, "alpha": 0.0} if kind == "multinomial" \
        else None
    with _one_device():
        glm_r = RefGLM(nfolds=3, seed=1, lambda_=0.0).train(fr_r, y="y")
        gbm_r = RefGBM(nfolds=3, seed=1, ntrees=5, max_depth=3).train(
            fr_r, y="y")
        se_r = RefSE(base_models=[glm_r, gbm_r],
                     metalearner_params=meta).train(fr_r, y="y")
    glm_p = _carried(glm_r, glm_model_from_arrays, glm_arrays)
    gbm_p = _carried(gbm_r, lambda d: gbm_model_from_arrays(d, "cpu"),
                     gbm_arrays)
    h2o.DKV.put(gbm_p.key, gbm_p)     # a carried model is stored by hand
    se_p = h2o.StackedEnsembleEstimator(
        base_models=[glm_p, gbm_p.key],                      # a key too
        metalearner_params=meta).train(fr_p, y="y")
    assert se_p.output["base_models"] == [glm_p.key, gbm_p.key]
    meta_p = se_p.metalearner
    meta_r = se_r.metalearner
    assert meta_p.output["category"] == meta_r.output["category"]
    cp = np.asarray(list(meta_p.coefficients.values()), np.float64)
    cr = np.asarray(list(meta_r.coefficients.values()), np.float64)
    assert cp.shape == cr.shape
    assert np.abs(cp - cr).max() <= COEF_TOL, np.abs(cp - cr).max()
    p_p = se_p.predict(fr_p)
    p_r = se_r.predict(fr_r).to_pandas()
    for c in p_r.columns:
        if c == "predict" and kind != "regression":
            continue
        got, want = p_p.col(c).to_numpy(), p_r[c].to_numpy()
        gap = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        tol = COEF_TOL if kind == "regression" else PRED_TOL
        assert gap.max() <= tol, (c, gap.max())
    mp, mr = se_p.training_metrics, se_r.training_metrics
    key = {"binomial": "AUC", "multinomial": "logloss",
           "regression": "MSE"}[kind]
    assert mp[key] == pytest.approx(mr[key], rel=1e-5)
    perf = se_p.model_performance(fr_p)
    assert perf[key] == pytest.approx(
        se_r.model_performance(fr_r)[key], rel=1e-5)
    assert h2o.DKV.get(se_p.output["metalearner"]) is meta_p


def test_level_one_frame_and_errors():
    cols = _cols("binomial", n=600)
    fr = h2o.Frame.from_numpy(cols, categorical=["y"], device="cpu")
    a = h2o.GLMEstimator(nfolds=2, seed=1).train(fr, y="y")
    b = h2o.GBMEstimator(nfolds=2, seed=1, ntrees=3, max_depth=3).train(
        fr, y="y")
    cols1 = {}
    for m in (a, b):
        cols1.update(ensemble._level_one_columns(m, None))
    assert list(cols1) == [a.key, b.key]
    l1 = ensemble._with_response(cols1, fr.col("y"), "y", fr.nrows,
                                 fr.device)
    assert l1.device == fr.device and l1.col("y").domain == ["N", "Y"]
    np.testing.assert_array_equal(l1.col(a.key).host_view(),
                                  a._cv_holdout.astype(np.float64))
    se = h2o.StackedEnsembleEstimator(base_models=[a, b],
                                      metalearner_algorithm="gbm",
                                      metalearner_params={"ntrees": 3}
                                      ).train(fr, y="y")
    assert se.metalearner.algo == "gbm"
    plain = h2o.GLMEstimator(seed=1).train(fr, y="y")
    with pytest.raises(ValueError, match="lacks CV holdout"):
        h2o.StackedEnsembleEstimator(base_models=[a, plain]).train(fr,
                                                                   y="y")
    with pytest.raises(ValueError, match=">= 2 base models"):
        h2o.StackedEnsembleEstimator(base_models=[a]).train(fr, y="y")
