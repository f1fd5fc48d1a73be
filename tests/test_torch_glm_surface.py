"""GLM's option surface in the PyTorch port (on the CPU) against the
reference package: multinomial (IRLSM and L-BFGS), ordinal,
interactions, an offset column, a weights column, ``non_negative`` and
``beta_constraints`` (COD), cross-validation with and without lambda
search, and each unported parameter raising. Coefficients are held
within 1e-4·max(1, |c|) unless a test states otherwise (float32 sums in
another order, see tests/test_torch_glm.py), probabilities within 1e-5.
Every frame has fewer than 32,768 rows; torch runs on one thread.
"""

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import glm as ref_glm
from h2o3_tpu_torch.models import glm
from h2o3_tpu_torch.parallel import mesh as mesh_mod

from tests.test_torch_glm import (COEF_TOL, assert_coefs, frames,
                                  mixed_cols)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fit_both(cols, cats, **kw):
    fr_r, fr_p = frames(cols, cats)
    m_r = ref_glm.GLMEstimator(**kw).train(fr_r, y="y")
    m_p = glm.GLMEstimator(**kw).train(fr_p, y="y")
    return m_r, m_p, fr_r, fr_p


def probs_of(pred, K, ref: bool) -> np.ndarray:
    if ref:
        pred = pred.to_pandas()
        return np.stack([pred[f"p{k}"].to_numpy() for k in range(K)], 1)
    return np.stack([pred.col(f"p{k}").to_numpy() for k in range(K)], 1)


def three_class_cols(n=4000, seed=0, names=("a", "b", "c")):
    cols = mixed_cols(n=n, seed=seed)
    r = np.random.RandomState(seed + 100)
    lat = cols["x0"] + 0.6 * (cols["c0"] == "green") + 0.7 * r.logistic(
        size=n)
    cols["y"] = np.array(names, object)[np.digitize(lat, [-0.5, 0.6])]
    return cols


@pytest.mark.parametrize("solver", ["irlsm", "l_bfgs"])
def test_multinomial_matches_the_reference(solver):
    cols = three_class_cols()
    m_r, m_p, fr_r, fr_p = fit_both(cols, ["c0", "c1", "y"],
                                    family="multinomial", solver=solver,
                                    lambda_=1e-3, max_iterations=40)
    # L-BFGS: a float64 host recursion on float32 gradients; the two may
    # stop a line-search step apart near the optimum
    tol = COEF_TOL if solver == "irlsm" else 2e-3
    assert_coefs(m_p.coefficients, m_r.coefficients, tol=tol)
    np.testing.assert_allclose(probs_of(m_p.predict(fr_p), 3, False),
                               probs_of(m_r.predict(fr_r), 3, True),
                               atol=1e-5 if solver == "irlsm" else 1e-3)
    assert m_p.training_metrics["logloss"] == pytest.approx(
        m_r.training_metrics["logloss"], rel=1e-5 if solver == "irlsm"
        else 1e-4)


def test_ordinal_matches_the_reference():
    cols = three_class_cols(seed=1, names=("l0_low", "l1_mid", "l2_high"))
    m_r, m_p, fr_r, fr_p = fit_both(cols, ["c0", "c1", "y"],
                                    family="ordinal", lambda_=0.0)
    assert m_p.output["category"] == "Ordinal"
    np.testing.assert_allclose(m_p.coef, np.asarray(m_r.coef), atol=2e-3)
    np.testing.assert_allclose(m_p.output["ordinal_alphas"],
                               m_r.output["ordinal_alphas"], atol=2e-3)
    np.testing.assert_allclose(probs_of(m_p.predict(fr_p), 3, False),
                               probs_of(m_r.predict(fr_r), 3, True),
                               atol=1e-3)
    assert m_p.training_metrics.kind == "Ordinal"
    assert m_p.training_metrics["logloss"] == pytest.approx(
        m_r.training_metrics["logloss"], rel=1e-4)


def test_interactions_match_the_reference():
    # 4096 rows: the reference pads this frame by no row. Its enum x num
    # columns count its padding rows as valid zeros in their mean and
    # sigma; the port's padding is NA in every column
    cols = mixed_cols(n=4096, seed=2, response="gaussian")
    inter = ["x0", "x1", "c0", "c1"]
    # every level of c0 times x0 adds up to x0: a ridge keeps the
    # collinear design's Gram positive definite in float32
    m_r, m_p, fr_r, fr_p = fit_both(cols, ["c0", "c1"], family="gaussian",
                                    lambda_=0.05, alpha=0.0,
                                    interactions=inter)
    assert m_p.output["coef_names"] == m_r.output["coef_names"]
    assert "c0_c1" in m_p.output["names"]
    assert_coefs(m_p.coefficients, m_r.coefficients)
    te = mixed_cols(n=500, seed=11, response="gaussian")
    te_r, te_p = frames(te, ["c0", "c1"])
    np.testing.assert_allclose(
        m_p.predict(te_p).col("predict").to_numpy(),
        m_r.predict(te_r).to_pandas()["predict"].to_numpy(), rtol=1e-5,
        atol=1e-5)
    # the string spelling of the list parses alike
    m_s = glm.GLMEstimator(family="gaussian", lambda_=0.0,
                           interactions='["x0", "x1"]').train(fr_p, y="y")
    assert "x0_x1" in m_s.output["coef_names"]


@pytest.mark.parametrize("family", ["gaussian", "poisson"])
def test_offset_column_matches_the_reference(family):
    r = np.random.RandomState(3)
    n = 5000
    x0 = r.randn(n)
    off = r.randn(n) * 0.3
    eta = 0.5 + 0.8 * x0 + off
    y = (eta + 0.2 * r.randn(n) if family == "gaussian"
         else r.poisson(np.exp(eta)).astype(float))
    cols = {"x0": x0, "off": off, "y": y}
    m_r, m_p, fr_r, fr_p = fit_both(cols, [], family=family, lambda_=0.0,
                                    offset_column="off")
    assert "off" not in m_p.coefficients
    assert_coefs(m_p.coefficients, m_r.coefficients)
    np.testing.assert_allclose(
        m_p.predict(fr_p).col("predict").to_numpy(),
        m_r.predict(fr_r).to_pandas()["predict"].to_numpy(), rtol=1e-5,
        atol=1e-5)
    assert m_p.coefficients["x0"] == pytest.approx(0.8, abs=0.05)


def test_weights_column_matches_the_reference():
    cols = mixed_cols(n=4000, seed=4)
    r = np.random.RandomState(4)
    cols["wt"] = r.choice([0.0, 0.5, 1.0, 3.0], 4000)
    cols["wt"][:7] = np.nan                       # NA weight = 0
    m_r, m_p, fr_r, fr_p = fit_both(cols, ["c0", "c1", "y"],
                                    family="binomial", lambda_=0.0,
                                    weights_column="wt")
    assert "wt" not in m_p.output["names"]
    assert_coefs(m_p.coefficients, m_r.coefficients)
    for k in ("AUC", "logloss"):
        assert m_p.training_metrics[k] == pytest.approx(
            m_r.training_metrics[k], rel=1e-5), k
    mp, mr = m_p.model_performance(fr_p), m_r.model_performance(fr_r)
    assert mp["logloss"] == pytest.approx(mr["logloss"], rel=1e-5)


@pytest.mark.parametrize("how", ["non_negative", "dict", "frame"])
def test_constrained_cod_matches_the_reference(how):
    cols = mixed_cols(n=4000, seed=5, response="gaussian")
    cols["y"] = cols["y"] - 1.9 * cols["x0"]      # a slope of -1.1
    kw = dict(family="gaussian", lambda_=0.0, standardize=False)
    if how == "non_negative":
        kw["non_negative"] = True
    else:
        bc = {"names": np.array(["x0", "c0.green"], object),
              "lower_bounds": np.array([-0.5, 0.0]),
              "upper_bounds": np.array([0.5, 0.3])}
        kw_r, kw_p = dict(kw), dict(kw)
        if how == "dict":
            kw_r["beta_constraints"] = kw_p["beta_constraints"] = {
                "x0": (-0.5, 0.5), "c0.green": (0.0, 0.3)}
        else:
            kw_r["beta_constraints"] = h2o3_tpu.Frame.from_numpy(bc)
            kw_p["beta_constraints"] = h2o3_tpu_torch.Frame.from_numpy(
                bc, device="cpu")
    fr_r, fr_p = frames(cols, ["c0", "c1"])
    if how == "non_negative":
        m_r = ref_glm.GLMEstimator(**kw).train(fr_r, y="y")
        m_p = glm.GLMEstimator(**kw).train(fr_p, y="y")
    else:
        m_r = ref_glm.GLMEstimator(**kw_r).train(fr_r, y="y")
        m_p = glm.GLMEstimator(**kw_p).train(fr_p, y="y")
    assert_coefs(m_p.coefficients, m_r.coefficients)
    c = m_p.coefficients
    if how == "non_negative":
        assert min(v for k, v in c.items() if k != "Intercept") >= 0.0
    else:
        assert c["x0"] == pytest.approx(-0.5, abs=1e-6)
        assert 0.0 <= c["c0.green"] <= 0.3 + 1e-7


@pytest.mark.parametrize("search", [False, True])
def test_cross_validation_matches_the_reference(search):
    cols = mixed_cols(n=3000, seed=6, response="gaussian")
    kw = dict(family="gaussian", nfolds=3, seed=7)
    kw.update(dict(lambda_search=True, nlambdas=6, alpha=0.5)
              if search else dict(lambda_=0.0))
    m_r, m_p, _, _ = fit_both(cols, ["c0", "c1"], **kw)
    cv_r, cv_p = m_r.cross_validation_metrics, m_p.cross_validation_metrics
    for k in ("MSE", "r2", "mae"):
        assert cv_p[k] == pytest.approx(cv_r[k], rel=1e-5), k
    np.testing.assert_array_equal(m_p._cv_folds, m_r._cv_folds)
    assert len(m_p._cv_models) == 3
    assert m_p.output["lambda_best"] == pytest.approx(
        m_r.output["lambda_best"], rel=1e-5)
    assert_coefs(m_p.coefficients, m_r.coefficients)
    if search:
        # the folds walked the main model's path; the refit kept the
        # lambda of the least summed holdout deviance
        assert m_p.output["lambda_best"] in m_p._lambda_path_vals
        for fm in m_p._cv_models:
            assert fm._lambda_path_vals == m_p._lambda_path_vals


def test_unported_and_invalid_parameters_raise():
    cols = mixed_cols(n=400, seed=8)
    _, fr = frames(cols, ["c0", "c1", "y"])
    # the CV frame keys and a beta_constraints key came with the DKV
    m = glm.GLMEstimator(nfolds=2, seed=1,
                         keep_cross_validation_predictions=True,
                         keep_cross_validation_fold_assignment=True
                         ).train(fr, y="y")
    from h2o3_tpu_torch.core.kv import DKV
    np.testing.assert_array_equal(
        DKV.get(m.output["cv_fold_assignment_key"]).col(
            "fold_assignment").to_numpy(), m._cv_folds.astype(np.float64))
    with pytest.raises(ValueError, match="no frame under the key"):
        glm.GLMEstimator(beta_constraints="bc_key").train(fr, y="y")
    with pytest.raises(NotImplementedError, match="A #9′"):
        glm.fit_glm_batched(glm.GLMEstimator, [{}], fr, y="y")
    with pytest.raises(ValueError, match="unknown GLM params"):
        glm.GLMEstimator(not_a_param=1)
    with pytest.raises(ValueError, match="Incompatible link"):
        glm.GLMEstimator(family="binomial", link="log").train(fr, y="y")
    with pytest.raises(ValueError, match="not supported for multinomial"):
        glm.GLMEstimator(family="multinomial",
                         compute_p_values=True).train(
            frames(three_class_cols(n=400), ["c0", "c1", "y"])[1], y="y")
    # the aliases of h2o-py
    est = glm.GLMEstimator(Lambda=0.1, tweedie_variance_power=1.2)
    assert est.params["lambda_"] == 0.1 and est.params["tweedie_power"] == 1.2
    fr.mesh = mesh_mod.Mesh(None, None, 0, 2)        # as if sharded
    with pytest.raises(NotImplementedError, match="sharded mesh"):
        glm.GLMEstimator(lambda_=0.0).train(fr, y="y")
