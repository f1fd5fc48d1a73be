"""Naive Bayes in the PyTorch port (on the CPU) against the reference
package.

The same seeded numpy frames (numerics with NAs, categoricals with NAs
and a level a class never takes, a binomial or a 4-class response with
some NAs) go through both. The statistics are float32 sums in another
order (an ``index_add_`` here, an XLA one-hot product there). Priors
and level tables come from counts: within 1e-6 relative. A float32 sum's
rounding scales with its terms, not with the result, and at ~2,000 rows
a class the two orders part by up to ~1e-6 of √E[x²]; so a mean is held
within 2e-6·√(μ² + σ²) and a deviation √(E[x²] − μ²) within
2e-6·(μ² + σ²)/σ (``assert_moments``). Probabilities within 1e-5; the
metrics within 1e-5 relative. The reference's fits run on a one-device
mesh.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import naivebayes as ref_nb
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.ml.cv import fold_assignment
from h2o3_tpu_torch.models.convert import naivebayes_model_from_arrays

STAT_TOL = 1e-6
PROB_TOL = 1e-5
METRIC_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _one_device():
    """The reference's frames and fits on a one-device mesh."""
    token = ref_mesh._MESH_OVERRIDE.set(
        ref_mesh.make_mesh(jax.devices()[:1]))
    try:
        yield
    finally:
        ref_mesh._MESH_OVERRIDE.reset(token)


def nb_cols(n=4096, seed=0, K=2):
    """Two numerics and two categoricals that depend on a K-class
    response (NAs in each); level "q" of c1 only with class 0."""
    r = np.random.RandomState(seed)
    labels = np.array(["a", "b", "c", "d"][:K], object)
    yc = r.randint(0, K, n)
    x0 = 0.8 * yc + r.randn(n)
    x1 = 2.0 - 0.5 * yc + 1.5 * r.randn(n)
    x1[r.rand(n) < 0.05] = np.nan
    c0 = np.array(["u", "v", "w"], object)[(yc + r.randint(0, 2, n)) % 3]
    c0[r.rand(n) < 0.04] = None
    c1 = np.where(r.rand(n) < 0.5, "p", "r").astype(object)
    c1[(yc == 0) & (r.rand(n) < 0.2)] = "q"
    y = labels[yc]
    y[r.rand(n) < 0.02] = None
    return {"x0": x0, "x1": x1, "c0": c0, "c1": c1, "y": y}


def frames(cols):
    cats = ["c0", "c1", "y"]
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    return fr_r, h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                                 device="cpu")


def assert_moments(mu_p, sd_p, mu_r, sd_r):
    """Means within 2e-6·√(μ² + σ²), deviations within 2e-6·(μ² + σ²)/σ
    (the reference's μ and σ)."""
    mu, sd = np.asarray(mu_r, np.float64), np.asarray(sd_r, np.float64)
    ms = mu * mu + sd * sd
    assert (np.abs(mu_p - mu) <= 2 * STAT_TOL * np.sqrt(ms)).all(), \
        (mu_p, mu)
    assert (np.abs(sd_p - sd) <= 2 * STAT_TOL * ms / sd).all(), (sd_p, sd)


def assert_stats(sp, sr):
    np.testing.assert_allclose(sp["priors"], sr["priors"], rtol=STAT_TOL)
    assert sp["num_names"] == sr["num_names"]
    assert sp["cat_names"] == sr["cat_names"]
    for a, b in zip(sp["cat_tables"], sr["cat_tables"]):
        np.testing.assert_allclose(a, b, rtol=STAT_TOL)
    for moments in zip(sp["num_mu"], sp["num_sd"], sr["num_mu"],
                       sr["num_sd"]):
        assert_moments(*moments)
    assert sp["cat_domains"] == sr["cat_domains"]


def assert_predictions(m_p, m_r, fr_p, fr_r, K):
    p_p = m_p.predict(fr_p)
    with _one_device():
        p_r = m_r.predict(fr_r).to_pandas()
    for k in range(K):
        np.testing.assert_allclose(p_p.col(f"p{k}").to_numpy(),
                                   p_r[f"p{k}"].to_numpy(), atol=PROB_TOL)
    dom = m_r.output["domain"]
    want = np.array([dom.index(v) for v in p_r["predict"]])
    got = p_p.col("predict").to_numpy()
    # a label may differ only where the two probabilities straddle the
    # threshold (binomial) or tie (multinomial) within PROB_TOL
    probs = np.stack([p_p.col(f"p{k}").to_numpy() for k in range(K)], 1)
    if K == 2:
        near = np.abs(probs[:, 1] - m_p.output["default_threshold"]) \
            <= PROB_TOL
    else:
        s = np.sort(probs, 1)
        near = s[:, -1] - s[:, -2] <= 2 * PROB_TOL
    np.testing.assert_array_equal(got[~near], want[~near])


def assert_metrics(mp, mr, keys):
    for key in keys:
        assert mp[key] == pytest.approx(mr[key], rel=METRIC_TOL, abs=1e-12), \
            key


@pytest.mark.parametrize("K,laplace", [(2, 0.0), (2, 1.0), (4, 0.5)])
def test_fit_matches_the_reference(K, laplace):
    cols = nb_cols(seed=K + int(laplace * 10), K=K)
    fr_r, fr_p = frames(cols)
    kw = dict(laplace=laplace, min_sdev=0.01, min_prob=0.005)
    with _one_device():
        m_r = ref_nb.NaiveBayesEstimator(**kw).train(fr_r, y="y")
    m_p = h2o3_tpu_torch.NaiveBayesEstimator(**kw).train(fr_p, y="y")
    assert_stats(m_p.stats, m_r.stats)
    assert m_p.output["domain"] == m_r.output["domain"]
    assert_predictions(m_p, m_r, fr_p, fr_r, K)
    keys = ["logloss", "MSE", "AUC", "mean_per_class_error"]
    if K == 2:
        keys += ["max_f1_threshold", "pr_auc"]
        assert m_p.output["default_threshold"] == \
            m_r.output["default_threshold"]
    assert_metrics(m_p.training_metrics, m_r.training_metrics, keys)


def test_cv_matches_the_reference():
    cols = nb_cols(seed=20)
    fr_r, fr_p = frames(cols)
    kw = dict(laplace=1.0, nfolds=3, seed=4)
    with _one_device():
        m_r = ref_nb.NaiveBayesEstimator(**kw).train(fr_r, y="y")
    m_p = h2o3_tpu_torch.NaiveBayesEstimator(**kw).train(fr_p, y="y")
    np.testing.assert_array_equal(
        m_p._cv_folds, fold_assignment(fr_p.nrows, 3, "random", 4))
    for a, b in zip(m_p._cv_models, m_r._cv_models):
        assert_stats(a.stats, b.stats)
    assert_stats(m_p.stats, m_r.stats)
    assert_metrics(m_p.cross_validation_metrics, m_r.cross_validation_metrics,
                   ["logloss", "AUC", "MSE"])


def test_regression_response_raises():
    cols = nb_cols(n=100)
    cols["y"] = np.arange(100.0)
    fr_p = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=["c0", "c1"],
                                           device="cpu")
    with pytest.raises(ValueError, match="categorical response"):
        h2o3_tpu_torch.NaiveBayesEstimator().train(fr_p, y="y")


@pytest.mark.parametrize("K", [2, 3])
def test_reference_model_carried_across_scores_alike(K):
    cols = nb_cols(seed=30 + K, K=K)
    fr_r, _ = frames(cols)
    with _one_device():
        m_r = ref_nb.NaiveBayesEstimator(laplace=1.0).train(fr_r, y="y")
    m_p = naivebayes_model_from_arrays(dict(stats=m_r.stats,
                                            output=m_r.output,
                                            params=m_r.params))
    te = nb_cols(n=1200, seed=40 + K, K=K)
    te["c0"][:30] = "zzz"                          # an unseen level
    te_r, te_p = frames(te)
    assert_predictions(m_p, m_r, te_p, te_r, K)
    with _one_device():
        mr = m_r.model_performance(te_r)
    assert_metrics(m_p.model_performance(te_p), mr, ["logloss", "MSE"])
