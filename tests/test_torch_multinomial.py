"""Multinomial GBM and DRF of the PyTorch port (on the CPU) against the
reference package, and ``multinomial_metrics`` alone.

Both packages get the same numpy columns (``torch_ranks.multi_cols``:
integer-valued features, NAs, a categorical, K = 3 and 4 classes).
Sampling is off: the two packages draw from different generators. GBM's
softmax gradients are real-valued, so histograms are summed in another
order: the forests' integer fields must be EXACTLY equal (the seeds are
tie-free), leaf values within rtol 1e-5, f0 equal, class probabilities
and metrics within 1e-5. DRF's class indicators are 0/1 statistics: its
forests are EXACTLY equal, leaves too. Each reference fit is shared
through a module-scoped fixture (every JAX fit compiles)."""

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import metrics as ref_mm
from h2o3_tpu.models.drf import DRFEstimator as RefDRF
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu.models.tree import Tree as RefTree
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.convert import (drf_model_from_arrays,
                                           gbm_model_from_arrays)
from h2o3_tpu_torch.models.tree import Tree

from test_torch_drf import _ref_arrays as _drf_ref_arrays
from test_torch_gbm import _assert_forests, _ref_arrays
from torch_ranks import multi_cols

GBM = dict(ntrees=3, max_depth=4, seed=11, sample_rate=1.0,
           col_sample_rate_per_tree=1.0)
DRF = dict(ntrees=3, max_depth=4, seed=11, sample_rate=1.0, mtries=4)
SEEDS = {3: 2, 4: 3}        # tie-free data for K = 3 and K = 4
METRICS = ("logloss", "MSE", "mean_per_class_error", "error_rate", "AUC",
           "pr_auc")


def _frames(cols, cats, domains=None):
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=cats,
                                      domains=domains),
            h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                            domains=domains, device="cpu"))


@pytest.fixture(scope="module")
def fits():
    out = {}
    for K, seed in SEEDS.items():
        fr_r, fr_p = _frames(*multi_cols(K=K, seed=seed))
        for algo, ref, port, kw in (
                ("gbm", RefGBM, h2o3_tpu_torch.GBMEstimator, GBM),
                ("drf", RefDRF, h2o3_tpu_torch.DRFEstimator, DRF)):
            out[algo, K] = (ref(**kw).train(fr_r, y="y"),
                            port(**kw).train(fr_p, y="y"), fr_r, fr_p)
    return out


def _assert_metrics(mp, mr, tol=1e-5):
    for k in METRICS:
        assert mp[k] == pytest.approx(mr[k], abs=tol), k
    assert mp.nobs == mr.nobs
    np.testing.assert_allclose(mp["confusion_matrix"],
                               mr["confusion_matrix"], atol=tol)
    for table in ("multinomial_auc_rows", "multinomial_aucpr_rows"):
        for a, b in zip(mp[table], mr[table]):
            assert a[:3] == b[:3]
            assert a[3] == pytest.approx(b[3], abs=tol), (table, a)
        assert len(mp[table]) == len(mr[table])


def _assert_predictions(pp, pr, K, tol=1e-5):
    assert pp.names == pr.names == ["predict"] + [f"p{k}" for k in range(K)]
    for k in range(K):
        np.testing.assert_allclose(pp.col(f"p{k}").to_numpy(),
                                   pr.col(f"p{k}").to_numpy(), atol=tol)
    np.testing.assert_array_equal(pp.col("predict").to_numpy(),
                                  pr.col("predict").to_numpy())
    assert pp.col("predict").domain == pr.col("predict").domain


@pytest.mark.parametrize("K", list(SEEDS))
def test_multinomial_gbm_forest_parity(fits, K):
    m_r, m_p, _, _ = fits["gbm", K]
    assert m_p.forest.feat.shape[0] == GBM["ntrees"] * K
    _assert_forests(m_r, m_p)
    assert m_p.forest.cat_split.any(), "no categorical subset split made"
    assert m_p.f0.dtype == np.float32 and m_p.f0.shape == (K,)
    np.testing.assert_array_equal(m_p.f0, np.asarray(m_r.f0))
    assert m_p.output["scoring_history"] == []


@pytest.mark.parametrize("K", list(SEEDS))
def test_multinomial_gbm_predictions_and_metrics(fits, K):
    m_r, m_p, fr_r, fr_p = fits["gbm", K]
    _assert_predictions(m_p.predict(fr_p), m_r.predict(fr_r), K)
    _assert_metrics(m_p.training_metrics, m_r.training_metrics)
    _assert_metrics(m_p.model_performance(fr_p), m_r.model_performance(fr_r))
    assert [v[0] for v in m_p.output["varimp"]] == \
        [v[0] for v in m_r.output["varimp"]]


@pytest.mark.parametrize("K", list(SEEDS))
def test_multinomial_drf_forest_parity(fits, K):
    """0/1 statistics, no bagging, every column at every node: the
    forests are EXACTLY equal."""
    m_r, m_p, fr_r, fr_p = fits["drf", K]
    assert m_p.forest.feat.shape[0] == DRF["ntrees"] * K
    for f in RefTree._fields:
        a = np.asarray(getattr(m_r.forest, f))
        b = getattr(m_p.forest, f).numpy()
        if f == "left_words":
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=f)
    _assert_predictions(m_p.predict(fr_p), m_r.predict(fr_r), K)
    _assert_metrics(m_p.model_performance(fr_p), m_r.model_performance(fr_r))


def test_multinomial_drf_oob_metrics_and_votes():
    """Bagged multinomial DRF: OOB training metrics over the rows some
    tree left out, probabilities = clipped votes over their sum."""
    fr_r, fr_p = _frames(*multi_cols(n=800, K=3, seed=5))
    m = h2o3_tpu_torch.DRFEstimator(ntrees=8, max_depth=6,
                                    seed=3).train(fr_p, y="y")
    tm = m.training_metrics
    assert tm.kind == "Multinomial" and 0 < tm.nobs <= 800
    assert tm["AUC"] > 0.8 and tm["logloss"] < 1.0
    assert np.asarray(tm["confusion_matrix"]).shape == (3, 3)
    pred = m.predict(fr_p)
    p = np.stack([pred.col(f"p{k}").to_numpy() for k in range(3)], 1)
    np.testing.assert_allclose(p.sum(1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(pred.col("predict").to_numpy(),
                                  p.argmax(1))
    votes = m._mean_votes(m.bm).numpy()[:800]
    np.testing.assert_allclose(
        p, np.clip(votes, 0, 1) / np.maximum(votes.sum(1, keepdims=True),
                                             1e-12), rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("K", [2, 3, 4, 5, 31])
def test_multinomial_metrics_parity(K, weighted):
    """K = 31 has no AUC tables (the reference computes them for
    2 <= K <= 30)."""
    r = np.random.RandomState(K)
    n = 3000
    z = r.randn(n, K).astype(np.float32)
    y = r.randint(0, K, n).astype(np.int32)
    z[np.arange(n), y] += 1.0
    p = (np.exp(z) / np.exp(z).sum(1, keepdims=True)).astype(np.float32)
    w = (r.randint(0, 3, n).astype(np.float32) if weighted
         else np.ones(n, np.float32))
    dom = [f"c{k}" for k in range(K)]
    ref = ref_mm.multinomial_metrics(p, y, w, domain=dom)
    port = mm.multinomial_metrics(torch.from_numpy(p), torch.from_numpy(y),
                                  torch.from_numpy(w), domain=dom)
    assert set(port.to_dict()) == set(ref.to_dict())
    for k in ("logloss", "MSE", "mean_per_class_error", "error_rate"):
        assert port[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-6), k
    assert port["confusion_matrix"] == ref["confusion_matrix"]
    assert port.nobs == ref.nobs and port["domain"] == dom
    if K <= 30:
        _assert_metrics(port, ref, tol=1e-6)
    else:
        assert "AUC" not in port.to_dict()


def test_absent_class_prior_is_clipped():
    """A class of the response's domain no training row has: its prior
    clips to 1e-10, f0 = float32 log(1e-10), as the reference's."""
    cols, cats = multi_cols(K=3, seed=2)
    codes = np.unique(cols["y"], return_inverse=True)[1]
    cols["y"] = codes.astype(np.int32)            # levels k0..k2 of four
    doms = {"y": ["k0", "k1", "k2", "kx"]}
    cats = ["c"]
    fr_r, fr_p = _frames(cols, cats + ["y"], doms)
    m_r = RefGBM(**GBM).train(fr_r, y="y")
    m_p = h2o3_tpu_torch.GBMEstimator(**GBM).train(fr_p, y="y")
    assert m_p.f0[3] == np.float32(np.log(1e-10))
    np.testing.assert_array_equal(m_p.f0, np.asarray(m_r.f0))
    _assert_forests(m_r, m_p)
    _assert_predictions(m_p.predict(fr_p), m_r.predict(fr_r), 4)


@pytest.mark.parametrize("algo", ["gbm", "drf"])
def test_reference_multinomial_model_carried_across(fits, algo):
    """A reference-trained multinomial model's arrays build a port model
    that scores a fresh frame as the reference does."""
    m_r = fits[algo, 4][0]
    if algo == "gbm":
        model = gbm_model_from_arrays(_ref_arrays(m_r), device="cpu")
        np.testing.assert_array_equal(model.f0, np.asarray(m_r.f0))
    else:
        model = drf_model_from_arrays(_drf_ref_arrays(m_r), device="cpu")
    assert isinstance(model.forest, Tree)
    test_cols, cats = multi_cols(K=4, seed=8)
    te_r, te_p = _frames(test_cols, cats)
    _assert_predictions(model.predict(te_p), m_r.predict(te_r), 4, tol=1e-6)
    _assert_metrics(model.model_performance(te_p),
                    m_r.model_performance(te_r), tol=1e-6)
