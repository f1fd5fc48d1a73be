"""Whole-fit GBM parity of the PyTorch port (on the CPU) against the
reference package, plus weights carried across and metric parity.

Both packages get the same numpy columns. Sampling is off
(``sample_rate=1``, ``col_sample_rate_per_tree=1``): the two packages
draw from different generators. Gradients are real-valued here, so
histograms are summed in another order: forests' integer fields must be
EXACTLY equal (the data has no near-tie splits), leaf values within
rtol 1e-5, training metrics within 1e-5."""

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import metrics as ref_mm
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu.models.tree import Tree as RefTree
from h2o3_tpu_torch.models import metrics as mm
from h2o3_tpu_torch.models.convert import gbm_model_from_arrays
from h2o3_tpu_torch.models.tree import Tree

from torch_ranks import mixed_cols as _mixed_cols
from torch_ranks import regression_cols as _regression_cols
from torch_threads import one_torch_thread  # noqa: F401 - autouse

INT_FIELDS = ("feat", "thresh", "na_left", "is_split", "cat_split",
              "left_words")


def _train_both(cols, categorical, **params):
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=categorical)
    fr_p = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=categorical,
                                           device="cpu")
    m_r = RefGBM(**params).train(fr_r, y="y")
    m_p = h2o3_tpu_torch.GBMEstimator(**params).train(fr_p, y="y")
    return m_r, m_p, fr_r, fr_p


def _ref_arrays(m_r) -> dict:
    """The reference model's numpy images, as gbm_model_from_arrays
    takes them."""
    d = {f: np.asarray(getattr(m_r.forest, f)) for f in RefTree._fields}
    bm = m_r.bm
    d.update(edges=np.asarray(bm.edges), nbins=np.asarray(bm.nbins),
             is_cat=np.asarray(bm.is_cat), names=list(bm.names),
             domains=list(bm.domains), nbins_total=bm.nbins_total,
             nbins_cats=bm.nbins_cats, f0=np.asarray(m_r.f0),
             dist_name=m_r.dist_name, category=m_r.output["category"],
             domain=m_r.output["domain"], response=m_r.output["response"],
             default_threshold=m_r.output.get("default_threshold", 0.5),
             params=m_r.params)
    return d


def _assert_forests(m_r, m_p):
    for f in INT_FIELDS:
        a = np.asarray(getattr(m_r.forest, f))
        b = getattr(m_p.forest, f).numpy()
        if f == "left_words":
            b = b.view(np.uint32)
        np.testing.assert_array_equal(b, a, err_msg=f"forest field '{f}'")
    for f in ("leaf", "leaf_w"):
        np.testing.assert_allclose(getattr(m_p.forest, f).numpy(),
                                   np.asarray(getattr(m_r.forest, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)


PARAMS = dict(ntrees=4, max_depth=4, seed=11, sample_rate=1.0,
              col_sample_rate_per_tree=1.0)


def test_gbm_binomial_forest_parity():
    # seed 6: no near-tie splits. Elsewhere a right child's empty bins
    # carry the sibling subtraction's float residue (parent - left is
    # not exactly 0), so equal-gain thresholds of a plateau differ in the
    # last bits, and each summation order picks its own.
    cols, cats = _mixed_cols(seed=6)
    m_r, m_p, _, _ = _train_both(cols, cats, **PARAMS)
    _assert_forests(m_r, m_p)
    assert m_p.forest.cat_split.any(), "no categorical subset split made"
    assert m_p.forest.na_left.any() or m_p.forest.is_split.any()
    for k in ("AUC", "logloss", "MSE"):
        assert m_p.training_metrics[k] == pytest.approx(
            m_r.training_metrics[k], abs=1e-5), k
    assert m_p.output["default_threshold"] == \
        m_r.output["default_threshold"]


def test_gbm_regression_forest_parity():
    cols, cats = _regression_cols()
    m_r, m_p, _, _ = _train_both(cols, cats, distribution="gaussian",
                                 min_rows=5.0, **PARAMS)
    _assert_forests(m_r, m_p)
    for k in ("MSE", "mae", "mean_residual_deviance", "r2"):
        assert m_p.training_metrics[k] == pytest.approx(
            m_r.training_metrics[k], rel=1e-5, abs=1e-5), k


def test_weights_carried_across_predict_equal():
    """A reference-trained GBM's arrays build a port model whose
    predictions equal the reference's on a fresh frame."""
    cols, cats = _mixed_cols(n=500, seed=3)
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    m_r = RefGBM(ntrees=5, max_depth=5, seed=2).train(fr_r, y="y")
    model = gbm_model_from_arrays(_ref_arrays(m_r), device="cpu")
    test_cols, _ = _mixed_cols(n=300, seed=8)
    te_r = h2o3_tpu.Frame.from_numpy(test_cols, categorical=cats)
    te_p = h2o3_tpu_torch.Frame.from_numpy(test_cols, categorical=cats,
                                           device="cpu")
    p_r = m_r.predict(te_r)
    p_p = model.predict(te_p)
    np.testing.assert_allclose(p_p.col("p1").to_numpy(),
                               p_r.col("p1").to_numpy(), atol=1e-6)
    np.testing.assert_array_equal(p_p.col("predict").to_numpy(),
                                  p_r.col("predict").to_numpy())
    assert p_p.col("predict").domain == p_r.col("predict").domain
    mp = model.model_performance(te_p)
    mr = m_r.model_performance(te_r)
    assert mp["AUC"] == pytest.approx(mr["AUC"], abs=1e-6)
    assert mp["logloss"] == pytest.approx(mr["logloss"], abs=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_binomial_metrics_parity(weighted):
    r = np.random.RandomState(5)
    n = 3000
    p = r.rand(n).astype(np.float32)
    y = (r.rand(n) < p).astype(np.float32)
    w = (r.randint(0, 3, n).astype(np.float32) if weighted
         else np.ones(n, np.float32))
    ref = ref_mm.binomial_metrics(p, y, w)
    port = mm.binomial_metrics(torch.from_numpy(p), torch.from_numpy(y),
                               torch.from_numpy(w))
    for k in ("AUC", "pr_auc", "logloss", "MSE", "max_f1",
              "max_f1_threshold", "mean_per_class_error"):
        assert port[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-6), k
    assert port["confusion_matrix"] == ref["confusion_matrix"]
    assert port.nobs == ref.nobs


@pytest.mark.parametrize("weighted", [False, True])
def test_regression_metrics_parity(weighted):
    r = np.random.RandomState(6)
    n = 3000
    y = r.randn(n).astype(np.float32) * 2 + 1
    pred = (y + 0.3 * r.randn(n)).astype(np.float32)
    w = (r.randint(0, 3, n).astype(np.float32) if weighted
         else np.ones(n, np.float32))
    ref = ref_mm.regression_metrics(pred, y, w)
    port = mm.regression_metrics(torch.from_numpy(pred), torch.from_numpy(y),
                                 torch.from_numpy(w))
    for k in ("MSE", "RMSE", "mae", "rmsle", "mean_residual_deviance", "r2"):
        assert port[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-6), k


def test_unported_parameter_raises():
    # nfolds is ported: a 3-fold CV fit trains, and the frame keys of its
    # predictions are in the DKV
    cols, cats = _mixed_cols(n=300, seed=2)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    m = h2o3_tpu_torch.GBMEstimator(
        nfolds=3, ntrees=2, max_depth=3, seed=1,
        keep_cross_validation_predictions=True).train(fr, y="y")
    assert len(m._cv_models) == 3
    assert 0.5 < m.cross_validation_metrics["AUC"] <= 1.0
    hold = h2o3_tpu_torch.DKV.get(m.output["cv_holdout_frame_key"])
    np.testing.assert_array_equal(hold.col("p1").to_numpy(),
                                  m._cv_holdout.astype(np.float64))
    with pytest.raises(NotImplementedError, match="stopping_metric"):
        h2o3_tpu_torch.GBMEstimator(stopping_metric="AUC")
    with pytest.raises(ValueError, match="unknown GBM params"):
        h2o3_tpu_torch.GBMEstimator(not_a_param=1)
    h2o3_tpu_torch.GBMEstimator(nfolds=0, stopping_rounds=0)  # defaults ok


def test_cuda_default_device_raises_without_card(monkeypatch):
    """Entry points default to CUDA and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        h2o3_tpu_torch.Frame.from_numpy({"a": np.arange(4.0)})


def test_sampled_fit_is_seeded_by_tree_index():
    """Row/column sampling draws from a generator seeded by (seed, tree
    index): the same seed gives the same forest, a different one not."""
    cols, cats = _mixed_cols(n=400, seed=2)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    kw = dict(ntrees=3, max_depth=3, sample_rate=0.6,
              col_sample_rate_per_tree=0.5)
    a = h2o3_tpu_torch.GBMEstimator(seed=4, **kw).train(fr, y="y")
    b = h2o3_tpu_torch.GBMEstimator(seed=4, **kw).train(fr, y="y")
    c = h2o3_tpu_torch.GBMEstimator(seed=5, **kw).train(fr, y="y")
    for f in Tree._fields:
        assert torch.equal(getattr(a.forest, f), getattr(b.forest, f)), f
    assert not all(torch.equal(getattr(a.forest, f), getattr(c.forest, f))
                   for f in Tree._fields)


def test_concat_forests_matches_reference():
    """Forest chunks concatenate along the tree axis as the reference's
    concat_forests does."""
    from h2o3_tpu.models.tree import concat_forests as ref_concat
    from h2o3_tpu_torch.models.tree import concat_forests
    cols, cats = _mixed_cols(n=300, seed=1)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    m = h2o3_tpu_torch.GBMEstimator(ntrees=3, max_depth=3, seed=1).train(
        fr, y="y")
    halves = [Tree(*(a[:1] for a in m.forest)),
              Tree(*(a[1:] for a in m.forest))]
    out = concat_forests(halves)
    ref = ref_concat([RefTree(*(np.asarray(a) for a in h)) for h in halves])
    for f in Tree._fields:
        assert torch.equal(getattr(out, f), getattr(m.forest, f)), f
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert concat_forests([m.forest]) is m.forest


def family_cols(dist, n=600, seed=1):
    """``regression_cols``' features with a response of the family's
    domain made from its signal s: counts for poisson, positive values for
    gamma, zero-inflated positive values for tweedie, s plus heavy-tailed
    noise otherwise."""
    cols, cats = _regression_cols(n=n, seed=seed)
    s = cols["y"]
    r = np.random.RandomState(seed + 100)
    if dist == "poisson":
        y = r.poisson(np.exp(0.4 * s)).astype(float)
    elif dist == "gamma":
        y = r.gamma(2.0, np.exp(0.3 * s) / 2.0)
    elif dist == "tweedie":
        y = (r.rand(n) < 1 / (1 + np.exp(-s))) \
            * r.gamma(2.0, np.exp(0.3 * s) / 2.0)
    else:
        y = s + r.standard_t(3, n) * 0.3
    cols["y"] = y
    return cols, cats


# (family, shape parameters off their defaults, tie-free data seed): each
# family's forests compare EXACTLY on its seed; on other seeds a plateau of
# equal-gain thresholds may break the other way in either summation order
FAMILIES = [("poisson", {}, 1), ("gamma", {}, 2),
            ("tweedie", {"tweedie_power": 1.3}, 2), ("laplace", {}, 1),
            ("quantile", {"quantile_alpha": 0.8}, 3),
            ("huber", {"huber_alpha": 0.5}, 1)]


@pytest.mark.parametrize("family,shape,seed", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_gbm_family_fit_parity(family, shape, seed):
    """Whole GBM regression fits of the six new families: forests' integer
    fields EXACT, leaves within rtol 1e-5, f0 bit-equal, predictions and
    the mean residual deviance within 1e-5."""
    cols, cats = family_cols(family, seed=seed)
    m_r, m_p, fr_r, fr_p = _train_both(cols, cats, distribution=family,
                                       min_rows=5.0, **shape, **PARAMS)
    _assert_forests(m_r, m_p)
    assert m_p.f0 == m_r.f0 and m_p.dist_name == family
    assert m_p.output["init_f"] == m_r.output["init_f"]
    pr = m_r.predict(fr_r).col("predict").to_numpy()
    pp = m_p.predict(fr_p).col("predict").to_numpy()
    np.testing.assert_allclose(pp, pr, rtol=1e-5, atol=1e-6)
    for k in ("mean_residual_deviance", "MSE", "mae"):
        assert m_p.training_metrics[k] == pytest.approx(
            m_r.training_metrics[k], rel=1e-5, abs=1e-6), k
    mr, mp = m_r.model_performance(fr_r), m_p.model_performance(fr_p)
    assert mp["mean_residual_deviance"] == pytest.approx(
        mr["mean_residual_deviance"], rel=1e-5)


def _with_weights(cols, seed=0):
    cols = dict(cols)
    cols["wt"] = np.random.RandomState(seed).randint(1, 4, len(cols["y"])
                                                     ).astype(float)
    return cols


@pytest.mark.parametrize("param,value", [
    ("weights_column", "wt"), ("min_split_improvement", 0.05),
    ("learn_rate", 0.5), ("nbins_cats", 2)])
def test_ported_parameter_off_default(param, value):
    """Each ported parameter no other test sets, off its default. These
    move near-tie splits (a threshold of a plateau), so the fits are held
    by predictions and metrics within 1e-6, not by their forests."""
    cols, cats = _mixed_cols(seed=6)
    if param == "weights_column":
        cols = _with_weights(cols)
    m_r, m_p, fr_r, fr_p = _train_both(cols, cats, **{param: value},
                                       **PARAMS)
    np.testing.assert_allclose(m_p.predict(fr_p).col("p1").to_numpy(),
                               m_r.predict(fr_r).col("p1").to_numpy(),
                               atol=1e-6)
    for k in ("AUC", "logloss", "MSE"):
        assert m_p.training_metrics[k] == pytest.approx(
            m_r.training_metrics[k], abs=1e-6), k
        assert m_p.model_performance(fr_p)[k] == pytest.approx(
            m_r.model_performance(fr_r)[k], abs=1e-6), k
    if param == "weights_column":
        assert m_p.training_metrics.nobs == m_r.training_metrics.nobs


def _stopping_case(case):
    """(training columns, validation columns, categorical, parameters):
    learn_rate 0.3 and a tolerance at which every case stops early, with
    and without a validation frame."""
    from torch_ranks import multi_cols
    kw = dict(ntrees=20, max_depth=3, seed=11, learn_rate=0.3,
              stopping_rounds=2, score_tree_interval=2,
              stopping_tolerance=0.2)
    if case == "binomial":
        (cols, cats), (vcols, _) = _mixed_cols(seed=2), _mixed_cols(seed=9)
    elif case == "gaussian":
        (cols, cats), (vcols, _) = (_regression_cols(seed=2),
                                    _regression_cols(seed=9))
        kw.update(distribution="gaussian", min_rows=5.0,
                  stopping_tolerance=0.4)
    else:
        (cols, cats), (vcols, _) = multi_cols(seed=2), multi_cols(seed=9)
    return cols, vcols, cats, kw


@pytest.mark.parametrize("validate", [False, True],
                         ids=["training", "validation"])
@pytest.mark.parametrize("case", ["binomial", "gaussian", "multinomial"])
def test_early_stopping_matches_reference(case, validate):
    """stopping_rounds=2, score_tree_interval=2: the same trees kept, the
    same scoring history (deviances within 1e-5) and, with a validation
    frame, its metrics within 1e-5."""
    cols, vcols, cats, kw = _stopping_case(case)
    m_r, m_p, fr_r, fr_p = _train_both(cols, cats, **kw)
    if validate:
        v_r = h2o3_tpu.Frame.from_numpy(vcols, categorical=cats)
        v_p = h2o3_tpu_torch.Frame.from_numpy(vcols, categorical=cats,
                                              device="cpu")
        m_r = RefGBM(**kw).train(fr_r, y="y", validation_frame=v_r)
        m_p = h2o3_tpu_torch.GBMEstimator(**kw).train(
            fr_p, y="y", validation_frame=v_p)
    K = m_p.output["nclasses"] if case == "multinomial" else 1
    n_trees = m_p.forest.feat.shape[0]
    assert n_trees == m_r.forest.feat.shape[0]
    assert n_trees < kw["ntrees"] * K, "no early stop"
    h_r, h_p = m_r.output["scoring_history"], m_p.output["scoring_history"]
    assert [e["ntrees"] for e in h_p] == [e["ntrees"] for e in h_r]
    assert h_p[-1]["ntrees"] * K == n_trees
    for a, b in zip(h_p, h_r):
        assert a["deviance"] == pytest.approx(b["deviance"], rel=1e-5)
    if validate:
        keys = {"binomial": ("AUC", "logloss", "MSE"),
                "gaussian": ("MSE", "mean_residual_deviance", "r2"),
                "multinomial": ("logloss", "MSE", "AUC")}[case]
        for k in keys:
            assert m_p.validation_metrics[k] == pytest.approx(
                m_r.validation_metrics[k], rel=1e-5, abs=1e-5), k
    else:
        assert m_p.validation_metrics is None
