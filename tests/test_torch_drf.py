"""DRF parity of the PyTorch port (on the CPU) against the reference
package: whole binomial and regression fits, a reference forest carried
across, the per-node column masks, OOB metrics and the estimator surface.

Both packages get the same numpy columns. Bagging is off
(``sample_rate=1``) and every node scores every column (``mtries=F``):
the two packages draw from different generators. The binomial response
makes 0/1 stats, so its forests are EXACTLY equal; the regression data
is tie-free (seed 2; elsewhere a plateau of equal-gain thresholds flips
with the summation order). The forests' integer fields must be equal,
``model_performance`` within 1e-5."""

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models.drf import DRFEstimator as RefDRF
from h2o3_tpu.models.tree import Tree as RefTree
from h2o3_tpu_torch.models import tree as tree_mod
from h2o3_tpu_torch.models.convert import drf_model_from_arrays
from h2o3_tpu_torch.models.tree import Tree

from tests.test_torch_gbm import (_assert_forests, _mixed_cols,
                                  _regression_cols)


def _train_both(cols, cats, **params):
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    fr_p = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                           device="cpu")
    m_r = RefDRF(**params).train(fr_r, y="y")
    m_p = h2o3_tpu_torch.DRFEstimator(**params).train(fr_p, y="y")
    return m_r, m_p, fr_r, fr_p


def test_drf_binomial_forest_parity():
    cols, cats = _mixed_cols(seed=6)
    m_r, m_p, fr_r, fr_p = _train_both(cols, cats, ntrees=4, max_depth=6,
                                       seed=11, sample_rate=1.0, mtries=5)
    assert m_p.forest.feat.shape == (4, 6, 32)
    _assert_forests(m_r, m_p)
    assert m_p.forest.cat_split.any(), "no categorical subset split made"
    mr, mp = m_r.model_performance(fr_r), m_p.model_performance(fr_p)
    for k in ("AUC", "logloss", "MSE", "pr_auc", "mean_per_class_error"):
        assert mp[k] == pytest.approx(mr[k], abs=1e-5), k
    pr, pp = m_r.predict(fr_r), m_p.predict(fr_p)
    np.testing.assert_allclose(pp.col("p1").to_numpy(),
                               pr.col("p1").to_numpy(), atol=1e-6)


def test_drf_regression_forest_parity():
    cols, cats = _regression_cols(seed=2)
    m_r, m_p, fr_r, fr_p = _train_both(cols, cats, ntrees=4, max_depth=6,
                                       seed=11, sample_rate=1.0, mtries=4,
                                       min_rows=5.0)
    _assert_forests(m_r, m_p)
    mr, mp = m_r.model_performance(fr_r), m_p.model_performance(fr_p)
    for k in ("MSE", "mae", "mean_residual_deviance", "r2"):
        assert mp[k] == pytest.approx(mr[k], rel=1e-5, abs=1e-5), k
    np.testing.assert_allclose(
        m_p.predict(fr_p).col("predict").to_numpy(),
        m_r.predict(fr_r).col("predict").to_numpy(), rtol=1e-5, atol=1e-5)


def _ref_arrays(m_r) -> dict:
    d = {f: np.asarray(getattr(m_r.forest, f)) for f in RefTree._fields}
    bm = m_r.bm
    d.update(edges=np.asarray(bm.edges), nbins=np.asarray(bm.nbins),
             is_cat=np.asarray(bm.is_cat), names=list(bm.names),
             domains=list(bm.domains), nbins_total=bm.nbins_total,
             nbins_cats=bm.nbins_cats, category=m_r.output["category"],
             domain=m_r.output["domain"], response=m_r.output["response"],
             default_threshold=m_r.output.get("default_threshold", 0.5))
    return d


@pytest.mark.parametrize("kind", ["binomial", "regression"])
def test_drf_model_carried_across_scores_identically(kind):
    """A reference-trained (bagged, mtries-sampled) DRF scores a fresh
    frame in the port exactly as in the reference."""
    make = _mixed_cols if kind == "binomial" else _regression_cols
    cols, cats = make(n=500, seed=3)
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    m_r = RefDRF(ntrees=5, max_depth=5, seed=2).train(fr_r, y="y")
    model = drf_model_from_arrays(_ref_arrays(m_r), device="cpu")
    test_cols, _ = make(n=300, seed=8)
    te_r = h2o3_tpu.Frame.from_numpy(test_cols, categorical=cats)
    te_p = h2o3_tpu_torch.Frame.from_numpy(test_cols, categorical=cats,
                                           device="cpu")
    p_r, p_p = m_r.predict(te_r), model.predict(te_p)
    assert p_p.names == p_r.names
    for c in p_r.names:
        np.testing.assert_array_equal(p_p.col(c).to_numpy(),
                                      p_r.col(c).to_numpy(), err_msg=c)
    mr, mp = m_r.model_performance(te_r), model.model_performance(te_p)
    for k in ("MSE",) + (("AUC", "logloss") if kind == "binomial"
                          else ("mae", "r2")):
        assert mp[k] == pytest.approx(mr[k], rel=1e-6, abs=1e-6), k


def test_drf_levels_get_per_node_column_masks(monkeypatch):
    """Default mtries (sqrt(F) for classification) draws every level an
    [L, F] mask with exactly mtries columns per node."""
    cols, cats = _mixed_cols(n=600, seed=2)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    masks = []
    draw = tree_mod._mtries_mask

    def spy(*args):
        masks.append(draw(*args))
        return masks[-1]

    monkeypatch.setattr(tree_mod, "_mtries_mask", spy)
    m = h2o3_tpu_torch.DRFEstimator(ntrees=2, max_depth=4,
                                    seed=1).train(fr, y="y")
    assert len(masks) == 2 * 6                  # depth 4 → bucket 6 levels
    for d, cm in enumerate(masks[:6]):
        assert cm.shape == (2 ** d, 5)          # F = 5 → mtries = 2
        assert (cm.sum(dim=1) == 2).all()
    assert m.training_metrics["AUC"] > 0.7


def test_drf_oob_metrics_and_varimp():
    cols, cats = _mixed_cols(n=1500, seed=4)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    m = h2o3_tpu_torch.DRFEstimator(ntrees=12, max_depth=8,
                                    seed=3).train(fr, y="y")
    tm = m.training_metrics                      # out-of-bag
    assert 0.8 < tm["AUC"] < 1.0
    assert 0 < tm.nobs <= 1500
    inbag = m.model_performance(fr)
    assert inbag["AUC"] > tm["AUC"] - 0.05
    assert inbag.nobs == 1500
    top = [name for name, *_ in m.varimp_table[:2]]
    assert set(top) <= {"x1", "c", "x0"}, m.varimp_table
    pred = m.predict(fr)
    assert pred.names == ["predict", "p0", "p1"]
    p1 = pred.col("p1").to_numpy()
    np.testing.assert_allclose(pred.col("p0").to_numpy() + p1, 1.0,
                               atol=1e-6)


def test_sampled_drf_fit_is_seeded_by_tree_index():
    cols, cats = _regression_cols(n=400, seed=5)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    kw = dict(ntrees=3, max_depth=4, col_sample_rate_per_tree=0.7)
    a = h2o3_tpu_torch.DRFEstimator(seed=4, **kw).train(fr, y="y")
    b = h2o3_tpu_torch.DRFEstimator(seed=4, **kw).train(fr, y="y")
    c = h2o3_tpu_torch.DRFEstimator(seed=5, **kw).train(fr, y="y")
    for f in Tree._fields:
        assert torch.equal(getattr(a.forest, f), getattr(b.forest, f)), f
    assert not all(torch.equal(getattr(a.forest, f), getattr(c.forest, f))
                   for f in Tree._fields)
    assert a.training_metrics["MSE"] == b.training_metrics["MSE"]


def test_drf_depth_caps():
    """max_depth is capped by MAX_COMPLETE_DEPTH and by the data size
    (ceil(log2(padded rows)) + 3), and trees are laid out at the depth
    bucket."""
    cols, cats = _regression_cols(n=100, seed=1)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    m = h2o3_tpu_torch.DRFEstimator(ntrees=1, seed=1).train(fr, y="y")
    assert m.forest.feat.shape[1] == 10          # 104 rows: cap 7+3
    m = h2o3_tpu_torch.DRFEstimator(ntrees=1, max_depth=3,
                                    seed=1).train(fr, y="y")
    assert m.forest.feat.shape[1] == 6           # bucket of depth 3
    assert not m.forest.is_split[0, 3:].any()    # levels past 3 never split


def _drf_parameter_trains(param):
    """What each parameter the port took on in slices 7 and 9 does on a
    small fit (the case names of ``test_drf_unported_parameters_raise``)."""
    cols, cats = _mixed_cols(n=400, seed=4)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    kw = dict(ntrees=3, max_depth=4, seed=7)
    plain = h2o3_tpu_torch.DRFEstimator(**kw).train(fr, y="y")
    if param == "nfolds":
        m = h2o3_tpu_torch.DRFEstimator(nfolds=3, **kw).train(fr, y="y")
        assert len(m._cv_models) == 3 and m._cv_folds.max() == 2
        assert 0.5 < m.cross_validation_metrics["AUC"] <= 1.0
    elif param == "checkpoint":
        m = h2o3_tpu_torch.DRFEstimator(
            **dict(kw, ntrees=5, checkpoint=plain)).train(fr, y="y")
        assert m.forest.feat.shape[0] == 5
        # the donor's DKV key restarts the same fit; a key with no model
        # under it does not
        by_key = h2o3_tpu_torch.DRFEstimator(
            **dict(kw, ntrees=5, checkpoint=plain.key)).train(fr, y="y")
        for f in Tree._fields:
            assert torch.equal(getattr(m.forest, f),
                               getattr(by_key.forest, f)), f
        with pytest.raises(ValueError, match="not found"):
            h2o3_tpu_torch.DRFEstimator(
                **dict(kw, ntrees=5, checkpoint="m")).train(fr, y="y")
    elif param == "max_runtime_secs":
        # a cap that does not bind leaves the bagged forest as it is
        m = h2o3_tpu_torch.DRFEstimator(max_runtime_secs=5.0, **kw).train(
            fr, y="y")
        for f in Tree._fields:
            assert torch.equal(getattr(m.forest, f),
                               getattr(plain.forest, f)), f
    elif param == "calibrate_model":
        m = h2o3_tpu_torch.DRFEstimator(calibrate_model=True,
                                        calibration_frame=fr, **kw).train(
            fr, y="y")
        assert m.predict(fr).names[-2:] == ["cal_p0", "cal_p1"]
    elif param == "histogram_type":
        m = h2o3_tpu_torch.DRFEstimator(histogram_type="random",
                                        **kw).train(fr, y="y")
        assert not torch.equal(m.bm.edges, plain.bm.edges)
        assert m.training_metrics["AUC"] > 0.6
    else:
        # accepted and inert, as in the reference
        value = {"binomial_double_trees": True, "stopping_rounds": 2}[param]
        m = h2o3_tpu_torch.DRFEstimator(**{param: value}, **kw).train(
            fr, y="y")
        for f in Tree._fields:
            assert torch.equal(getattr(m.forest, f),
                               getattr(plain.forest, f)), f


@pytest.mark.parametrize("param,value", [
    ("nfolds", 3), ("checkpoint", "m"), ("max_runtime_secs", 5.0),
    ("calibrate_model", True), ("histogram_type", "random"),
    ("binomial_double_trees", True), ("stopping_rounds", 2)])
def test_drf_unported_parameters_raise(param, value):
    """Every case is ported now, so each holds that DRF accepts the
    parameter and trains with it: nfolds, checkpoint, max_runtime_secs
    and calibrate_model since slice 7, histogram_type since slice 9 (its
    edges change), and binomial_double_trees and stopping_rounds, which
    the reference reads nowhere, accepted and inert (the forest is the
    default fit's). The CV frame keys came with the DKV, so no DRF
    parameter is left off the ported list."""
    _drf_parameter_trains(param)
    h2o3_tpu_torch.DRFEstimator(**{param: value})
    est = h2o3_tpu_torch.DRFEstimator(keep_cross_validation_predictions=True)
    assert est.params["keep_cross_validation_predictions"] is True
    assert set(h2o3_tpu_torch.DRFEstimator.DEFAULTS) == \
        h2o3_tpu_torch.DRFEstimator.PORTED


def test_drf_surface_errors():
    with pytest.raises(ValueError, match="unknown DRF params"):
        h2o3_tpu_torch.DRFEstimator(not_a_param=1)
    h2o3_tpu_torch.DRFEstimator(nfolds=0, checkpoint=None)  # defaults ok
    r = np.random.RandomState(0)
    fr = h2o3_tpu_torch.Frame.from_numpy(
        {"x": r.randn(60), "y": np.array(["a", "b", "c"], object)[
            r.randint(0, 3, 60)]}, device="cpu")
    # multinomial DRF trains on one device; on a partitioned frame (a
    # sharded mesh) it raises, as binomial and regression DRF do
    m = h2o3_tpu_torch.DRFEstimator(ntrees=1).train(fr, y="y")
    assert m.predict(fr).names == ["predict", "p0", "p1", "p2"]
    from h2o3_tpu_torch.parallel import mesh as mesh_mod
    fr.mesh = mesh_mod.Mesh(None, None, 0, 2)       # as if sharded
    with pytest.raises(NotImplementedError, match="sharded mesh"):
        h2o3_tpu_torch.DRFEstimator(ntrees=1).train(fr, y="y")
