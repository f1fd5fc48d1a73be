"""Uplift DRF parity of the PyTorch port (on the CPU) against the reference
package: the divergence scan, one tree, whole fits, scoring a reference
model carried across, and the estimator surface.

Both packages get the same numpy inputs. Bagging is off
(``sample_rate=1``) and every column is scored (``mtries=-2``): the two
packages draw from different generators. Uplift's histogram stats are
0/1 counts, so every float32 sum is exact in any order: the forests'
integer fields must be EQUAL; leaf, p_t and p_c agree within 1e-6,
gains within 1e-6 relative, AUUC and Qini within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import uplift as ref_up
from h2o3_tpu.models.uplift import UpliftDRFEstimator as RefUplift
from h2o3_tpu_torch.models import uplift as up
from h2o3_tpu_torch.models.convert import uplift_model_from_arrays
from h2o3_tpu_torch.models.tree import Tree, _mtries_mask

INT_FIELDS = ("feat", "thresh", "na_left", "is_split", "cat_split",
              "left_words")
METRICS = ["kl", "euclidean", "chi_squared"]


def _uplift_cols(n=2000, seed=21):
    """tests/test_uplift_extiso.py uplift_data: x0 > 0 defines the
    responders to treatment; x1 is a prognostic factor."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 3)
    treat = r.randint(0, 2, n)
    base = 0.2 + 0.2 * (X[:, 1] > 0)
    lift = 0.35 * ((X[:, 0] > 0) & (treat == 1))
    y = (r.rand(n) < base + lift).astype(int)
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
            "treatment": np.where(treat == 1, "treatment",
                                  "control").astype(object),
            "conversion": np.where(y == 1, "yes", "no").astype(object)}
    return cols, ["treatment", "conversion"]


def _frames(cols, cats):
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=cats),
            h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                            device="cpu"))


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
                                   rtol=0, atol=1e-6, err_msg=f)
    for name in ("leaf_pt", "leaf_pc"):
        np.testing.assert_allclose(getattr(m_p, name).numpy(),
                                   np.asarray(getattr(m_r, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


def _count_hists(r, L, F, B):
    """[L, F, B, 3] {count, positives, count} integer histograms."""
    n = r.randint(0, 30, (L, F, B)).astype(np.float32)
    n[r.rand(L, F, B) < 0.2] = 0.0                       # empty bins
    pos = np.floor(n * r.rand(L, F, B)).astype(np.float32)
    return np.stack([n, pos, n], axis=-1)


@pytest.mark.parametrize("per_node_mask", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_best_uplift_splits_matches_reference(metric, per_node_mask):
    r = np.random.RandomState(4)
    L, F, B = 8, 5, 17
    ht, hc = _count_hists(r, L, F, B), _count_hists(r, L, F, B)
    nb = np.array([16, 12, 16, 3, 9], np.int32)
    cm = (r.rand(L, F) > 0.4) | (np.arange(F) == 0) if per_node_mask \
        else np.ones(F, bool)
    ref = ref_up._best_uplift_splits(jnp.asarray(ht), jnp.asarray(hc),
                                     jnp.asarray(nb), jnp.asarray(cm), 5.0,
                                     metric)
    t = torch.from_numpy
    port = up._best_uplift_splits(t(ht), t(hc), t(nb), t(cm), 5.0, metric)
    g_r, g_p = np.asarray(ref[0]), port[0].numpy()
    fin = np.isfinite(g_r)
    assert fin.any()
    np.testing.assert_array_equal(np.isfinite(g_p), fin)
    np.testing.assert_allclose(g_p[fin], g_r[fin], rtol=1e-6, atol=0)
    for i, name in ((1, "feat"), (2, "thresh"), (3, "na_left")):
        np.testing.assert_array_equal(port[i].numpy(), np.asarray(ref[i]),
                                      err_msg=name)


@pytest.mark.parametrize("metric", METRICS)
def test_grow_uplift_tree_matches_reference(metric):
    r = np.random.RandomState(8)
    N, F, B, depth = 1500, 4, 33, 4
    bins = r.randint(0, B, (N, F)).astype(np.int8)
    bins[r.rand(N, F) < 0.05] = B - 1                    # NA lane
    nb = np.array([32, 20, 32, 10], np.int32)
    w = (r.rand(N) > 0.1).astype(np.float32)
    treat = (r.rand(N) < 0.6).astype(np.float32)
    y = (r.rand(N) < 0.2 + 0.3 * treat * (bins[:, 0] > 16)).astype(
        np.float32)
    kw = dict(depth=depth, B=B, mtries=F, metric=metric, min_rows=10.0)
    tr_r, pt_r, pc_r = ref_up._grow_uplift_tree(
        jnp.asarray(bins), jnp.asarray(nb), jnp.asarray(w), jnp.asarray(y),
        jnp.asarray(treat), jax.random.PRNGKey(0), **kw)
    t = torch.from_numpy
    tr_p, pt_p, pc_p = up._grow_uplift_tree(t(bins), t(nb), t(w), t(y),
                                            t(treat), None, **kw)
    assert tr_p.is_split.any()
    for f in Tree._fields:
        a, b = np.asarray(getattr(tr_r, f)), getattr(tr_p, f).numpy()
        if f == "left_words":
            b = b.view(np.uint32)
        if f in ("leaf", "leaf_w"):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_allclose(pt_p.numpy(), np.asarray(pt_r), atol=1e-6)
    np.testing.assert_allclose(pc_p.numpy(), np.asarray(pc_r), atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_uplift_fit_parity(metric):
    cols, cats = _uplift_cols()
    fr_r, fr_p = _frames(cols, cats)
    kw = dict(treatment_column="treatment", ntrees=3, max_depth=5,
              sample_rate=1.0, mtries=-2, uplift_metric=metric, seed=7)
    m_r = RefUplift(**kw).train(fr_r, y="conversion")
    m_p = h2o3_tpu_torch.UpliftDRFEstimator(**kw).train(fr_p, y="conversion")
    _assert_forests(m_r, m_p)
    assert m_p.forest.is_split.sum() > 3
    for k in ("auuc", "qini", "uplift_top_decile", "MSE"):
        assert m_p.training_metrics[k] == pytest.approx(
            m_r.training_metrics[k], rel=1e-6, abs=1e-6), k
    assert m_p.training_metrics["auuc_type"] == "qini"
    assert m_p.training_metrics.nobs == m_r.training_metrics.nobs
    raw_r, raw_p = m_r._score_raw(fr_r), m_p._score_raw(fr_p)
    for k in ("uplift_predict", "p_y1_ct1", "p_y1_ct0"):
        np.testing.assert_allclose(raw_p[k], raw_r[k], atol=1e-6, err_msg=k)


def test_mtries_mask_keeps_exactly_mtries_columns():
    gen = torch.Generator().manual_seed(3)
    for L, F, m in ((1, 3, 1), (16, 12, 3), (64, 5, 4)):
        mask = _mtries_mask(gen, L, F, m, torch.device("cpu"))
        assert mask.shape == (L, F) and mask.dtype == torch.bool
        assert (mask.sum(dim=1) == m).all()
    a = _mtries_mask(torch.Generator().manual_seed(9), 32, 12, 3, "cpu")
    b = _mtries_mask(torch.Generator().manual_seed(9), 32, 12, 3, "cpu")
    assert torch.equal(a, b)


def test_uplift_mtries_minus_one_gives_sqrt_f_columns_per_node(monkeypatch):
    """mtries=-1 → int(sqrt(F)) columns per node, at every level of every
    tree (F = 4 features here → 2 per node)."""
    cols, cats = _uplift_cols(n=800, seed=2)
    cols["x3"] = np.random.RandomState(5).randn(800)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    seen = []

    def spy(gen, L, F, mtries, device):
        mask = _mtries_mask(gen, L, F, mtries, device)
        seen.append(mask)
        return mask

    monkeypatch.setattr(up, "_mtries_mask", spy)
    m = h2o3_tpu_torch.UpliftDRFEstimator(
        treatment_column="treatment", ntrees=2, max_depth=3, mtries=-1,
        seed=1).train(fr, y="conversion")
    assert len(seen) == 2 * 3
    for d, mask in enumerate(seen[:3]):
        assert mask.shape == (2 ** d, 4)
        assert (mask.sum(dim=1) == 2).all()
    assert np.isfinite(m.training_metrics["auuc"])


def _ref_arrays(m_r) -> dict:
    """The reference uplift model's numpy images, as
    uplift_model_from_arrays takes them."""
    d = {f: np.asarray(getattr(m_r.forest, f)) for f in Tree._fields}
    bm = m_r.bm
    d.update(leaf_pt=np.asarray(m_r.leaf_pt), leaf_pc=np.asarray(m_r.leaf_pc),
             edges=np.asarray(bm.edges), nbins=np.asarray(bm.nbins),
             is_cat=np.asarray(bm.is_cat), names=list(bm.names),
             domains=list(bm.domains), nbins_total=bm.nbins_total,
             nbins_cats=bm.nbins_cats, domain=m_r.output["domain"],
             treatment_domain=m_r.output["treatment_domain"],
             response=m_r.output["response"],
             params={k: m_r.params[k] for k in ("treatment_column",
                                                "auuc_type", "auuc_nbins")})
    return d


def test_uplift_model_carried_across_scores_equal():
    """A reference-trained (bagged, sampled) uplift forest scores a fresh
    frame in the port as in the reference."""
    cols, cats = _uplift_cols(n=1200, seed=3)
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    m_r = RefUplift(treatment_column="treatment", ntrees=4, max_depth=4,
                    mtries=2, seed=5).train(fr_r, y="conversion")
    model = uplift_model_from_arrays(_ref_arrays(m_r), device="cpu")
    test_cols, _ = _uplift_cols(n=700, seed=9)
    te_r, te_p = _frames(test_cols, cats)
    raw_r, raw_p = m_r._score_raw(te_r), model._score_raw(te_p)
    for k in ("uplift_predict", "p_y1_ct1", "p_y1_ct0"):
        np.testing.assert_allclose(raw_p[k], raw_r[k], atol=1e-6, err_msg=k)
    mp, mr = model.model_performance(te_p), m_r.model_performance(te_r)
    for k in ("auuc", "qini"):
        assert mp[k] == pytest.approx(mr[k], rel=1e-6, abs=1e-6), k
    with pytest.raises(ValueError, match="treatment_column"):
        uplift_model_from_arrays(dict(_ref_arrays(m_r), params={}),
                                 device="cpu")


@pytest.mark.parametrize("kind", ["qini", "lift", "gain"])
def test_auuc_matches_reference(kind):
    r = np.random.RandomState(3)
    n = 4000
    tr = r.randint(0, 2, n).astype(float)
    true_up = np.where(r.rand(n) < 0.5, 0.4, 0.0)
    y = (r.rand(n) < 0.2 + true_up * tr).astype(float)
    score = true_up + r.randn(n) * 0.05
    assert up.auuc(score, y, tr, nbins=500, auuc_type=kind) == \
        ref_up.auuc(score, y, tr, nbins=500, auuc_type=kind)


def test_uplift_estimator_surface():
    with pytest.raises(ValueError, match="requires treatment_column"):
        h2o3_tpu_torch.UpliftDRFEstimator()
    with pytest.raises(ValueError, match="unknown UpliftDRF params"):
        h2o3_tpu_torch.UpliftDRFEstimator(treatment_column="t", bogus=1)
    with pytest.raises(NotImplementedError, match="nfolds"):
        h2o3_tpu_torch.UpliftDRFEstimator(treatment_column="t", nfolds=3)
    cols, cats = _uplift_cols(n=200)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    with pytest.raises(ValueError, match="unknown uplift_metric"):
        h2o3_tpu_torch.UpliftDRFEstimator(
            treatment_column="treatment", uplift_metric="gini",
            ntrees=1).train(fr, y="conversion")
    with pytest.raises(ValueError, match="2-level categorical response"):
        h2o3_tpu_torch.UpliftDRFEstimator(
            treatment_column="treatment", ntrees=1).train(fr, y="x0")
    est = h2o3_tpu_torch.UpliftDRFEstimator(treatment_column="treatment")
    assert est.resolve_x(fr, None, "conversion") == ["x0", "x1", "x2"]


def test_sampled_uplift_fit_is_seeded_by_tree_index():
    cols, cats = _uplift_cols(n=600, seed=4)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    kw = dict(treatment_column="treatment", ntrees=3, max_depth=3,
              mtries=1)
    a = h2o3_tpu_torch.UpliftDRFEstimator(seed=4, **kw).train(
        fr, y="conversion")
    b = h2o3_tpu_torch.UpliftDRFEstimator(seed=4, **kw).train(
        fr, y="conversion")
    c = h2o3_tpu_torch.UpliftDRFEstimator(seed=5, **kw).train(
        fr, y="conversion")
    for f in Tree._fields:
        assert torch.equal(getattr(a.forest, f), getattr(b.forest, f)), f
    assert not all(torch.equal(getattr(a.forest, f), getattr(c.forest, f))
                   for f in Tree._fields)


def test_uplift_cv_stays_unported_as_the_reference_fails_it():
    """The reference's UpliftDRF cross-validation reads a "p1" holdout
    column that uplift scoring does not make (it scores uplift_predict):
    its nfolds=2 fit fails with KeyError 'p1'. The port keeps raising
    NotImplementedError for nfolds."""
    cols, cats = _uplift_cols(n=200)
    fr = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    with pytest.raises(Exception, match="'p1'"):
        RefUplift(treatment_column="treatment", nfolds=2, ntrees=2,
                  max_depth=3, seed=1).train(fr, y="conversion")
    with pytest.raises(NotImplementedError, match="nfolds"):
        h2o3_tpu_torch.UpliftDRFEstimator(treatment_column="treatment",
                                          nfolds=2)
