"""RuleFit in the PyTorch port (on the CPU) against the reference package.

The same seeded numpy frames (three numerics with a planted rule, a
categorical with a level effect, NAs in one numeric; 2,048 rows) go
through both. At ``sample_rate=1`` the tree models sample no rows (the
port draws from torch generators, the reference from JAX's), the data
are tie-free, and the trees are equal: the rules are EXACT (names,
[lo, hi), language strings, support), and so are the winsor bounds
(the same host numpy quantiles). The L1 GLM over them is float32 in
another summation order, and its design is collinear by construction
(the leaf rules of a tree sum to the intercept), so its coefficients
and predictions are held at tolerances taken from the port's own fit on
row-permuted rows, which the test re-measures: ``COEF_TOL`` 2e-3 and
``PRED_TOL`` 2e-4 (the row-permuted gaps 3.2e-4 and 2.8e-5 gaussian,
1.1e-4 and 3.0e-6 binomial; the reference's 4.5e-4 and 3.8e-5, 3.0e-5
and 4.9e-6). The importance ranking is held only
where neighbouring |coef| lie more than 10 ``COEF_TOL`` apart, and as
rule texts and supports: two trees can share a rule, whose identical
columns the L1 fit may weigh either way. The
reference's default ``sample_rate=0.8`` is held through its model
carried across (``convert.py``), which must score as the reference's.
The reference's fits run on a one-device mesh.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import rulefit as ref_rf
from h2o3_tpu.models.tree import Tree as RefTree
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.models.convert import rulefit_model_from_arrays

COEF_TOL = 2e-3
PRED_TOL = 2e-4
RF = dict(seed=1, sample_rate=1.0, rule_generation_ntrees=6,
          min_rule_length=2, max_rule_length=3)
RULE_KEYS = ("model", "tree", "lo", "hi", "name", "lang", "support")


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


def rule_cols(kind="gaussian", n=2048, seed=3):
    """y = 3 where x1 > 5 and x2 < 3, + 0.5·x3 + 1 on level "c" + noise
    (binomial: the sign of that against its median); 3% of x3 NA."""
    r = np.random.RandomState(seed)
    x1 = r.uniform(0, 10, n)
    x2 = r.uniform(0, 10, n)
    x3 = r.randn(n)
    cat = r.randint(0, 5, n)
    f = (np.where((x1 > 5) & (x2 < 3), 3.0, 0.0) + 0.5 * x3
         + (cat == 2) * 1.0 + r.randn(n) * 0.3)
    x3[r.rand(n) < 0.03] = np.nan
    cols = {"x1": x1, "x2": x2, "x3": x3,
            "c": np.array(list("abcde"), object)[cat]}
    cols["y"] = f if kind == "gaussian" else np.where(
        f > np.median(f), "hi", "lo").astype(object)
    return cols


def _frames(cols):
    cats = ["c"] + (["y"] if cols["y"].dtype == object else [])
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    return fr_r, h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                                 device="cpu")


def _pred(s):
    return s["p1"] if "p1" in s else s["predict"]


def _rules(m):
    return [{k: r[k] for k in RULE_KEYS} for r in m.rules]


@pytest.fixture(scope="module", params=["gaussian", "binomial"])
def fitted(request):
    """(kind, reference model and scores, port model and frame, port
    model on row-permuted rows)."""
    kind = request.param
    cols = rule_cols(kind)
    fr_r, fr_p = _frames(cols)
    with _one_device():
        m_r = ref_rf.RuleFitEstimator(**RF).train(fr_r, y="y")
        s_r = m_r._score_raw(fr_r)
    m_p = h2o3_tpu_torch.RuleFitEstimator(**RF).train(fr_p, y="y")
    perm = np.random.RandomState(1).permutation(len(cols["y"]))
    _, fr_q = _frames({k: v[perm] for k, v in cols.items()})
    m_q = h2o3_tpu_torch.RuleFitEstimator(**RF).train(fr_q, y="y")
    return kind, m_r, s_r, m_p, fr_p, m_q


def _rules_and_winsor_bounds_exact(fitted):
    kind, m_r, _, m_p, _, m_q = fitted
    assert _rules(m_p) == _rules(m_r) == _rules(m_q)
    assert len(m_p.rules) == m_p.output["n_rules"] == m_r.output["n_rules"]
    assert all(0 < r["support"] < 1 for r in m_p.rules)
    assert any(" in {" in r["lang"] for r in m_p.rules)     # the categorical
    assert any("or NA" in r["lang"] for r in m_p.rules)
    assert m_p.linear_cols == m_r.linear_cols == ["x1", "x2", "x3"]
    assert m_p.winsor == m_r.winsor


def _glm_coefficients_and_predictions(fitted):
    kind, m_r, s_r, m_p, fr_p, m_q = fitted
    c_p, c_r, c_q = (m.glm_model.coefficients for m in (m_p, m_r, m_q))
    assert list(c_p) == list(c_r)
    for other in (c_r, c_q):
        np.testing.assert_allclose(list(c_p.values()), list(other.values()),
                                   rtol=0, atol=COEF_TOL)
    p_p = _pred(m_p._score_raw(fr_p))
    for other in (_pred(s_r), _pred(m_q._score_raw(fr_p))):
        np.testing.assert_allclose(p_p, other, rtol=0, atol=PRED_TOL)
    tm_r = m_r.training_metrics.to_dict()
    tm_p = m_p.training_metrics.to_dict()
    for k in ("MSE", "logloss", "AUC", "r2"):
        if k in tm_r:
            assert tm_p[k] == pytest.approx(tm_r[k], rel=1e-3), k


def _rule_importance(fitted):
    """Each rule's support and coefficient; the ranking where the
    neighbouring |coef| are far apart."""
    kind, m_r, _, m_p, _, _ = fitted
    imp_r = {d["name"]: d for d in m_r.rule_importance}
    imp_p = {d["name"]: d for d in m_p.rule_importance}
    for name in set(imp_r) & set(imp_p):
        a, b = imp_r[name], imp_p[name]
        assert (a["rule"], a["support"]) == (b["rule"], b["support"])
        assert b["coefficient"] == pytest.approx(a["coefficient"],
                                                 abs=COEF_TOL)
    for name in set(imp_r) ^ set(imp_p):          # near zero in one
        d = imp_r.get(name) or imp_p.get(name)
        assert abs(d["coefficient"]) <= COEF_TOL
    mags = [abs(d["coefficient"]) for d in m_r.rule_importance]
    clear = 0
    for i in range(len(mags) - 1):
        if mags[i] - mags[i + 1] > 10 * COEF_TOL:
            clear += 1
            assert _ranked(m_p, i + 1) == _ranked(m_r, i + 1)
    assert clear >= 2


def _ranked(m, k):
    """The k highest-ranked rules as a multiset of (text, support): a rule
    two trees share makes identical columns, between which the L1 fit
    may split its weight either way."""
    return sorted((d["rule"], d["support"]) for d in m.rule_importance[:k])


def _gbm_arrays(tm, algo):
    d = {f: np.asarray(getattr(tm.forest, f)) for f in RefTree._fields}
    bm = tm.bm
    d.update(edges=np.asarray(bm.edges), nbins=np.asarray(bm.nbins),
             is_cat=np.asarray(bm.is_cat), names=list(bm.names),
             domains=list(bm.domains), nbins_total=bm.nbins_total,
             nbins_cats=bm.nbins_cats, category=tm.output["category"],
             domain=tm.output["domain"], response=tm.output["response"],
             default_threshold=tm.output.get("default_threshold", 0.5),
             algo=algo)
    if algo == "gbm":
        d.update(f0=np.asarray(tm.f0), dist_name=tm.dist_name)
    return d


def _glm_arrays(m) -> dict:
    return dict(coef=np.asarray(m.coef), family=m.family.name,
                link=m.family.link, tweedie_power=float(m.family.p),
                theta=float(m.family.theta), di_stats=m.di_stats,
                features=list(m.features), output=dict(m.output),
                params=dict(m.params))


def carried(m_r, algo="gbm"):
    return rulefit_model_from_arrays(dict(
        tree_models=[_gbm_arrays(t, algo) for t in m_r.tree_models],
        glm=_glm_arrays(m_r.glm_model), rules=m_r.rules,
        linear_cols=m_r.linear_cols, winsor=m_r.winsor,
        output=dict(m_r.output), params=dict(m_r.params)), device="cpu")


@pytest.mark.parametrize("algo", ["gbm", "drf"])
def test_reference_model_at_its_default_sample_rate_carried_across(algo):
    """The reference's default RuleFit (row sampling 0.8; DRF also
    samples columns) carried across scores a new frame as the
    reference's, its rule columns from the port's leaf ids."""
    cols = rule_cols("binomial", n=1500, seed=6)
    fr_r, _ = _frames(cols)
    kw = dict(seed=2, rule_generation_ntrees=4, min_rule_length=3,
              max_rule_length=3, algorithm=algo)
    with _one_device():
        m_r = ref_rf.RuleFitEstimator(**kw).train(fr_r, y="y")
        new_r, new_p = _frames(rule_cols("binomial", n=700, seed=8))
        s_r = m_r._score_raw(new_r)
        perf_r = m_r.model_performance(new_r).to_dict()
    m_c = carried(m_r, algo)
    s_c = m_c._score_raw(new_p)
    np.testing.assert_allclose(s_c["p1"], s_r["p1"], rtol=0, atol=1e-6)
    ff = m_c._feature_frame(new_p)
    assert ff.names == [r["name"] for r in m_r.rules] + [
        f"linear.{n}" for n in m_r.linear_cols]
    perf_c = m_c.model_performance(new_p).to_dict()
    for k in ("AUC", "logloss"):
        assert perf_c[k] == pytest.approx(perf_r[k], rel=1e-5), k


def test_max_num_rules_and_linear_model():
    """max_num_rules keeps the largest |coef| and zeroes the rest of the
    GLM; model_type="linear" fits the winsorized predictors alone."""
    cols = rule_cols(n=1200, seed=5)
    fr_r, fr_p = _frames(cols)
    kw = dict(RF, rule_generation_ntrees=3, max_rule_length=2,
              max_num_rules=4)
    with _one_device():
        m_r = ref_rf.RuleFitEstimator(**kw).train(fr_r, y="y")
        l_r = ref_rf.RuleFitEstimator(model_type="linear", seed=1).train(
            fr_r, y="y")
        sl_r = l_r._score_raw(fr_r)["predict"]
    m_p = h2o3_tpu_torch.RuleFitEstimator(**kw).train(fr_p, y="y")
    l_p = h2o3_tpu_torch.RuleFitEstimator(model_type="linear",
                                          seed=1).train(fr_p, y="y")
    assert _rules(m_p) == _rules(m_r)
    assert len(m_p.rule_importance) <= 4
    assert _ranked(m_p, 4) == _ranked(m_r, 4)
    kept = {d["name"] for d in m_p.rule_importance}
    for nm, c in zip(m_p.glm_model.output["coef_names"], m_p.glm_model.coef):
        assert nm in kept or c == 0.0
    assert l_p.rules == [] and l_p.tree_models == []
    assert l_p.linear_cols == ["x1", "x2", "x3"]
    np.testing.assert_allclose(l_p._score_raw(fr_p)["predict"], sl_r,
                               rtol=0, atol=PRED_TOL)


def test_cross_validation_matches_the_reference():
    cols = rule_cols("binomial", n=900, seed=7)
    fr_r, fr_p = _frames(cols)
    kw = dict(RF, rule_generation_ntrees=3, min_rule_length=2,
              max_rule_length=2, nfolds=3)
    with _one_device():
        m_r = ref_rf.RuleFitEstimator(**kw).train(fr_r, y="y")
    m_p = h2o3_tpu_torch.RuleFitEstimator(**kw).train(fr_p, y="y")
    np.testing.assert_array_equal(m_p._cv_folds, m_r._cv_folds)
    cv_r = m_r.cross_validation_metrics.to_dict()
    cv_p = m_p.cross_validation_metrics.to_dict()
    for k in ("AUC", "logloss"):
        assert cv_p[k] == pytest.approx(cv_r[k], rel=1e-3), k


def test_what_stays_as_in_the_reference():
    with pytest.raises(NotImplementedError, match="weights_column"):
        h2o3_tpu_torch.RuleFitEstimator(weights_column="w")
    h2o3_tpu_torch.RuleFitEstimator(distribution="bernoulli")   # inert
    cols = rule_cols(n=60)
    cols["y"] = np.array(["a", "b", "c"], object)[np.arange(60) % 3]
    _, fr_p = _frames(cols)
    with pytest.raises(ValueError, match="multinomial"):
        h2o3_tpu_torch.RuleFitEstimator().train(fr_p, y="y")


def _rule_frame_builds_host_views_on_demand(fitted):
    """The rule columns' device data are 0/1 on the logical rows, 0 and
    NA on the padding; their host views come from one fetch."""
    kind, _, _, m_p, fr_p, _ = fitted
    ff = m_p._feature_frame(fr_p)
    first = ff.col(m_p.rules[0]["name"])
    assert first.host is None
    v = first.host_view()
    assert set(np.unique(v)) <= {0.0, 1.0}
    assert v.mean() == m_p.rules[0]["support"]
    src = first.source
    assert src._host is not None and \
        ff.col(m_p.rules[1]["name"]).source is src
    np.testing.assert_array_equal(first.data[:fr_p.nrows].numpy(), v)


def test_frame_add_column_appends_replaces_and_checks_rows():
    """``Frame.add_column`` (RuleFit and the reference's ANOVA-GLM use
    it): a new name appends, a known name replaces in place, and a
    column of other rows or padding is refused."""
    from h2o3_tpu_torch.frame.column import column_from_numpy
    fr = h2o3_tpu_torch.Frame.from_numpy({"a": np.arange(10.0),
                                          "b": np.ones(10)}, device="cpu")
    fr.add_column(column_from_numpy("c", np.full(10, 2.0),
                                    fr.nrows_padded, "cpu"))
    assert fr.names == ["a", "b", "c"]
    fr.add_column(column_from_numpy("a", -np.arange(10.0),
                                    fr.nrows_padded, "cpu"))
    assert fr.names == ["a", "b", "c"]
    np.testing.assert_array_equal(fr.col("a").to_numpy(), -np.arange(10.0))
    with pytest.raises(ValueError, match="rows"):
        fr.add_column(column_from_numpy("d", np.ones(9), fr.nrows_padded,
                                        "cpu"))
    with pytest.raises(ValueError, match="padded"):
        fr.add_column(column_from_numpy("d", np.ones(10), 24, "cpu"))


def test_rulefit_against_the_reference(fitted):
    """Rules, winsor bounds, the GLM, the importance table and the rule
    frame (one test a fitted case, so that under xdist each
    reference fit runs once)."""
    _rules_and_winsor_bounds_exact(fitted)
    _glm_coefficients_and_predictions(fitted)
    _rule_importance(fitted)
    _rule_frame_builds_host_views_on_demand(fitted)
