"""The tree models' scoring surface in the PyTorch port (on the CPU) on
forests carried across from the reference package: leaf assignment,
feature frequencies, staged probabilities and TreeSHAP contributions.

Leaf ids and feature counts are integers: EXACT, with the reference's
column names. Staged probabilities within 1e-6 of the reference's (the
port adds f0 to the running tree sum, as ``predict`` does, so its last
stage is ``predict``'s bit for bit). Contributions within
1e-5·max(1, |margin|) of the reference's, and each row sums to the
link-space margin within the same bound (local accuracy). Where a DRF
node that does not split has a child that does, the reference ends the
path early and misses local accuracy: there the port's contributions
are held against exact Shapley values by enumeration instead."""

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models.drf import DRFEstimator as RefDRF
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu_torch.frame.binning import rebin_for_scoring
from h2o3_tpu_torch.ml import shap
from h2o3_tpu_torch.models.convert import (drf_model_from_arrays,
                                           gbm_model_from_arrays)

from tests.test_torch_drf import _ref_arrays as _drf_arrays
from tests.test_torch_gbm import _ref_arrays as _gbm_arrays
from torch_ranks import mixed_cols, multi_cols, offset_cols, regression_cols
from torch_threads import one_torch_thread  # noqa: F401 - autouse

CASES = {
    # name: (data, its training rows' kwargs, algo, params); each model
    # is scored on 400 fresh rows of its data
    "gbm_binomial": (mixed_cols, dict(seed=3), "gbm",
                     dict(ntrees=5, max_depth=6, seed=2)),
    "gbm_gaussian": (regression_cols, dict(seed=2), "gbm",
                     dict(ntrees=5, max_depth=5, seed=2,
                          distribution="gaussian", sample_rate=0.8)),
    # max_depth 3, laid out at the depth bucket 6: ids shift by 3
    "gbm_shallow": (mixed_cols, dict(seed=4), "gbm",
                    dict(ntrees=4, max_depth=3, seed=5)),
    "gbm_offset": (offset_cols, dict(seed=6), "gbm",
                   dict(ntrees=4, max_depth=4, seed=1,
                        offset_column="off")),
    "gbm_multinomial": (multi_cols, dict(K=3, seed=2), "gbm",
                        dict(ntrees=3, max_depth=4, seed=2)),
    "drf_binomial": (mixed_cols, dict(seed=5), "drf",
                     dict(ntrees=4, max_depth=5, seed=3)),
    "drf_regression": (regression_cols, dict(seed=3), "drf",
                       dict(ntrees=4, max_depth=6, seed=3)),
    "drf_multinomial": (multi_cols, dict(K=3, seed=4), "drf",
                        dict(ntrees=3, max_depth=4, seed=3)),
}
_MODELS = {}


def _carried(name):
    """(reference model, port model, reference frame, port frame): the
    reference forest trained on 600 rows, scored on 400 fresh rows."""
    if name not in _MODELS:
        make, kw, algo, params = CASES[name]
        cols, cats = make(n=600, **kw)
        fr = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
        if algo == "gbm":
            m_r = RefGBM(**params).train(fr, y="y")
            model = gbm_model_from_arrays(_gbm_arrays(m_r), device="cpu")
        else:
            m_r = RefDRF(**params).train(fr, y="y")
            d = dict(_drf_arrays(m_r), params=m_r.params)
            model = drf_model_from_arrays(d, device="cpu")
        test_cols, _ = make(n=400, **dict(kw, seed=kw["seed"] + 10))
        te_r = h2o3_tpu.Frame.from_numpy(test_cols, categorical=cats)
        te_p = h2o3_tpu_torch.Frame.from_numpy(test_cols, categorical=cats,
                                               device="cpu")
        _MODELS[name] = (m_r, model, te_r, te_p)
    return _MODELS[name]


def _same_frames(a_p, a_r, exact=True, **tol):
    assert a_p.names == a_r.names
    for c in a_r.names:
        got, want = a_p.col(c).to_numpy(), a_r.col(c).to_numpy()
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=c)
        else:
            np.testing.assert_allclose(got, want, err_msg=c, **tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_leaf_assignment_exact(name):
    m_r, model, te_r, te_p = _carried(name)
    la_p = model.predict_leaf_node_assignment(te_p)
    _same_frames(la_p, m_r.predict_leaf_node_assignment(te_r))
    if name == "gbm_shallow":
        assert la_p.col("T1.C1").to_numpy().max() < 2 ** 3
    if name.startswith("gbm_multinomial"):
        assert la_p.names[:3] == ["T1.C1", "T1.C2", "T1.C3"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_feature_frequencies_exact(name):
    m_r, model, te_r, te_p = _carried(name)
    ff = model.feature_frequencies(te_p)
    _same_frames(ff, m_r.feature_frequencies(te_r))
    assert ff.col(ff.names[0]).to_numpy().sum() > 0


@pytest.mark.parametrize("name", [n for n in sorted(CASES)
                                  if n.startswith("gbm")])
def test_staged_predict_proba(name):
    m_r, model, te_r, te_p = _carried(name)
    st_p = model.staged_predict_proba(te_p)
    _same_frames(st_p, m_r.staged_predict_proba(te_r), exact=False,
                 rtol=0, atol=1e-6)
    pred = model.predict(te_p)
    T = model.forest.feat.shape[0] // model.n_class_trees
    if name == "gbm_multinomial":
        for k in range(3):
            np.testing.assert_array_equal(
                st_p.col(f"T{T}.C{k + 1}").to_numpy(),
                pred.col(f"p{k}").to_numpy())
    elif name == "gbm_gaussian":
        np.testing.assert_array_equal(st_p.col(f"T{T}").to_numpy(),
                                      pred.col("predict").to_numpy())
    else:
        np.testing.assert_array_equal(st_p.col(f"T{T}.C1").to_numpy(),
                                      pred.col("p0").to_numpy())


def _margin(model, frame) -> np.ndarray:
    bm = rebin_for_scoring(model.bm, frame)
    if model.algo == "gbm":
        return model._margins(bm).numpy()[:frame.nrows]
    return model._mean_votes(bm)[:, 0].numpy()[:frame.nrows]


def _shapley(model, t, x, F):
    """Exact Shapley values of tree t at binned row x by enumeration:
    v(S) is the cover-weighted mean of the tree over the features outside
    S, a node that does not split passing its rows to its left child."""
    import itertools
    from math import factorial
    tr = {f: getattr(model.forest, f)[t].numpy() for f in (
        "feat", "thresh", "na_left", "is_split", "leaf", "leaf_w",
        "cat_split")}
    words = model.forest.left_words[t].numpy().view(np.uint32)
    D, B = tr["feat"].shape[0], model.bm.nbins_total

    def cover(d, l):
        return tr["leaf_w"].reshape(1 << d, -1)[l].sum()

    def left(d, l):
        b = x[tr["feat"][d, l]]
        if b == B - 1:
            return bool(tr["na_left"][d, l])
        if tr["cat_split"][d, l]:
            return bool((words[d, l, b >> 5] >> (b & 31)) & 1)
        return b <= tr["thresh"][d, l]

    def v(S, d=0, l=0):
        while d < D and not tr["is_split"][d, l]:
            d, l = d + 1, 2 * l
        if d == D:
            return tr["leaf"][l]
        if tr["feat"][d, l] in S:
            return v(S, d + 1, 2 * l + (0 if left(d, l) else 1))
        return (cover(d + 1, 2 * l) * v(S, d + 1, 2 * l)
                + cover(d + 1, 2 * l + 1) * v(S, d + 1, 2 * l + 1)) \
            / cover(d, l)

    phi = np.zeros(F)
    for j in range(F):
        rest = [k for k in range(F) if k != j]
        for r in range(F):
            for S in itertools.combinations(rest, r):
                wgt = factorial(r) * factorial(F - r - 1) / factorial(F)
                phi[j] += wgt * (v(set(S) | {j}) - v(set(S)))
    return phi


@pytest.mark.parametrize("name", [n for n in sorted(CASES)
                                  if "multinomial" not in n])
def test_contributions_match_reference_and_sum_to_margin(name):
    m_r, model, te_r, te_p = _carried(name)
    c_p = model.predict_contributions(te_p)
    c_r = m_r.predict_contributions(te_r)
    assert c_p.names == c_r.names == list(model.output["names"]) + [
        "BiasTerm"]
    got = np.stack([c_p.col(c).to_numpy() for c in c_p.names], 1)
    want = np.stack([c_r.col(c).to_numpy() for c in c_r.names], 1)
    # the margin without an offset: f0 and the trees (BiasTerm holds f0)
    margin = _margin(model, te_p)
    tol = 1e-5 * np.maximum(1.0, np.abs(margin))
    assert (np.abs(got.sum(axis=1) - margin) <= tol).all()
    assert np.abs(got[:, :-1]).max() > 1e-3
    np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=1e-6)
    if (np.abs(want.sum(axis=1) - margin) <= tol).all():
        assert (np.abs(got - want) <= tol[:, None]).all()
        return
    # the reference ends a path at a node that does not split, though a
    # deeper level splits its rows (here a DRF node whose column sample
    # found no split): every row misses the prediction, while the port's
    # equal the exact Shapley values
    assert name == "drf_regression"
    assert (np.abs(want.sum(axis=1) - margin) > 0.05).all()
    bm = rebin_for_scoring(model.bm, te_p)
    x = bm.bins.numpy().astype(np.int64)
    F = len(model.output["names"])
    T = model.forest.feat.shape[0]
    for i in range(5):
        exact = sum(_shapley(model, t, x[i], F) for t in range(T)) / T
        np.testing.assert_allclose(got[i, :F], exact, atol=1e-5)


def test_contributions_any_row_block_agrees():
    m_r, model, te_r, te_p = _carried("drf_binomial")
    bm = rebin_for_scoring(model.bm, te_p)
    whole = shap.forest_contributions(model.forest, bm.bins[:400],
                                      bm.nbins_total, scale=0.25)
    blocks = shap.forest_contributions(model.forest, bm.bins[:400],
                                       bm.nbins_total, scale=0.25,
                                       row_block=64)
    np.testing.assert_array_equal(blocks, whole)


@pytest.mark.parametrize("name", ["gbm_multinomial", "drf_multinomial"])
def test_multinomial_contributions_raise(name):
    m_r, model, te_r, te_p = _carried(name)
    for m, fr in ((m_r, te_r), (model, te_p)):
        with pytest.raises(ValueError, match="regression and binomial"):
            m.predict_contributions(fr)


def test_fitted_port_models_score_the_surface():
    """Models the port trains itself (not carried across) take the same
    methods; the XGBoost facade's model is a GBM model."""
    cols, cats = mixed_cols(n=500, seed=8)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    m = h2o3_tpu_torch.XGBoostEstimator(nrounds=3, max_depth=3,
                                        seed=1).train(fr, y="y")
    la = m.predict_leaf_node_assignment(fr)
    assert la.names == ["T1.C1", "T2.C1", "T3.C1"]
    c = m.predict_contributions(fr)
    s = np.stack([c.col(n).to_numpy() for n in c.names], 1).sum(1)
    np.testing.assert_allclose(s, _margin(m, fr), atol=1e-5)
    assert m.feature_frequencies(fr).col("x1").to_numpy().sum() > 0
