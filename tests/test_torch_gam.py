"""GAM in the PyTorch port (on the CPU) against the reference package.

The same seeded numpy frames (a numeric and a categorical linear
predictor, two gam columns, NAs in one of them, 4,000 rows; a gaussian
and a binomial response) go through both. The knots come from the same
float64 host values: EXACT. The port builds the basis in float64 torch
with the reference's recursion in its order, so it is held within 1e-12
of the reference's numpy (it is bit-equal here), and the centering means
within 1e-12 (a float64 mean in another order). The fit is float32 (the
Gram in another summation order, another Cholesky), so its tolerances
come from the port's own fit on row-permuted data, which each test
re-measures: coefficients within ``COEF_TOL`` 3e-5 and predictions
within ``PRED_TOL`` 2e-5 (row-permuted gaps 6.3e-6 and 3.0e-6 gaussian,
1.4e-6 and 3.6e-7 binomial; the reference's 9.7e-6 and 7.0e-6, 1.7e-6
and 5.7e-7), metrics and the residual deviance within 1e-5 relative.
The PIRLS step counts are equal: the data keep every step's largest
coefficient change far from ``beta_epsilon`` (the last binomial step
4.2e-5 against 1e-4). The reference's fits run on a one-device mesh.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import gam as ref_gam
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.models import gam as port_gam
from h2o3_tpu_torch.models.convert import gam_model_from_arrays

COEF_TOL = 3e-5
PRED_TOL = 2e-5
METRIC_TOL = 1e-5
BASIS_TOL = 1e-12

KW = {"gaussian": dict(gam_columns=["x", "z"], num_knots=[12, 6],
                       scale=[0.01, 0.1]),
      "binomial": dict(gam_columns=["x", "z"], family="binomial",
                       num_knots=[10, 5])}
X = ["lin", "c", "x", "z"]


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


def gam_cols(kind: str, n=4000, seed=4):
    """sin(1.7x) + 0.5·lin + 0.3·cos(z) + a level effect (gaussian), or
    a logistic of 2·sin(1.5x) + 0.5·lin (binomial); 2% of x NA."""
    r = np.random.RandomState(seed)
    x = r.uniform(-3, 3, n)
    lin = r.randn(n)
    z = r.uniform(0, 5, n)
    c = r.randint(0, 3, n)
    f = np.sin(1.7 * x) + 0.5 * lin + 0.3 * np.cos(z) + 0.4 * (c == 1)
    y = f + r.randn(n) * 0.15
    x[r.rand(n) < 0.02] = np.nan
    pr = 1.0 / (1.0 + np.exp(-2.0 * np.sin(1.5 * np.nan_to_num(x))
                             - 0.5 * lin))
    yb = np.where(r.rand(n) < pr, "yes", "no").astype(object)
    cols = {"x": x, "z": z, "lin": lin,
            "c": np.array(["p", "q", "r"], object)[c]}
    cols["y"] = y if kind == "gaussian" else yb
    return cols


def _frames(cols, device="cpu"):
    cats = ["c"] + (["y"] if cols["y"].dtype == object else [])
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    return fr_r, h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                                 device=device)


def _pred(scores):
    return scores["p1"] if "p1" in scores else scores["predict"]


@pytest.fixture(scope="module", params=["gaussian", "binomial"])
def fitted(request):
    """(kind, columns, reference model, its PIRLS changes, port model,
    port model on row-permuted rows)."""
    kind = request.param
    cols = gam_cols(kind)
    fr_r, fr_p = _frames(cols)
    deltas = []
    orig = ref_gam._pirls_iter

    def spy(*a, **k):
        out = orig(*a, **k)
        deltas.append(float(out[1]))
        return out

    with _one_device():
        ref_gam._pirls_iter = spy
        try:
            m_r = ref_gam.GAMEstimator(**KW[kind]).train(fr_r, y="y", x=X)
        finally:
            ref_gam._pirls_iter = orig
        s_r = m_r._score_raw(fr_r)
    m_p = h2o3_tpu_torch.GAMEstimator(**KW[kind]).train(fr_p, y="y", x=X)
    perm = np.random.RandomState(1).permutation(len(cols["y"]))
    _, fr_q = _frames({k: v[perm] for k, v in cols.items()})
    m_q = h2o3_tpu_torch.GAMEstimator(**KW[kind]).train(fr_q, y="y", x=X)
    return kind, cols, m_r, s_r, deltas, m_p, m_q, fr_p


@pytest.mark.parametrize("case", ["spread", "with_nas", "four_levels",
                                  "one_knot_step"])
def test_basis_matches_the_reference(case):
    """Quantile knots EXACT; the basis within 1e-12 of the reference's
    float64 numpy, on the knot grid's edges, beyond it and at NAs."""
    r = np.random.RandomState(7)
    x = r.uniform(-2, 5, 3000)
    k = 10
    if case == "with_nas":
        x[::17] = np.nan
    elif case == "four_levels":
        x = r.randint(0, 4, 3000).astype(np.float64)    # 4 unique knots
    elif case == "one_knot_step":
        x = np.where(x > 0, 1.0, 2.0)                   # the 4-knot fallback
    knots = port_gam.gam_knots(x, k)
    qs = np.unique(np.nanquantile(x, np.linspace(0, 1, k)))
    want = qs if len(qs) >= 4 else np.linspace(np.nanmin(x),
                                               np.nanmax(x) + 1e-6, 4)
    np.testing.assert_array_equal(knots, want)
    probe = np.concatenate([x, [knots[0], knots[-1], knots[0] - 1,
                                knots[-1] + 1, np.nan]])
    B_r = ref_gam.bspline_basis(probe, knots)
    B_p = port_gam.bspline_basis(torch.from_numpy(probe), knots).numpy()
    assert B_p.shape == B_r.shape
    np.testing.assert_allclose(B_p, B_r, rtol=0, atol=BASIS_TOL)


def test_curvature_penalty_is_the_references():
    for nb in (4, 9, 13):
        np.testing.assert_array_equal(port_gam.curvature_penalty(nb),
                                      ref_gam.curvature_penalty(nb))


def _knots_and_centering_means(fitted):
    kind, cols, m_r, _, _, m_p, _, _ = fitted
    for a, b in zip(m_r.gam_spec, m_p.gam_spec):
        assert a["col"] == b["col"]
        np.testing.assert_array_equal(b["knots"], a["knots"])
        np.testing.assert_allclose(b["means"], a["means"], rtol=0,
                                   atol=BASIS_TOL)
    assert m_p.output["coef_names"] == m_r.output["coef_names"]


def _fit_matches_the_reference(fitted):
    """Coefficients, predictions, PIRLS steps, residual deviance and
    training metrics; the port's row-permuted fit is the witness of the
    tolerances."""
    kind, cols, m_r, s_r, deltas, m_p, m_q, fr_p = fitted
    assert m_p.output["pirls_iterations"] == len(deltas)
    assert min(abs(d - 1e-4) for d in deltas) > 0.2e-4
    for other in (np.asarray(m_r.coef), m_q.coef):
        np.testing.assert_allclose(m_p.coef, other, rtol=0, atol=COEF_TOL)
    p_p = _pred(m_p._score_raw(fr_p))
    for other in (_pred(s_r), _pred(m_q._score_raw(fr_p))):
        np.testing.assert_allclose(p_p, other, rtol=0, atol=PRED_TOL)
    assert m_p.output["residual_deviance"] == pytest.approx(
        m_r.output["residual_deviance"], rel=METRIC_TOL)
    tm_r, tm_p = m_r.training_metrics.to_dict(), \
        m_p.training_metrics.to_dict()
    for k, v in tm_r.items():
        if isinstance(v, float):
            assert tm_p[k] == pytest.approx(v, rel=METRIC_TOL, abs=1e-9), k
    if kind == "binomial":
        assert m_p.output["default_threshold"] == \
            m_r.output["default_threshold"]
        assert list(m_p._score_raw(fr_p)) == ["predict", "p0", "p1"]


def _scoring_a_new_frame(fitted):
    """A new frame of another row count (padding), values beyond the
    knots and NAs: predictions and metrics as the reference's."""
    kind, cols, m_r, _, _, m_p, _, _ = fitted
    r = np.random.RandomState(9)
    n = 101
    new = {"x": np.linspace(-4, 4, n), "z": r.uniform(-1, 6, n),
           "lin": r.randn(n),
           "c": np.array(["p", "q", "r", "s"], object)[r.randint(0, 4, n)],
           "y": cols["y"][:n]}
    new["x"][::10] = np.nan
    fr_r, fr_p = _frames(new)
    with _one_device():
        s_r = m_r._score_raw(fr_r)
        mm_r = m_r.model_performance(fr_r).to_dict()
    s_p = m_p._score_raw(fr_p)
    assert np.isfinite(_pred(s_p)).all()
    np.testing.assert_allclose(_pred(s_p), _pred(s_r), rtol=0,
                               atol=PRED_TOL)
    mm_p = m_p.model_performance(fr_p).to_dict()
    for k in ("MSE", "logloss", "AUC", "r2"):
        if k in mm_r:
            assert mm_p[k] == pytest.approx(mm_r[k], rel=1e-4), k


def _reference_model_carried_across_scores_alike(fitted):
    kind, cols, m_r, s_r, _, _, _, fr_p = fitted
    m_c = gam_model_from_arrays(dict(
        coef=np.asarray(m_r.coef), family=m_r.family.name,
        link=m_r.family.link, tweedie_power=float(m_r.family.p),
        di_stats=m_r.di_stats, features=list(m_r.features),
        gam_spec=m_r.gam_spec, output=dict(m_r.output),
        params=dict(m_r.params)))
    s_c = m_c._score_raw(fr_p)
    np.testing.assert_allclose(_pred(s_c), _pred(s_r), rtol=0, atol=2e-6)
    if kind == "binomial":
        np.testing.assert_array_equal(s_c["predict"] == 1,
                                      _pred(s_r) >= m_r.output[
                                          "default_threshold"])


def test_cross_validation_with_weights_matches_the_reference():
    """nfolds=3 (seeded random folds) with a weights column: each fold a
    subset-frame fit in both, the CV metrics from the merged holdout
    predictions, weighted."""
    cols = gam_cols("gaussian", n=1500, seed=5)
    cols["w"] = np.random.RandomState(6).uniform(0.5, 2.0, 1500)
    fr_r, fr_p = _frames(cols)
    kw = dict(KW["gaussian"], nfolds=3, seed=2, weights_column="w")
    with _one_device():
        m_r = ref_gam.GAMEstimator(**kw).train(fr_r, y="y", x=X)
    m_p = h2o3_tpu_torch.GAMEstimator(**kw).train(fr_p, y="y", x=X)
    cv_r = m_r.cross_validation_metrics.to_dict()
    cv_p = m_p.cross_validation_metrics.to_dict()
    for k in ("MSE", "mae", "r2"):
        assert cv_p[k] == pytest.approx(cv_r[k], rel=METRIC_TOL), k
    np.testing.assert_array_equal(m_p._cv_folds, m_r._cv_folds)
    np.testing.assert_allclose(m_p.coef, np.asarray(m_r.coef), rtol=0,
                               atol=COEF_TOL)


def test_planted_signal_is_recovered():
    """The reference's tests/test_gam.py recovery at 800 rows: the GAM
    finds sin(1.7x) + 0.5·lin within RMSE 0.15, a GLM cannot (> 0.4)."""
    r = np.random.RandomState(4)
    n = 800
    x = np.sort(r.uniform(-3, 3, n))
    lin = r.randn(n)
    f = np.sin(1.7 * x) + 0.5 * lin
    fr = h2o3_tpu_torch.Frame.from_numpy(
        {"x": x, "lin": lin, "y": f + r.randn(n) * 0.15}, device="cpu")
    m = h2o3_tpu_torch.GAMEstimator(gam_columns=["x"], num_knots=[12],
                                    scale=[0.01]).train(fr, y="y",
                                                        x=["lin", "x"])
    pred = m.predict(fr).col("predict").to_numpy()
    assert np.sqrt(np.mean((pred - f) ** 2)) < 0.15
    g = h2o3_tpu_torch.GLMEstimator(lambda_=0.0).train(fr, y="y",
                                                       x=["lin", "x"])
    assert np.sqrt(np.mean((g.predict(fr).col("predict").to_numpy() - f)
                           ** 2)) > 0.4


def test_parameters_as_in_the_reference():
    with pytest.raises(ValueError, match="gam_columns"):
        h2o3_tpu_torch.GAMEstimator()
    with pytest.raises(ValueError, match="unknown GAM params"):
        h2o3_tpu_torch.GAMEstimator(gam_columns=["x"], bogus=1)
    e = h2o3_tpu_torch.GAMEstimator(gam_columns=["x"], Lambda=0.1,
                                    bs=[1], keep_gam_cols=True)
    assert e.params["lambda_"] == 0.1
    cols = gam_cols("gaussian", n=400)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=["c"],
                                         device="cpu")
    a = h2o3_tpu_torch.GAMEstimator(gam_columns=["x"]).train(fr, y="y")
    b = h2o3_tpu_torch.GAMEstimator(gam_columns=["x"], bs=[1],
                                    keep_gam_cols=True).train(fr, y="y")
    np.testing.assert_array_equal(a.coef, b.coef)      # inert
    assert a.output["names"] == ["z", "lin", "c"]      # gam columns out


def test_gam_against_the_reference(fitted):
    """Knots, means, the fit, a new frame's scores and the reference's
    model carried across (one test a fitted case, so that under xdist each
    reference fit runs once)."""
    _knots_and_centering_means(fitted)
    _fit_matches_the_reference(fitted)
    _scoring_a_new_frame(fitted)
    _reference_model_carried_across_scores_alike(fitted)
