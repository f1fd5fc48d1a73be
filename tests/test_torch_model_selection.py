"""ModelSelection and ANOVA-GLM in the PyTorch port (on the CPU) against
the reference package.

Every candidate is a GLM fit in both packages (float32, another
summation order), and ModelSelection keeps a candidate on a strict ``>``
of ``r2`` (or −logloss): a near-tie could flip between packages. The
data give each predictor a well-separated effect (β = 2, −1.5, 1, 0.6,
0.3, 0), so the chosen sets are equal at every size in every mode, and
``r2`` within 1e-5 relative.

ANOVA's likelihood-ratio statistic is a difference of two deviances of
about the same size; for a term with no effect it is O(1) while each
deviance is ~1e4, and two float32 fits part by a few dozen ulps of the
deviance. So the statistic is held within ``LR_TOL`` = 2^-16 of the full
deviance (256 float32 ulps; the packages part by ~2e-6 of it). Every
port p-value lies between the chi-square tails at the reference's
statistic plus and minus that bound; where the statistic clears 100×
the bound the tails' logs agree within 1e-3 relative (those p-values
reach 1e-255 and underflow to 0), and both p-values of every other term lie above the
test's significance level 0.01 (those terms carry no effect in the
data; the smallest, x1:x5 of the gaussian case, has p = 0.014 in
both). The df are EXACT. The port's product columns go
into a new frame: the caller's frame is left as it was, where the
reference adds them to it; and the reference's ANOVA-GLM CV fails, so
the port's raises. The reference's fits run on a one-device mesh.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
from scipy.stats import chi2

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import model_selection as ref_ms
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.models.convert import (anovaglm_model_from_arrays,
                                           modelselection_model_from_arrays)

R2_TOL = 1e-5
LR_TOL = 2.0 ** -16
ALPHA = 0.01
BETA = (2.0, -1.5, 1.0, 0.6, 0.3, 0.0)


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


def sel_cols(kind: str, n=4096, seed=2):
    """x0..x5 standard normal with effects BETA, a categorical c of 3
    levels (+0.8 on level "b"), a gaussian or binomial response."""
    r = np.random.RandomState(seed)
    X = r.randn(n, len(BETA))
    c = r.randint(0, 3, n)
    eta = X @ np.asarray(BETA) + 0.8 * (c == 1)
    cols = {f"x{i}": X[:, i] for i in range(len(BETA))}
    cols["c"] = np.array(["a", "b", "d"], object)[c]
    if kind == "gaussian":
        cols["y"] = eta + r.randn(n)
    else:
        cols["y"] = np.where(r.rand(n) < 1 / (1 + np.exp(-eta)), "s",
                             "b").astype(object)
    return cols


def _frames(cols):
    cats = ["c"] + (["y"] if cols["y"].dtype == object else [])
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    return fr_r, h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                                 device="cpu")


def _glm_arrays(m) -> dict:
    return dict(coef=np.asarray(m.coef), coef_multinomial=None,
                family=m.family.name, link=m.family.link,
                tweedie_power=float(m.family.p), theta=float(m.family.theta),
                di_stats=m.di_stats, features=list(m.features),
                output=dict(m.output), params=dict(m.params))


MODES = [("maxr", "gaussian", dict(max_predictor_number=3)),
         ("maxr", "binomial", dict(max_predictor_number=2)),
         ("forward", "gaussian", dict(max_predictor_number=4)),
         ("backward", "gaussian", dict(min_predictor_number=2)),
         ("backward", "binomial", dict(min_predictor_number=3)),
         ("allsubsets", "gaussian", dict(max_predictor_number=3))]


@pytest.mark.parametrize("mode,kind,kw", MODES,
                         ids=[f"{m}-{k}" for m, k, _ in MODES])
def test_model_selection_chooses_the_same_sets(mode, kind, kw):
    cols = sel_cols(kind)
    x = [f"x{i}" for i in range(6 if mode != "allsubsets" else 5)]
    if mode == "backward":
        x = x + ["c"]
    fr_r, fr_p = _frames(cols)
    with _one_device():
        m_r = ref_ms.ModelSelectionEstimator(mode=mode, **kw).train(
            fr_r, y="y", x=x)
    m_p = h2o3_tpu_torch.ModelSelectionEstimator(mode=mode, **kw).train(
        fr_p, y="y", x=x)
    res_r, res_p = m_r.result(), m_p.result()
    assert [r["size"] for r in res_p] == [r["size"] for r in res_r]
    for a, b in zip(res_r, res_p):
        assert b["predictors"] == a["predictors"], b["size"]
        assert b["r2"] == pytest.approx(a["r2"], rel=R2_TOL)
    for size in (res_r[0]["size"], res_r[-1]["size"]):
        cr, cp = m_r.coef(size), m_p.coef(size)
        assert list(cp) == list(cr)
        np.testing.assert_allclose(list(cp.values()), list(cr.values()),
                                   rtol=1e-4, atol=1e-5)
    assert m_p.output["n_glm_fits"] > len(res_p)


def test_model_selection_cv_and_carried_model():
    """nfolds=3 (forward, two predictors): the CV metrics; and the
    reference's model carried across scores as it does."""
    cols = sel_cols("gaussian", n=2000, seed=3)
    fr_r, fr_p = _frames(cols)
    kw = dict(mode="forward", max_predictor_number=2, nfolds=3, seed=1)
    x = [f"x{i}" for i in range(4)]
    with _one_device():
        m_r = ref_ms.ModelSelectionEstimator(**kw).train(fr_r, y="y", x=x)
        s_r = m_r._score_raw(fr_r)["predict"]
    m_p = h2o3_tpu_torch.ModelSelectionEstimator(**kw).train(fr_p, y="y",
                                                             x=x)
    cv_r = m_r.cross_validation_metrics.to_dict()
    cv_p = m_p.cross_validation_metrics.to_dict()
    for k in ("MSE", "r2"):
        assert cv_p[k] == pytest.approx(cv_r[k], rel=R2_TOL)
    m_c = modelselection_model_from_arrays(dict(
        best_models={k: _glm_arrays(g) for k, g in m_r.best_models.items()},
        output=dict(m_r.output), params=dict(m_r.params)))
    assert m_c.result() == m_r.result()
    np.testing.assert_allclose(m_c._score_raw(fr_p)["predict"], s_r,
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module", params=["gaussian", "binomial"])
def anova(request):
    """(kind, reference model and frame, port model and frame) over x0,
    x1, x5 and c with pairwise numeric products."""
    cols = sel_cols(request.param, seed=4)
    x = ["x0", "x1", "x5", "c"]
    fr_r, fr_p = _frames(cols)
    with _one_device():
        m_r = ref_ms.ANOVAGLMEstimator().train(fr_r, y="y", x=x)
    m_p = h2o3_tpu_torch.ANOVAGLMEstimator().train(fr_p, y="y", x=x)
    return request.param, m_r, fr_r, m_p, fr_p


def _anova_table(anova):
    kind, m_r, _, m_p, _ = anova
    t_r, t_p = m_r.anova_table, m_p.anova_table
    assert [r["term"] for r in t_p] == [r["term"] for r in t_r] == [
        "x0", "x1", "x5", "c", "x0:x1", "x0:x5", "x1:x5"]
    assert [r["df"] for r in t_p] == [r["df"] for r in t_r] == \
        [1, 1, 1, 2, 1, 1, 1]
    bound = LR_TOL * m_r.output["full_deviance"]
    assert m_p.output["full_deviance"] == pytest.approx(
        m_r.output["full_deviance"], abs=bound)
    strong = 0
    for a, b in zip(t_r, t_p):
        assert abs(b["deviance"] - a["deviance"]) <= bound, a["term"]
        # the p-values the statistic's bound allows
        lo, hi = (ref_ms._chi2_sf(a["deviance"] + s * bound, a["df"])
                  for s in (1, -1))
        assert lo <= b["p_value"] <= hi, a["term"]
        if a["deviance"] >= 100 * bound:
            strong += 1
            # the tails' logs: the p-values themselves underflow to 0
            la, lb = (chi2.logsf(r["deviance"], r["df"]) for r in (a, b))
            assert lb == pytest.approx(la, rel=1e-3), a["term"]
        else:
            assert a["p_value"] > ALPHA and b["p_value"] > ALPHA, a["term"]
    assert strong == 3              # x0, x1 and c
    assert m_p.output["n_glm_fits"] == 8


def _anova_leaves_the_callers_frame_alone(anova):
    """The reference adds its product columns to the caller's frame; the
    port builds them into a frame of its own."""
    kind, m_r, fr_r, m_p, fr_p = anova
    assert "x0:x1" in fr_r.names
    assert fr_p.names == ["x0", "x1", "x2", "x3", "x4", "x5", "c", "y"]


def _anova_scores_with_the_full_model(anova):
    kind, m_r, fr_r, m_p, fr_p = anova
    key = "p1" if kind == "binomial" else "predict"
    with _one_device():
        s_r = m_r._score_raw(fr_r)[key]
    # the caller's frame, without the products: the model makes them
    s_p = m_p._score_raw(fr_p)[key]
    np.testing.assert_allclose(s_p, s_r, rtol=0, atol=1e-5)
    assert fr_p.names == ["x0", "x1", "x2", "x3", "x4", "x5", "c", "y"]
    from h2o3_tpu_torch.models.model_selection import with_products
    work = with_products(fr_p, [("x0", "x1"), ("x0", "x5"), ("x1", "x5")])
    m_c = anovaglm_model_from_arrays(dict(
        full=_glm_arrays(m_r.full_model), output=dict(m_r.output),
        params=dict(m_r.params)))
    # the same coefficients: float32 products in another order
    np.testing.assert_allclose(m_c._score_raw(work)[key], s_r, rtol=1e-6,
                               atol=1e-6)
    assert m_c.anova_table == m_r.anova_table


def test_anova_cv_stays_unported_as_the_reference_fails_it():
    """The reference's ANOVA-GLM with nfolds=3 fails: its fold frames are
    subsets of the caller's columns, without the products the fit added
    (KeyError 'x0:x1'). The port raises NotImplementedError."""
    cols = sel_cols("gaussian", n=300, seed=5)
    fr_r, _ = _frames(cols)
    with _one_device(), pytest.raises(KeyError, match="x0:x1"):
        ref_ms.ANOVAGLMEstimator(nfolds=3, seed=1).train(
            fr_r, y="y", x=["x0", "x1"])
    for kw in (dict(nfolds=3), dict(fold_column="f"),
               dict(fold_assignment="modulo")):
        with pytest.raises(NotImplementedError, match="ROADMAP C"):
            h2o3_tpu_torch.ANOVAGLMEstimator(**kw)


def test_wrapper_parameters():
    e = h2o3_tpu_torch.ModelSelectionEstimator(Lambda=0.0,
                                               p_values_threshold=0.01)
    assert e.params["p_values_threshold"] == 0.01       # inert
    with pytest.raises(ValueError, match="unknown ModelSelection params"):
        h2o3_tpu_torch.ModelSelectionEstimator(bogus=1)
    with pytest.raises(ValueError, match="unknown ANOVAGLM params"):
        h2o3_tpu_torch.ANOVAGLMEstimator(bogus=1)
    fr = h2o3_tpu_torch.Frame.from_numpy(
        {f"x{i}": np.zeros(4) for i in range(17)} | {"y": np.arange(4.0)},
        device="cpu")
    with pytest.raises(ValueError, match="allsubsets"):
        h2o3_tpu_torch.ModelSelectionEstimator(mode="allsubsets").train(
            fr, y="y")


def test_anova_against_the_reference(anova):
    """The ANOVA table, the caller's frame and scoring (one test a
    fitted case, so that under xdist each reference fit runs once)."""
    _anova_table(anova)
    _anova_leaves_the_callers_frame_alone(anova)
    _anova_scores_with_the_full_model(anova)
