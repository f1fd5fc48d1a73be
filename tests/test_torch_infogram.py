"""Infogram in the PyTorch port (on the CPU) against the reference
package.

The same seeded numpy frame (four continuous predictors, a categorical
with a level effect, a protected categorical tied to x1; a binomial
response; 2,000 rows) goes through both. Every model is a GBM that
samples nothing, so the two packages grow the same trees where the data
hold no near-tie split: seed 12 was taken after seed 11's core probe
without x1 parted by 2.5e-4 (a split flip), and the test asserts each
decision's clear margin to the thresholds (>= 0.02), so a flip would
fail here, not pass unseen. Relevance (scaled varimp) within 1e-5. The
raw CMI is a difference of two training loglosses (float64 means of
float32 terms, ~0.6 each, a float32 ulp 6e-8): held within ``CMI_TOL``
2e-6 absolute (the packages part by at most 3.2e-7), the scaled CMI
within ``CMI_TOL`` over the largest raw CMI. Admissible sets equal. The
reference's fits run on a one-device mesh.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import infogram as ref_ig
from h2o3_tpu.parallel import mesh as ref_mesh

REL_TOL = 1e-5
CMI_TOL = 2e-6
MARGIN = 0.02
THR = 0.1


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


def ig_cols(n=2000, seed=12):
    """y ~ logistic(1.6·x1 + x2 + 0.4·x3 + 0.8·[c = q]); x4 is noise; g
    (protected) follows x1."""
    r = np.random.RandomState(seed)
    x1, x2, x3, x4 = (r.uniform(-2, 2, n) for _ in range(4))
    g = (x1 + 0.7 * r.randn(n) > 0).astype(int) + (r.rand(n) < 0.3)
    c = r.randint(0, 4, n)
    eta = 1.6 * x1 + 1.0 * x2 + 0.4 * x3 + 0.8 * (c == 1)
    y = np.where(r.rand(n) < 1 / (1 + np.exp(-eta)), "yes",
                 "no").astype(object)
    return {"x1": x1, "x2": x2, "x3": x3, "x4": x4,
            "c": np.array(list("pqrs"), object)[c],
            "g": np.array(["u", "v", "w"], object)[g], "y": y}


CATS = ["c", "g", "y"]


@pytest.fixture(scope="module", params=["core", "fair"])
def fitted(request):
    kw = dict(seed=1)
    if request.param == "fair":
        kw["protected_columns"] = ["g"]
    cols = ig_cols()
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=CATS)
        m_r = ref_ig.InfogramEstimator(**kw).train(fr_r, y="y")
    fr_p = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=CATS,
                                           device="cpu")
    m_p = h2o3_tpu_torch.InfogramEstimator(**kw).train(fr_p, y="y")
    return request.param, m_r, m_p


def _relevance_and_cmi(fitted):
    kind, m_r, m_p = fitted
    t_r, t_p = m_r.output["infogram_table"], m_p.output["infogram_table"]
    assert [r["column"] for r in t_p] == [r["column"] for r in t_r]
    top = max(r["cmi_raw"] for r in t_r)
    for a, b in zip(t_r, t_p):
        assert b["relevance"] == pytest.approx(a["relevance"], abs=REL_TOL)
        assert b["cmi_raw"] == pytest.approx(a["cmi_raw"], abs=CMI_TOL)
        assert b["cmi"] == pytest.approx(a["cmi"], abs=CMI_TOL / top)
        assert b["admissible_index"] == pytest.approx(
            a["admissible_index"], abs=REL_TOL + CMI_TOL / top)
    names = [r["column"] for r in t_p]
    assert ("g" in names) == (kind == "core")
    assert m_p.output["gbm_fits"] == 2 + 5 + (kind == "core")


def _admissible_sets_with_clear_margins(fitted):
    kind, m_r, m_p = fitted
    for r in m_r.output["infogram_table"]:
        m = (min(r["relevance"], r["cmi"]) - THR if r["admissible"]
             else max(THR - r["relevance"], THR - r["cmi"]))
        assert m >= MARGIN, r
    assert m_p.admissible_features == m_r.admissible_features == \
        ["x1", "x2"]
    assert [r["admissible"] for r in m_p.output["infogram_table"]] == \
        [r["admissible"] for r in m_r.output["infogram_table"]]


def _admissible_score_frame(fitted):
    kind, m_r, m_p = fitted
    with _one_device():
        f_r = m_r.get_admissible_score_frame()
    f_p = m_p.get_admissible_score_frame()
    assert f_p.names == f_r.names
    assert f_p.col("column").domain == f_r.col("column").domain
    np.testing.assert_array_equal(f_p.col("column").to_numpy(),
                                  f_r.col("column").to_numpy())
    np.testing.assert_array_equal(f_p.col("admissible").to_numpy(),
                                  f_r.col("admissible").to_numpy())
    np.testing.assert_allclose(f_p.col("relevance_index").to_numpy(),
                               f_r.col("relevance_index").to_numpy(),
                               atol=REL_TOL)


def test_ntop_caps_the_probes():
    """ntop=2 probes the two most relevant predictors; the rest score cmi
    0, as in the reference."""
    cols = ig_cols()
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=CATS)
        m_r = ref_ig.InfogramEstimator(ntop=2, seed=1).train(fr_r, y="y")
    fr_p = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=CATS,
                                           device="cpu")
    m_p = h2o3_tpu_torch.InfogramEstimator(ntop=2, seed=1).train(fr_p,
                                                                 y="y")
    zero_r = {r["column"] for r in m_r.output["infogram_table"]
              if r["cmi_raw"] == 0}
    zero_p = {r["column"] for r in m_p.output["infogram_table"]
              if r["cmi_raw"] == 0}
    assert zero_p == zero_r and len(zero_p) >= 4
    assert m_p.output["gbm_fits"] == 4


def test_parameters_as_in_the_reference():
    with pytest.raises(ValueError, match="nfolds must be 0"):
        h2o3_tpu_torch.InfogramEstimator(nfolds=3)
    with pytest.raises(ValueError, match="nfolds must be 0"):
        ref_ig.InfogramEstimator(nfolds=3)
    with pytest.raises(NotImplementedError, match="fold_column"):
        h2o3_tpu_torch.InfogramEstimator(fold_column="f")
    with pytest.raises(ValueError, match="unknown Infogram params"):
        h2o3_tpu_torch.InfogramEstimator(bogus=1)
    from h2o3_tpu_torch.models.infogram import InfogramModel
    with pytest.raises(NotImplementedError, match="screening"):
        InfogramModel({}, {}, "cpu")._score_raw(None)


def test_infogram_against_the_reference(fitted):
    """Relevance, CMI, admissible sets and the score frame (one test a
    fitted case, so that under xdist each reference fit runs once)."""
    _relevance_and_cmi(fitted)
    _admissible_sets_with_clear_margins(fitted)
    _admissible_score_frame(fitted)
