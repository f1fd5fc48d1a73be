"""PSVM in the PyTorch port (on the CPU) against the reference package.

``icf`` run by both packages on the reference's own standardized design
picks the same pivots (EXACT) on the tests' data, whose residual
diagonals stay apart: after the first step (all 1, where both take row
0) the largest two differ by at least 3.6e-5, far above the ~1e-7
rounding of the float32 GEMVs, and V agrees within 1e-5 (GEMVs of up to
24 terms added in another order).

Whole fits: a row permutation moves the decision values by O(1) in
either package (the first pivot is row 0), so it gives no tolerance; the
fits on the same rows agree far closer: ``w_b`` within 1e-4, the
decision values within 1e-4, AUC within 1e-5 and ``svs_count`` and
``bsv_count`` EXACTLY (seen: 7e-6, 5e-6, 4e-6 and equal). A reference
model carried across scores its decision values within 1e-5. The
reference's fits run on a one-device mesh (``_one_device``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.frame.datainfo import build_datainfo as ref_datainfo
from h2o3_tpu.models import psvm as ref_psvm
from h2o3_tpu_torch.models import psvm as port_psvm
from h2o3_tpu_torch.models.convert import psvm_model_from_arrays

from test_torch_isofor import _one_device
from torch_threads import one_torch_thread  # noqa: F401 - autouse

WB_TOL = 1e-4
DEC_TOL = 1e-4
AUC_TOL = 1e-5


def svm_cols(n=601, seed=3, weights=False):
    """A nonlinear two-class boundary in x0, x1 with a categorical
    shift; x2, x3 are noise."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 4)
    c = r.randint(0, 3, n)
    f = np.sin(2 * X[:, 0]) + X[:, 1] ** 2 - 1 + 0.5 * (c == 2) \
        + 0.3 * r.randn(n)
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "x3": X[:, 3],
            "c": np.array(["u", "v", "w"])[c],
            "y": np.where(f > 0, "pos", "neg")}
    if weights:
        cols["w"] = np.where(r.rand(n) < 0.1, 0.0, r.uniform(0.5, 2, n))
    return cols


def test_icf_pivots_exact_and_v_close():
    cols = svm_cols()
    x = ["x0", "x1", "x2", "x3", "c"]
    with _one_device():
        fr = h2o3_tpu.Frame.from_numpy(cols)
        X = np.asarray(ref_datainfo(fr, x, standardize=True,
                                    use_all_factor_levels=True).X)
        w = np.asarray(fr.valid_weights()).astype(np.float32)
        V_r, piv_r, rank_r = ref_psvm.icf(jnp.asarray(X), jnp.asarray(w),
                                          1 / 7, 24)
    V_p, piv_p, rank_p = port_psvm.icf(torch.from_numpy(X.copy()),
                                       torch.from_numpy(w), 1 / 7, 24)
    assert rank_p == rank_r == 24
    np.testing.assert_array_equal(piv_p, piv_r)
    assert piv_p[0] == 0
    np.testing.assert_allclose(V_p.numpy(), np.asarray(V_r), rtol=0,
                               atol=1e-5)


CASES = {"defaults": ({}, {}),
         "weights_class_weights_rank_gamma": (
             dict(weights=True),
             dict(weights_column="w", positive_weight=2.0,
                  negative_weight=0.5, rank_ratio=0.05, gamma=0.3,
                  hyper_param=0.5))}


@functools.lru_cache(maxsize=None)
def _fit(case):
    data_kw, kw = CASES[case]
    cols = svm_cols(**data_kw)
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols)
        m_r = ref_psvm.PSVMEstimator(**kw).train(fr_r, y="y")
        s_r = m_r._score_raw(fr_r)
    fr_p = h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu")
    m_p = h2o3_tpu_torch.PSVMEstimator(**kw).train(fr_p, y="y")
    return m_r, s_r, m_p, fr_p


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_reference(case):
    m_r, s_r, m_p, fr_p = _fit(case)
    for k in ("rank", "gamma", "svs_count", "bsv_count", "domain",
              "names"):
        assert m_p.output[k] == m_r.output[k], k
    np.testing.assert_allclose(m_p.w_b, m_r.w_b, rtol=0, atol=WB_TOL)
    s_p = m_p._score_raw(fr_p)
    np.testing.assert_allclose(s_p["decision_function"],
                               s_r["decision_function"], rtol=0,
                               atol=DEC_TOL)
    agree = s_p["predict"] == s_r["predict"]
    assert agree.all() or np.abs(s_r["decision_function"][~agree]).max() \
        < DEC_TOL
    assert m_p.training_metrics["AUC"] == pytest.approx(
        m_r.training_metrics["AUC"], abs=AUC_TOL)
    assert m_p.training_metrics["AUC"] > 0.8
    pred = m_p.predict(fr_p)
    assert pred.col("predict").domain == ["neg", "pos"]


def test_reference_model_carried_across_scores_alike():
    m_r, s_r, _, fr_p = _fit("defaults")
    m_c = psvm_model_from_arrays(dict(
        w_b=m_r.w_b, pivot_rows=m_r.pivot_rows, Linv_t=m_r.Linv_t,
        gamma=m_r.gamma, di_stats=m_r.di_stats, features=m_r.features,
        output=dict(m_r.output), params=dict(m_r.params)))
    s_c = m_c._score_raw(fr_p)
    np.testing.assert_allclose(s_c["decision_function"],
                               s_r["decision_function"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(s_c["p1"], s_r["p1"], rtol=0, atol=1e-5)


def test_response_and_kernel_checks():
    cols = svm_cols(n=200)
    cols["y3"] = np.array(["a", "b", "c"])[np.arange(200) % 3]
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu")
    with pytest.raises(ValueError, match="binary categorical"):
        h2o3_tpu_torch.PSVMEstimator().train(fr, y="y3", x=["x0", "x1"])
    with pytest.raises(ValueError, match="binary categorical"):
        h2o3_tpu_torch.PSVMEstimator().train(fr, y="x3", x=["x0", "x1"])
    with pytest.raises(ValueError, match="gaussian"):
        h2o3_tpu_torch.PSVMEstimator(kernel_type="linear")
    with pytest.raises(NotImplementedError, match="nfolds"):
        h2o3_tpu_torch.PSVMEstimator(nfolds=3)
