"""Data-parallel GLM and DeepLearning: the port's fits on W = 2 gloo
ranks, each holding only its own rows of a partitioned frame, held three
ways (as tests/test_torch_global_fit_trees.py holds the trees):

- GLM (IRLSM, L-BFGS, COD, ADMM at a fixed lambda, a lambda search with
  ADMM; binomial, gamma, gaussian, poisson) against the port's world-1
  fit and the reference's fit on a data = 2 CPU mesh, within
  tests/test_torch_glm.py's tolerances (``COEF_TOL`` 1e-4 of
  max(1, |c|), 2e-3 for L-BFGS): the all-reduced Gram and sums follow
  another order, as a row permutation does;
- DeepLearning (Rectifier and Tanh, with and without dropout) against
  the port's world-1 fit within tests/test_torch_deeplearning.py's
  tolerances (``WEIGHT_TOL`` 2e-6 of max(1, max|W|), ``PROB_TOL`` and
  ``METRIC_TOL`` 1e-5), and, from the reference's initial weights,
  against the reference's fit on a data = 2 mesh (the dropout fits draw
  the port's masks, so only world 1 compares). A step whose batch lies
  on one rank is one device's step bit for bit; the batch across the
  ranks' boundary within ``STEP_TOL``;
- rank against rank: the same coefficients or net bit for bit, and
  ``predict`` partitioned like its input.

The ranks run once for the module (``tests/torch_ranks.py``) while this
process fits the reference and the world-1 port."""

import pickle

import jax
import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import glm as ref_glm
from h2o3_tpu.models.deeplearning import \
    DeepLearningEstimator as RefDeepLearning
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.models import deeplearning as dl

import torch_ranks as tr
from test_torch_deeplearning import (METRIC_TOL, PROB_TOL, STEP_TOL,
                                     WEIGHT_TOL, ref_init, weight_gap)
from test_torch_glm import COEF_TOL, assert_coefs
from torch_threads import one_torch_thread  # noqa: F401 - autouse

GLM_TOL = {"gaussian_lbfgs": 2e-3}
DL_REF_CASES = [c for c, v in tr.DL_CASES.items() if v[2]]
ALL_CASES = ["glm_" + c for c in tr.GLM_CASES] + \
    ["dl_" + c for c in tr.DL_CASES]
DL_ROWS_RANK0 = 2000    # dl_cols' 4,000 rows over two ranks


def _on_data2(fn):
    old = ref_mesh.get_mesh()
    try:
        ref_mesh.set_global_mesh(ref_mesh.make_mesh(jax.devices("cpu")[:2],
                                                    2, 1))
        return fn()
    finally:
        ref_mesh.set_global_mesh(old)


def _ref_glm(case):
    make, params = tr.GLM_CASES[case]
    cols, cats = make()

    def fit():
        fr = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
        return ref_glm.GLMEstimator(**params).train(fr, y="y")
    return _on_data2(fit)


def _dl_frame(case):
    return h2o3_tpu_torch.Frame.from_numpy(tr.dl_cols(tr.DL_CASES[case][3]),
                                           device="cpu")


def _dl_init(case, fr):
    """The reference's initial weights of the case's net."""
    y, params = tr.DL_CASES[case][:2]
    t = h2o3_tpu_torch.DeepLearningEstimator(**params).prepare(fr, tr.DL_X,
                                                              y)
    sizes = [t.X.shape[1]] + list(params["hidden"]) + \
        [t.net[-1]["W"].shape[1]]
    return [{k: np.asarray(l[k]) for k in ("W", "b")}
            for l in ref_init(params["seed"], sizes, False)]


def _ref_dl(case):
    y, params, _, n = tr.DL_CASES[case]
    cols = tr.dl_cols(n)

    def fit():
        fr = h2o3_tpu.Frame.from_numpy(cols)
        m = RefDeepLearning(**params).train(fr, y=y, x=tr.DL_X)
        return m, m._score_raw(fr)
    return _on_data2(fit)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("glm_dl")
    dl_frs = {c: _dl_frame(c) for c in tr.DL_CASES}
    inits = {c: _dl_init(c, dl_frs[c]) for c in DL_REF_CASES}
    with open(run_dir / "input.pkl", "wb") as f:
        pickle.dump({"dl_init": inits}, f)
    join = tr.start_ranks("glm_dl", run_dir)
    refs = {"glm_" + c: _ref_glm(c) for c in tr.GLM_CASES}
    refs.update({"dl_" + c: _ref_dl(c) for c in DL_REF_CASES})
    ports = {}
    for case, (make, params) in tr.GLM_CASES.items():
        cols, cats = make()
        fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                             device="cpu")
        m = h2o3_tpu_torch.GLMEstimator(**params).train(fr, y="y")
        ports["glm_" + case] = (m, m._score_raw(fr))
    draw = dl.init_params
    try:
        for case, (y, params, ref, _) in tr.DL_CASES.items():
            dl.init_params = (tr.dl_from_weights(inits[case]) if ref
                              else draw)
            est = h2o3_tpu_torch.DeepLearningEstimator(**params)
            m = est.train(dl_frs[case], y=y, x=tr.DL_X)
            ports["dl_" + case] = (m, m._score_raw(dl_frs[case]))
            if case == tr.DL_REPLAY_CASE:
                ports["replay"] = tr.dl_replay(est, dl_frs[case], y,
                                               tr.DL_REPLAY)
    finally:
        dl.init_params = draw
    return refs, ports, join()


def _scores_close(got, want, tol, label):
    assert set(got) == set(want), label
    classes = "p0" in want
    for k in want:
        g, w = (np.asarray(v, np.float64) for v in (got[k], want[k]))
        if k == "predict" and classes:
            # class labels agree except at a probability tie
            assert (g != w).mean() <= 0.002, (label, k)
            continue
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"{label}: {k}")


@pytest.mark.parametrize("case", list(tr.GLM_CASES))
def test_two_rank_glm_equals_world_one_fit(fits, case):
    _, ports, ranks = fits
    m_p, raw = ports["glm_" + case]
    tol = GLM_TOL.get(case, COEF_TOL)
    for r, res in enumerate(ranks):
        c = res["glm_" + case]
        assert_coefs(c["coefs"], m_p.coefficients, tol=tol,
                     label=f"rank {r} {case}")
        for k in ("AUC", "logloss", "MSE", "mean_residual_deviance"):
            if k in c["metrics"]:
                assert c["metrics"][k] == pytest.approx(
                    m_p.training_metrics[k], rel=tol, abs=tol), k
        assert c["metrics"]["nobs"] == m_p.training_metrics["nobs"]
        # a score sums a row's ~10 design values times coefficients each
        # within ``tol`` (a log link makes that a relative gap)
        _scores_close(c["raw"], raw, 10 * tol, f"rank {r} {case}")
        if c["path"] is not None:
            np.testing.assert_allclose(c["lambdas"], m_p._lambda_path_vals,
                                       rtol=1e-5)
            np.testing.assert_allclose(c["path"], m_p._coef_path, rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("case", list(tr.GLM_CASES))
def test_two_rank_glm_equals_reference_data2_fit(fits, case):
    refs, _, ranks = fits
    m_r = refs["glm_" + case]
    tol = GLM_TOL.get(case, COEF_TOL)
    for r, res in enumerate(ranks):
        c = res["glm_" + case]
        assert_coefs(c["coefs"], m_r.coefficients, tol=tol,
                     label=f"rank {r} {case} vs the reference")
        key = "AUC" if "AUC" in c["metrics"] else "mean_residual_deviance"
        assert c["metrics"][key] == pytest.approx(
            m_r.training_metrics[key], rel=tol)
        if c["path"] is not None:
            np.testing.assert_allclose(c["lambdas"], m_r._lambda_path_vals,
                                       rtol=1e-5)
            np.testing.assert_allclose(c["path"], np.asarray(m_r._coef_path),
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("case", list(tr.DL_CASES))
def test_two_rank_dl_equals_world_one_fit(fits, case):
    _, ports, ranks = fits
    m_p, raw = ports["dl_" + case]
    for r, res in enumerate(ranks):
        c = res["dl_" + case]
        assert c["steps"] == m_p._steps_trained
        assert [h["step"] for h in c["history"]] == \
            [h["step"] for h in m_p.output["scoring_history"]]
        assert weight_gap(c["net"], m_p.net) <= WEIGHT_TOL, r
        for k in ("MSE", "logloss", "AUC", "r2", "mean_per_class_error"):
            if k in c["metrics"]:
                assert c["metrics"][k] == pytest.approx(
                    m_p.training_metrics[k], rel=METRIC_TOL,
                    abs=METRIC_TOL), k
        assert c["metrics"]["nobs"] == m_p.training_metrics["nobs"]
        _scores_close(c["raw"], raw, PROB_TOL, f"rank {r} {case}")


@pytest.mark.parametrize("case", DL_REF_CASES)
def test_two_rank_dl_equals_reference_data2_fit(fits, case):
    refs, _, ranks = fits
    m_r, raw_r = refs["dl_" + case]
    for r, res in enumerate(ranks):
        c = res["dl_" + case]
        assert c["steps"] == m_r._steps_trained
        assert weight_gap(c["net"], m_r.net) <= WEIGHT_TOL, r
        assert c["metrics"]["nobs"] == m_r.training_metrics["nobs"]
        _scores_close(c["raw"], raw_r, PROB_TOL, f"rank {r} {case}")


def test_dl_steps_on_one_rank_are_one_devices_bit_for_bit(fits):
    """Of the dropout fit on 4,000 rows, the first 15 batches (128 rows
    each, their dropout masks drawn whole on every rank) lie on rank 0:
    after each of those steps both ranks hold the world-1 net bit for
    bit; the 16th batch, rows [1920, 2048), straddles the ranks'
    boundary at 2000: its gradient is summed in another order, within
    ``STEP_TOL``."""
    _, ports, ranks = fits
    want = ports["replay"]
    batch = 128
    on_one = DL_ROWS_RANK0 // batch
    assert on_one == 15
    for r, res in enumerate(ranks):
        got = res["dl_" + tr.DL_REPLAY_CASE]["replay"]
        for k in range(on_one):
            for lg, lw in zip(got[k], want[k]):
                for key in ("W", "b"):
                    np.testing.assert_array_equal(
                        lg[key], lw[key], err_msg=f"rank {r} step {k}")
        assert weight_gap(got[on_one], want[on_one]) <= STEP_TOL


@pytest.mark.parametrize("case", ALL_CASES)
def test_every_rank_holds_the_same_model(fits, case):
    _, _, (a, b) = fits
    if case.startswith("glm_"):
        np.testing.assert_array_equal(a[case]["coef"], b[case]["coef"])
    else:
        for la, lb in zip(a[case]["net"], b[case]["net"]):
            for k in ("W", "b"):
                np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert a[case]["metrics"] == b[case]["metrics"]
    for k, v in a[case]["raw"].items():
        np.testing.assert_array_equal(v, b[case]["raw"][k], err_msg=k)
    coll = a[case]["collectives"]
    assert coll["all_reduce"] > 0 and coll["bytes"] > 0


@pytest.mark.parametrize("case", ALL_CASES)
def test_predict_is_partitioned_like_its_input(fits, case):
    _, _, ranks = fits
    for res in ranks:
        c = res[case]
        lo, hi = c["span"]
        n = len(c["raw"]["predict"])
        nl = max(min(hi, n) - lo, 0)
        for col, full in c["raw"].items():
            full = np.asarray(full, np.float64)
            np.testing.assert_allclose(c["pred"][col], full, rtol=1e-6,
                                       err_msg=col)
            assert c["pred_local"][col].shape == (hi - lo,)
            np.testing.assert_allclose(c["pred_local"][col][:nl],
                                       full[lo:lo + nl], rtol=1e-6,
                                       err_msg=col)
        # model_performance on the training frame = training metrics
        for k in ("AUC", "MSE", "logloss"):
            if k in c["metrics"]:
                assert c["perf"][k] == pytest.approx(c["metrics"][k],
                                                     rel=1e-6, abs=1e-9)
