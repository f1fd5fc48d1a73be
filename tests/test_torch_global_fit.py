"""Data-parallel GBM (binomial, gaussian and multinomial): the port's fit
on W = 2 gloo ranks, each holding only its own rows of a partitioned
frame (``Frame.from_numpy_partitioned`` → ``GBMEstimator.train`` →
``predict`` / ``training_metrics``), against the reference
``GBMEstimator`` on a data = 2 mesh and against the port's own world-1
fit.

Sampling is off and the data is tie-free (tests/test_torch_gbm.py's and
tests/torch_ranks.py's columns; row counts that do not split evenly): forests' integer fields
EXACTLY equal, leaf values within rtol 1e-5, training metrics and
predictions within 1e-5. Every rank must hold the same forest bit for
bit. A reference model carried across (``models/convert.py``) scores the
partitioned frame as the reference scores the whole. The ranks run once
for the module (``tests/torch_ranks.py``, a 120 s join timeout)."""

import pickle

import jax
import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.parallel import mesh as mesh_mod

import torch_ranks as tr
from test_torch_gbm import INT_FIELDS, _ref_arrays
from torch_threads import one_torch_thread  # noqa: F401 - autouse

METRICS = {"binomial": ("AUC", "logloss", "MSE"),
           "gaussian": ("MSE", "mae", "mean_residual_deviance", "r2"),
           "multinomial": ("logloss", "MSE", "AUC", "mean_per_class_error"),
           "binomial_offset_monotone": ("AUC", "logloss", "MSE")}


def _ref_fit(case):
    make, extra = tr.FIT_CASES[case]
    cols, cats = make()
    old = ref_mesh.get_mesh()
    try:
        ref_mesh.set_global_mesh(ref_mesh.make_mesh(jax.devices("cpu")[:2],
                                                    2, 1))
        fr = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
        m = RefGBM(**tr.FIT_PARAMS, **extra).train(fr, y="y")
        pred = m.predict(fr)
        return m, _pred({c: pred.col(c).to_numpy() for c in pred.names},
                        case)
    finally:
        ref_mesh.set_global_mesh(old)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("fit")
    refs = {case: _ref_fit(case) for case in tr.FIT_CASES}
    with open(run_dir / "input.pkl", "wb") as f:
        pickle.dump({c: _ref_arrays(m) for c, (m, _) in refs.items()}, f)
    ports = {}
    for case, (make, extra) in tr.FIT_CASES.items():
        cols, cats = make()
        fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                             device="cpu")
        ports[case] = (h2o3_tpu_torch.GBMEstimator(
            **tr.FIT_PARAMS, **extra).train(fr, y="y"), fr)
    return refs, ports, tr.run_ranks("fit", run_dir)


def _assert_forest(forest, want, label):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(forest[f], want[f],
                                      err_msg=f"{label}: field '{f}'")
    for f in ("leaf", "leaf_w"):
        np.testing.assert_allclose(forest[f], want[f], rtol=1e-5, atol=1e-7,
                                   err_msg=f"{label}: {f}")


def _pred(raw, case):
    """What a case predicts: p1, the class probabilities [N, K], or the
    response."""
    if case == "multinomial":
        return np.stack([raw[f"p{k}"] for k in range(len(raw) - 1)], 1)
    return raw["p1"] if case.startswith("binomial") else raw["predict"]


@pytest.mark.parametrize("case", list(tr.FIT_CASES))
def test_two_rank_fit_equals_reference_data2_fit(fits, case):
    refs, _, ranks = fits
    m_r, p_r = refs[case]
    want = {f: np.asarray(getattr(m_r.forest, f)) for f in
            m_r.forest._fields}
    for r, res in enumerate(ranks):
        got = dict(res[case]["forest"])
        got["left_words"] = got["left_words"].view(np.uint32)
        _assert_forest(got, want, f"rank {r}")
        for k in METRICS[case]:
            assert res[case]["metrics"][k] == pytest.approx(
                m_r.training_metrics[k], rel=1e-5, abs=1e-5), (r, k)
        np.testing.assert_allclose(_pred(res[case]["raw"], case), p_r,
                                   rtol=1e-5, atol=1e-5)
    assert ranks[0][case]["forest"]["is_split"].any()
    if case == "binomial":
        assert ranks[0][case]["forest"]["cat_split"].any()
        assert ranks[0][case]["output"]["default_threshold"] == \
            m_r.output["default_threshold"]


@pytest.mark.parametrize("case", list(tr.FIT_CASES))
def test_two_rank_fit_equals_world_one_fit(fits, case):
    _, ports, ranks = fits
    m_p, fr = ports[case]
    want = {f: getattr(m_p.forest, f).numpy() for f in m_p.forest._fields}
    raw = m_p._score_raw(fr)
    for res in ranks:
        _assert_forest(res[case]["forest"], want, "world 1")
        for k in METRICS[case]:
            assert res[case]["metrics"][k] == pytest.approx(
                m_p.training_metrics[k], rel=1e-5, abs=1e-5), k
        assert res[case]["output"].get("init_f") == m_p.output.get("init_f")
        np.testing.assert_array_equal(res[case]["f0"], np.asarray(m_p.f0))
        assert [v[0] for v in res[case]["output"]["varimp"]] == \
            [v[0] for v in m_p.output["varimp"]]
        np.testing.assert_allclose(_pred(res[case]["raw"], case),
                                   _pred(raw, case), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", list(tr.FIT_CASES))
def test_every_rank_holds_the_same_model(fits, case):
    _, _, (a, b) = fits
    for f, v in a[case]["forest"].items():
        np.testing.assert_array_equal(v, b[case]["forest"][f], err_msg=f)
    assert a[case]["metrics"] == b[case]["metrics"]
    assert a[case]["perf"] == b[case]["perf"]
    for k, v in a[case]["raw"].items():
        np.testing.assert_array_equal(v, b[case]["raw"][k], err_msg=k)


@pytest.mark.parametrize("case", list(tr.FIT_CASES))
def test_predict_is_partitioned_like_its_input(fits, case):
    _, _, ranks = fits
    for res in ranks:
        c = res[case]
        lo, hi = c["span"]
        n = len(c["raw"]["predict"])
        nl = max(min(hi, n) - lo, 0)
        for col, full in c["raw"].items():
            np.testing.assert_allclose(c["pred"][col], full, rtol=1e-6,
                                       err_msg=col)
            assert c["pred_local"][col].shape == (hi - lo,)
            np.testing.assert_allclose(c["pred_local"][col][:nl],
                                       full[lo:lo + nl], rtol=1e-6,
                                       err_msg=col)
        # model_performance on the training frame = training metrics
        for k in METRICS[case]:
            assert c["perf"][k] == pytest.approx(c["metrics"][k], abs=1e-9)


@pytest.mark.parametrize("case", list(tr.FIT_CASES))
def test_carried_reference_model_scores_partitioned_frame(fits, case):
    refs, _, ranks = fits
    m_r, p_r = refs[case]
    for res in ranks:
        conv = res[case]["converted"]
        np.testing.assert_allclose(_pred(conv["raw"], case), p_r, atol=1e-6)
        for k in METRICS[case]:
            assert conv["perf"][k] == pytest.approx(
                m_r.training_metrics[k], rel=1e-5, abs=1e-5), k


def test_sampled_fit_holds_one_forest_on_every_rank(fits):
    """Row sampling draws per (seed, tree, rank), column sampling per
    (seed, tree): the ranks still grow the same trees, and a tree's
    column mask really dropped columns."""
    _, _, (a, b) = fits
    for f, v in a["sampled"].items():
        np.testing.assert_array_equal(v, b["sampled"][f], err_msg=f)
    feat, split = a["sampled"]["feat"], a["sampled"]["is_split"]
    assert split.any()
    assert min(len(set(feat[t][split[t]].tolist()))
               for t in range(feat.shape[0])) < 5


def test_unported_estimators_raise_on_a_partitioned_frame():
    """What is queued for ROADMAP A #12′ raises on a partitioned frame and
    names it: estimators not ported to one (KMeans, CoxPH), the scoring
    surface (a DRF's TreeSHAP) and cross-validation of the ported GLM
    and DRF. No path gathers the rows to one rank to train."""
    cols, cats = tr.mixed_cols(n=64)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    model = h2o3_tpu_torch.DRFEstimator(ntrees=1, max_depth=2).train(
        fr, y="y")
    fr.mesh = mesh_mod.Mesh(None, None, 0, 2)       # as if sharded
    for fn in (lambda: h2o3_tpu_torch.KMeansEstimator(k=2).train(fr),
               lambda: h2o3_tpu_torch.CoxPHEstimator(
                   stop_column="x0").train(fr, y="y"),
               lambda: model.predict_contributions(fr),
               lambda: h2o3_tpu_torch.GLMEstimator(nfolds=2).train(
                   fr, y="y"),
               lambda: h2o3_tpu_torch.DRFEstimator(nfolds=2).train(
                   fr, y="y")):
        with pytest.raises(NotImplementedError,
                           match="sharded mesh.*ROADMAP A #12′"):
            fn()


@pytest.mark.parametrize("param", ["nfolds", "checkpoint", "calibrate_model",
                                   "max_runtime_secs"])
def test_local_only_gbm_parameters_raise_on_a_partitioned_frame(param):
    """Cross-validation and a checkpoint need fold masks or a donor on
    every rank, calibration scores a frame of its own, and ranks reading
    a wall-clock cap on their own clocks would stop at different trees:
    on a partitioned frame each raises."""
    cols, cats = tr.mixed_cols(n=64)
    fr = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                         device="cpu")
    donor = h2o3_tpu_torch.GBMEstimator(ntrees=1, max_depth=2).train(
        fr, y="y")
    value = {"nfolds": 3, "checkpoint": donor, "calibrate_model": True,
             "max_runtime_secs": 10.0}[param]
    fr.mesh = mesh_mod.Mesh(None, None, 0, 2)       # as if sharded
    with pytest.raises(NotImplementedError, match=f"'{param}' on a frame "
                                                  "partitioned"):
        h2o3_tpu_torch.GBMEstimator(ntrees=2, **{param: value}).train(
            fr, y="y")
