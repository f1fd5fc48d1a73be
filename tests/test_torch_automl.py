"""AutoML (``h2o3_tpu_torch/automl``) against the reference's
(``h2o3_tpu/automl``).

The plan is the reference's, field by field, for several include and
exclude sets; the budget's per-model caps are its caps. End to end at
2,000 rows (``max_models=2, nfolds=2, seed=1``, GLM, GBM and the
StackedEnsembles) both packages train the same steps; GLM_1's CV AUC
agrees within 1e-4 (GLM is deterministic in both), GBM_1's within 0.02
(the packages' GBMs sample rows and columns from different random
streams), and the leaderboards rank alike wherever the reference's CV
AUCs of two rows lie more than 0.02 apart (closer rows may swap; the
test prints any swap). The reference's run trains on background job
threads, so its mesh is set to one device globally for the test
(``_one_device_global``) and its keys are left to the leak check's
opt-out (``allow_key_leak``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch as h2o
from h2o3_tpu.automl import H2OAutoML as RefAutoML
from h2o3_tpu.automl import executor as ref_executor
from h2o3_tpu.automl import steps as ref_steps
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch import automl
from h2o3_tpu_torch.automl import executor, steps
from h2o3_tpu_torch.models import tree as tree_mod

AUC_GAP = 0.02


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def _one_device_global(monkeypatch):
    """The reference's frames and fits, its job threads' too, on a
    one-device mesh."""
    monkeypatch.setattr(ref_mesh, "_GLOBAL_MESH",
                        ref_mesh.make_mesh(jax.devices()[:1]))


def _cols(n=2000, seed=1):
    r = np.random.RandomState(seed)
    X = r.randn(n, 5)
    logit = X[:, :3] @ np.array([1.0, -1.5, 0.8]) + 0.5 * np.sin(X[:, 3])
    y = (r.rand(n) < 1 / (1 + np.exp(-logit))).astype(int)
    cols = {f"x{i}": X[:, i] for i in range(5)}
    cols["y"] = np.array(["no", "yes"], dtype=object)[y]
    return cols


@pytest.mark.parametrize("include,exclude", [
    (None, None), (["glm", "gbm", "stackedensemble"], None),
    (None, ["deeplearning", "xgboost"]), (["drf", "xgboost"], ["drf"]),
    (["gbm"], ())])
@pytest.mark.parametrize("seed", [1, 5723])
def test_modeling_plan_equals_the_reference(include, exclude, seed):
    port = steps.modeling_plan(seed, include=include, exclude=exclude)
    ref = ref_steps.modeling_plan(seed, include=include, exclude=exclude)
    assert [dataclasses.asdict(s) for s in port] == \
        [dataclasses.asdict(s) for s in ref]
    assert port


def test_budget_caps_equal_the_reference():
    for args in ((20, 300.0, 0.0), (4, 0.0, 0.0), (0, 100.0, 30.0),
                 (10, 0.0, 0.02)):
        a, b = executor.Budget(*args), ref_executor.Budget(*args)
        for _ in range(3):
            ca, cb = a.model_cap(), b.model_cap()
            assert (ca is None) == (cb is None)
            if ca is not None:
                assert ca == pytest.approx(cb, abs=0.5)
            assert a.try_start() == b.try_start()
            a.finish(1)
            b.finish(1)
            assert (a.trained, a.exhausted(), a.remaining_models()) == \
                (b.trained, b.exhausted(), b.remaining_models())


@pytest.mark.allow_key_leak
def test_automl_end_to_end_against_the_reference(_one_device_global):
    cols = _cols()
    kw = dict(max_models=2, nfolds=2, seed=1,
              include_algos=["glm", "gbm", "stackedensemble"])
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=["y"])
    fr_p = h2o.Frame.from_numpy(cols, device="cpu")
    aml_r, aml_p = RefAutoML(**kw), h2o.H2OAutoML(**kw)
    aml_r.train(y="y", training_frame=fr_r)
    aml_p.train(y="y", training_frame=fr_p)
    for aml in (aml_r, aml_p):
        assert not [e for e in aml.event_log if e["stage"] == "error"]
    rows_r = [(m.output["automl_step"], m.default_metrics["AUC"])
              for m in aml_r.leaderboard.sorted_models()]
    rows_p = [(m.output["automl_step"], m.default_metrics["AUC"])
              for m in aml_p.leaderboard.sorted_models()]
    print("reference", rows_r)
    print("port     ", rows_p)
    assert {s for s, _ in rows_p} == {s for s, _ in rows_r}
    assert "StackedEnsemble_BestOfFamily" in {s for s, _ in rows_p}
    auc_r, auc_p = dict(rows_r), dict(rows_p)
    assert abs(auc_p["GLM_1"] - auc_r["GLM_1"]) <= 1e-4
    assert abs(auc_p["GBM_1"] - auc_r["GBM_1"]) <= AUC_GAP
    pos = {s: i for i, (s, _) in enumerate(rows_p)}
    for i, (a, va) in enumerate(rows_r):
        for b, vb in rows_r[i + 1:]:
            if va - vb > AUC_GAP:
                assert pos[a] < pos[b], (a, b)
            elif pos[a] > pos[b]:
                print(f"swap within {AUC_GAP}: {a} {va} / {b} {vb}")
    pred = aml_p.predict(fr_p)
    assert {"predict", "p0", "p1"} <= set(pred.names)
    tab = aml_p.leaderboard.as_table()
    assert [r["auc"] for r in tab] == sorted((r["auc"] for r in tab),
                                            reverse=True)


def test_train_capped_truncates_and_cancels():
    fr = h2o.Frame.from_numpy(_cols(1500), device="cpu")
    m = executor.train_capped(
        h2o.GBMEstimator(ntrees=400, max_depth=6, seed=1), fr, "y", None,
        executor.Budget(max_models=10, max_runtime_secs=0,
                        per_model_secs=0.02))
    assert 0 < m.forest.feat.shape[0] < 400
    # a builder without max_runtime_secs is cancelled at its cap, at a
    # job.update, and the step raises TimeoutError
    with pytest.raises(TimeoutError, match="max_runtime_secs_per_model"):
        executor.train_capped(
            h2o.DeepLearningEstimator(hidden=[64], epochs=10_000, seed=1),
            fr, "y", None, executor.Budget(10, 0, 0.3))


@pytest.mark.allow_key_leak
def test_target_encoding_adds_the_references_columns(_one_device_global):
    r = np.random.RandomState(3)
    cols = _cols(1200)
    cols["city"] = np.array([f"c{i}" for i in range(40)],
                            object)[r.randint(0, 40, 1200)]
    cols["tier"] = np.array(["a", "b"], object)[r.randint(0, 2, 1200)]
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=["y", "city",
                                                        "tier"])
    fr_p = h2o.Frame.from_numpy(cols, device="cpu")
    kw = dict(seed=1, preprocessing=["target_encoding"])
    enc_r, te_r = RefAutoML(**kw)._maybe_target_encode(fr_r, "y", None)
    enc_p, te_p = h2o.H2OAutoML(**kw)._maybe_target_encode(fr_p, "y", None)
    assert te_r is not None and te_p is not None
    added = sorted(set(enc_p.names) - set(fr_p.names))
    assert added == sorted(set(enc_r.names) - set(fr_r.names)) == \
        ["city_te"]
    plain, _ = h2o.H2OAutoML(seed=1)._maybe_target_encode(fr_p, "y", None)
    assert plain is fr_p


def test_events_budget_and_unported_paths(monkeypatch):
    """A step that raises is an ``error`` event and one cancelled at its
    cap a ``timeout`` event; the plan goes on. recovery_dir,
    resume_automl and a scheduled cloud raise, naming ROADMAP A #13 and
    A #12/#13."""
    fr = h2o.Frame.from_numpy(_cols(600), device="cpu")
    ran = []

    def flaky(aml, step, *a, **kw):
        ran.append(step.id)
        if step.id == "GLM_1":
            raise RuntimeError("no good")
        if step.id == "GBM_1":
            raise TimeoutError("max_runtime_secs_per_model (1s) exceeded")
        if step.id == "GBM_2":
            m = h2o.GLMEstimator(nfolds=2, seed=1).train(fr, y="y")
            m.output["automl_step"] = step.id
            return [m]
        return []

    monkeypatch.setattr(automl, "run_step", flaky)
    aml = h2o.H2OAutoML(max_models=3, nfolds=2, seed=1,
                        include_algos=["glm", "gbm"])
    aml.train(y="y", training_frame=fr)
    stages = [(e["stage"], e["message"]) for e in aml.event_log]
    assert ("error", "GLM_1 failed: no good") in stages
    assert ("timeout", "GBM_1: max_runtime_secs_per_model (1s) exceeded") \
        in stages
    assert ran == [s.id for s in steps.modeling_plan(1, {"glm", "gbm"})]
    assert [m.output["automl_step"] for m in aml.leaderboard.models] == \
        ["GBM_2"]
    assert stages[-1][0] == "done"
    with pytest.raises(NotImplementedError, match="A #13"):
        h2o.H2OAutoML(recovery_dir="/nowhere")
    with pytest.raises(NotImplementedError, match="A #13"):
        automl.resume_automl("/nowhere", fr)
    monkeypatch.setenv("H2O3TPU_SCHEDULER", "on")
    with pytest.raises(NotImplementedError, match="A #12/#13"):
        executor._train_plain(h2o.GLMEstimator, {}, fr, "y", None,
                              executor.Budget(1, 0, 0))


def test_deep_forest_keeps_its_nodes_without_padding(monkeypatch):
    """Past the last depth bucket a GBM keeps HeapTrees
    (``tree.keep_layout``): the grown Trees' nodes without their
    padding, scoring and explaining (``predict_contributions``, local
    accuracy included) bit for bit as the grown Trees do."""
    import h2o3_tpu_torch.models.gbm as gbm_mod
    fr = h2o.Frame.from_numpy(_cols(600), device="cpu")
    kw = dict(ntrees=2, max_depth=15, min_rows=1.0, seed=1)
    m = h2o.GBMEstimator(**kw).train(fr, y="y")
    assert isinstance(m.forest, tree_mod.HeapTree)
    assert tree_mod.tree_depth(m.forest) == 15
    assert m.forest.feat.shape == (2, 2 ** 15 - 1)
    monkeypatch.setattr(gbm_mod, "keep_layout", lambda t: t)
    grown = h2o.GBMEstimator(**kw).train(fr, y="y")
    assert isinstance(grown.forest, tree_mod.Tree)
    heap = tree_mod.to_heap(grown.forest)
    for f in tree_mod.HeapTree._fields:
        assert torch.equal(getattr(heap, f), getattr(m.forest, f)), f
    np.testing.assert_array_equal(m.predict(fr).col("p1").to_numpy(),
                                  grown.predict(fr).col("p1").to_numpy())
    head = h2o.Frame.from_numpy({k: v[:50] for k, v in _cols(600).items()},
                                device="cpu")
    c_heap = m.predict_contributions(head)
    c_grown = grown.predict_contributions(head)
    assert c_heap.names == c_grown.names
    for n in c_heap.names:
        np.testing.assert_array_equal(c_heap.col(n).to_numpy(),
                                      c_grown.col(n).to_numpy())
    total = sum(c_heap.col(n).to_numpy() for n in c_heap.names)
    p1 = m.predict(head).col("p1").to_numpy()
    np.testing.assert_allclose(1.0 / (1.0 + np.exp(-total)), p1,
                               atol=1e-5)
