"""Grid search and the Leaderboard (``h2o3_tpu_torch/ml/grid.py``,
``ml/leaderboard.py``) against the reference's (``h2o3_tpu/ml``).

The walk's plan is the reference's: the same combos in the same order
for Cartesian and RandomDiscrete (seeds 1 and 42), the same
``stop_early_windowed`` verdicts on seeded score sequences. A 4-combo
GLM grid (alpha x lambda, 3,000 rows) gives every model's coefficients
within COEF_TOL (``tests/test_torch_glm.py``'s) of the reference's
sequential walk (its model batching off, ``H2O3TPU_BATCH_MODELS=off``,
as ``tests/test_model_batch.py`` runs it), in the same sorted order;
an invalid combo is recorded as the same failure in both. The budgets:
``max_models`` counts successes only, asymptotic stopping ends the walk
where the reference's does.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch as h2o
from h2o3_tpu.ml import grid as ref_grid
from h2o3_tpu.ml.leaderboard import Leaderboard as RefLeaderboard
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu.models.glm import GLMEstimator as RefGLM
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.ml import grid
from h2o3_tpu_torch.ml.leaderboard import Leaderboard

COEF_TOL = 1e-4
HYPER = {"learn_rate": [0.05, 0.08, 0.1, 0.15], "sample_rate": [0.7, 1.0],
         "min_rows": [5.0, 20.0], "max_depth": [3, 3, 5]}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _one_device():
    """The reference's fits on a one-device mesh."""
    token = ref_mesh._MESH_OVERRIDE.set(
        ref_mesh.make_mesh(jax.devices()[:1]))
    try:
        yield
    finally:
        ref_mesh._MESH_OVERRIDE.reset(token)


def _cols(n=3000, seed=0):
    r = np.random.RandomState(seed)
    X = r.randn(n, 4)
    logit = X @ np.array([1.0, -0.8, 0.5, 0.0]) + 0.3
    y = (r.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["y"] = np.array(["N", "Y"], dtype=object)[y]
    return cols


def _frames(cols):
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=["y"]),
            h2o.Frame.from_numpy(cols, device="cpu"))


@pytest.mark.parametrize("criteria", [
    None, {"strategy": "Cartesian"},
    {"strategy": "RandomDiscrete", "seed": 1},
    {"strategy": "RandomDiscrete", "seed": 42, "max_models": 5}])
def test_combos_equal_the_reference(criteria):
    port = grid.GridSearch(h2o.GBMEstimator, HYPER,
                           search_criteria=criteria)._combos()
    ref = ref_grid.GridSearch(RefGBM, HYPER,
                              search_criteria=criteria)._combos()
    assert port == ref
    assert len(port) == 4 * 2 * 2 * 2       # repeated values count once


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k,tol,less", [(1, 1e-3, True), (2, 1e-2, False),
                                        (3, 1e-3, True), (2, 0.0, True)])
def test_stop_early_windowed_equals_the_reference(seed, k, tol, less):
    r = np.random.RandomState(seed)
    base = np.cumsum(r.rand(20)) * (1 if less else -1) + 50
    scores = list(np.where(r.rand(20) < 0.5, base, base[0]))
    for n in range(1, len(scores) + 1):
        s = scores[:n]
        assert grid.stop_early_windowed(s, k, tol, less) == \
            ref_grid.stop_early_windowed(s, k, tol, less), (n, s)
    flat = [0.7] * 12
    assert grid.stop_early_windowed(flat, 3, 1e-3, False) == \
        ref_grid.stop_early_windowed(flat, 3, 1e-3, False) is True


def test_glm_grid_equals_the_reference_walk(monkeypatch):
    monkeypatch.setenv("H2O3TPU_BATCH_MODELS", "off")
    fr_r, fr_p = _frames(_cols())
    hyper = {"alpha": [0.0, 0.5], "lambda_": [1e-3, 1e-2]}
    fixed = dict(family="binomial", seed=1)
    with _one_device():
        g_r = ref_grid.GridSearch(RefGLM, hyper, **fixed).train(fr_r, y="y")
    g_p = grid.GridSearch(h2o.GLMEstimator, hyper, **fixed).train(fr_p,
                                                                  y="y")
    assert [m.output["grid_params"] for m in g_p.models] == \
        [m.output["grid_params"] for m in g_r.models]
    for mp, mr in zip(g_p.models, g_r.models):
        cp, cr = mp.coefficients, mr.coefficients
        assert set(cp) == set(cr)
        gap = max(abs(cp[k] - cr[k]) for k in cp)
        assert gap <= COEF_TOL, (mp.output["grid_params"], gap)
    assert [m.output["grid_params"] for m in g_p.sorted_models()] == \
        [m.output["grid_params"] for m in g_r.sorted_models()]
    assert g_p.sort_metric == g_r.sort_metric == "auc"
    assert [r["model_id"] for r in g_p.summary_table()] == \
        [m.key for m in g_p.sorted_models()]
    assert h2o.DKV.get(g_p.grid_id) is g_p


def test_failed_combo_recorded_as_in_the_reference(monkeypatch):
    monkeypatch.setenv("H2O3TPU_BATCH_MODELS", "off")
    fr_r, fr_p = _frames(_cols(800))
    hyper = {"family": ["binomial", "nope"], "lambda_": [1e-3, 1e-2]}
    crit = {"strategy": "RandomDiscrete", "seed": 3, "max_models": 2}
    with _one_device():
        g_r = ref_grid.GridSearch(RefGLM, hyper, search_criteria=crit
                                  ).train(fr_r, y="y")
    g_p = grid.GridSearch(h2o.GLMEstimator, hyper, search_criteria=crit
                          ).train(fr_p, y="y")
    assert g_p.failures == g_r.failures
    assert g_p.failures and all(f["error"] == "'nope'"
                                for f in g_p.failures)
    # max_models counts successes: the walk went past the failures
    assert len(g_p.models) == len(g_r.models) == 2
    assert [m.output["grid_params"] for m in g_p.models] == \
        [m.output["grid_params"] for m in g_r.models]


def test_asymptotic_stopping_and_budgets():
    """A flat walk stops after 2k+1 models, as the reference's; a spent
    budget trains nothing more."""
    fr = _frames(_cols(600))[1]
    hyper = {"lambda_": [1e-4, 1.1e-4, 1.2e-4, 1.3e-4, 1.4e-4, 1.5e-4,
                         1.6e-4, 1.7e-4]}
    crit = {"strategy": "Cartesian", "stopping_rounds": 2,
            "stopping_tolerance": 0.5}
    g = grid.GridSearch(h2o.GLMEstimator, hyper, search_criteria=crit,
                        family="binomial").train(fr, y="y")
    assert len(g.models) == 5
    g0 = grid.GridSearch(h2o.GLMEstimator, hyper, search_criteria={
        "max_runtime_secs": 1e-9}, family="binomial").train(fr, y="y")
    assert len(g0.models) <= 1
    with pytest.raises(NotImplementedError, match="A #13"):
        grid.GridSearch(h2o.GLMEstimator, hyper, recovery_dir="/nowhere")
    with pytest.raises(NotImplementedError, match="A #13"):
        grid.resume_grid("/nowhere", fr)


def test_leaderboard_sorts_as_the_reference():
    """GLMs of three lambdas rank in the same order on their
    cross-validation AUC, with the same table."""
    fr_r, fr_p = _frames(_cols(1500, seed=4))
    lb_r, lb_p = RefLeaderboard("t"), Leaderboard("t")
    for lam in (1e-4, 1e-2, 1e-1):
        with _one_device():
            mr = RefGLM(family="binomial", lambda_=lam, nfolds=2,
                        seed=1).train(fr_r, y="y")
        mp = h2o.GLMEstimator(family="binomial", lambda_=lam, nfolds=2,
                              seed=1).train(fr_p, y="y")
        mr.output["tag"] = mp.output["tag"] = lam
        lb_r.add(mr)
        lb_p.add(mp, mp)                     # a model counts once
    assert [m.output["tag"] for m in lb_p.sorted_models()] == \
        [m.output["tag"] for m in lb_r.sorted_models()]
    tp, tr = lb_p.as_table(), lb_r.as_table()
    assert [set(r) for r in tp] == [set(r) for r in tr]
    for a, b in zip(tp, tr):
        for k in a:
            if k != "model_id":
                assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-5), k
    assert lb_p.leader is lb_p.sorted_models()[0]
    assert "Leaderboard[t]" in repr(lb_p)
