"""Model-batched training of the port (``parallel/model_batch.py``,
``models/gbm.fit_gbm_batched``, ``models/glm.fit_glm_batched``, the
grid's ``_train_batched``) on the CPU, against the reference package and
against the port's own sequential fits.

The planner equals the reference's on parametrised combos. A GBM bucket
(learn_rate, min_rows, reg_lambda and max_depth vary inside depth bucket
6; sampling off, as the two packages draw from different generators)
gives the reference's batched forests: split fields EXACT on tie-free
data (seed 2), leaves within 1e-5, AUC within 1e-5. Against the port's
own sequential fits the batch is bit-equal, with sampling, seeds, early
stopping (models stop at different trees), constraints and a categorical
column; so is the model-axis level chain against the one-model chain.
GLM buckets hold each lane within COEF_TOL of the reference's batched
solve and of the port's sequential fit. The grid trains batched by
default and equals its ``H2O3TPU_BATCH_MODELS=off`` walk."""

import contextlib

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch as h2o
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu.models.gbm import fit_gbm_batched as ref_fit_gbm_batched
from h2o3_tpu.models.glm import GLMEstimator as RefGLM
from h2o3_tpu.models.glm import fit_glm_batched as ref_fit_glm_batched
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu.parallel import model_batch as ref_mb
from h2o3_tpu_torch.ml import grid as grid_mod
from h2o3_tpu_torch.ml.leaderboard import Leaderboard
from h2o3_tpu_torch.models import gbm as gbm_mod
from h2o3_tpu_torch.models.convert import gbm_model_from_arrays
from h2o3_tpu_torch.models.gbm import fit_gbm_batched
from h2o3_tpu_torch.models.glm import fit_glm_batched
from h2o3_tpu_torch.models.tree import Tree
from h2o3_tpu_torch.ops.kernels import treekernel as tk
from h2o3_tpu_torch.parallel import model_batch as mb

COEF_TOL = 1e-4          # tests/test_torch_grid.py's
INT_FIELDS = ("feat", "thresh", "na_left", "is_split", "cat_split",
              "left_words")
BUCKET = [dict(learn_rate=0.1, min_rows=5.0, reg_lambda=0.0, max_depth=3),
          dict(learn_rate=0.2, min_rows=10.0, reg_lambda=0.5, max_depth=4),
          dict(learn_rate=0.05, min_rows=2.0, reg_lambda=1.0, max_depth=5),
          dict(learn_rate=0.15, min_rows=20.0, reg_lambda=0.1, max_depth=4)]
NO_SAMPLING = dict(ntrees=4, seed=3, sample_rate=1.0,
                   col_sample_rate_per_tree=1.0)


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


def _cols(n=2000, seed=2):
    """Binomial columns with NAs in x0 and a categorical."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 4)
    X[r.rand(n) < 0.05, 0] = np.nan
    cat = r.choice(["a", "b", "c", "d"], n)
    y = (X[:, 1] + (cat == "a") * 1.5 + 0.5 * np.nan_to_num(X[:, 0])
         + 0.3 * r.randn(n) > 0).astype(int)
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["c"] = cat
    cols["y"] = np.array(["N", "Y"], object)[y]
    cols["r"] = 2.0 * X[:, 1] + np.sin(X[:, 2]) + 0.2 * r.randn(n)
    return cols


@pytest.fixture(scope="module")
def frames():
    cols = _cols()
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=["c", "y"]),
            h2o.Frame.from_numpy(cols, categorical=["c", "y"],
                                 device="cpu"))


@pytest.fixture(scope="module")
def bucket_fits(frames):
    """The reference's and the port's batched fits of BUCKET (one JAX
    compile for the module)."""
    fr_r, fr_p = frames
    plist = [{**NO_SAMPLING, **c} for c in BUCKET]
    x = ["x0", "x1", "x2", "x3", "c"]
    with _one_device():
        refs = ref_fit_gbm_batched(RefGBM, plist, fr_r, y="y", x=x)
    return refs, fit_gbm_batched(h2o.GBMEstimator, plist, fr_p, y="y", x=x)


def _forests_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in Tree._fields)


def _twins(models, fixed, combos, frame, **train_kw):
    """Each batched model against its combo's sequential port fit."""
    for m, c in zip(models, combos):
        s = h2o.GBMEstimator(**fixed, **c).train(frame, **train_kw)
        assert _forests_equal(m.forest, s.forest), c
        assert m.output["scoring_history"] == s.output["scoring_history"]
        assert m.output["varimp"] == s.output["varimp"]
        assert m.training_metrics.to_dict() == s.training_metrics.to_dict()


# ---------------------------------------------------------- the planner


PLAN_COMBOS = [
    {"learn_rate": 0.1, "max_depth": 3, "seed": 1},
    {"learn_rate": 0.2, "max_depth": 6, "seed": 2},
    {"learn_rate": 0.1, "max_depth": 7, "seed": 1},
    {"learn_rate": 0.1, "max_depth": 12, "nbins": 32},
    {"learn_rate": 0.3, "max_depth": 16, "nbins": 32},
    {"learn_rate": 0.3, "max_depth": 16, "nbins": [32, 64]},
    {"alpha": 0.5, "lambda_": 1e-3, "family": "binomial"},
    {"alpha": 0.0, "Lambda": [1e-2], "family": "gaussian"},
]


@pytest.mark.parametrize("algo", ["gbm", "glm", "drf"])
@pytest.mark.parametrize("combo", PLAN_COMBOS)
def test_combo_and_bucket_keys_equal_the_reference(algo, combo):
    assert mb.bucket_key(algo, combo) == ref_mb.bucket_key(algo, combo)
    assert mb.combo_key(combo) == ref_mb.combo_key(combo)


@pytest.mark.parametrize("algo", ["gbm", "glm"])
def test_plan_buckets_equal_the_reference(algo):
    rng = np.random.RandomState(4)
    combos = [PLAN_COMBOS[i] for i in rng.randint(0, len(PLAN_COMBOS), 20)]
    got = [(b.key, b.indices, b.width)
           for b in mb.plan_buckets(algo, combos)]
    want = [(b.key, b.indices, b.width)
            for b in ref_mb.plan_buckets(algo, combos)]
    assert got == want
    assert mb.BATCHABLE_KNOBS == ref_mb.BATCHABLE_KNOBS


@pytest.mark.parametrize("n,cap", [(0, 100), (1, 1), (7, 64), (8, 64),
                                   (9, 64), (100, 64), (5000, 4096),
                                   (33, 20)])
def test_row_bucket_equals_the_reference(n, cap):
    assert mb.row_bucket(n, cap) == ref_mb.row_bucket(n, cap)


@pytest.mark.parametrize("value", [None, "auto", "off", "0", " OFF ", "",
                                   "no", "false", "on"])
def test_mode_reads_the_env_as_the_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("H2O3TPU_BATCH_MODELS", raising=False)
    else:
        monkeypatch.setenv("H2O3TPU_BATCH_MODELS", value)
    assert mb.mode() == ref_mb.mode()
    assert mb.enabled() == ref_mb.enabled()


# ---------------------------------------------------------- GBM buckets


def test_gbm_bucket_equals_the_reference_batched_fit(bucket_fits):
    refs, ours = bucket_fits
    for c, m_r, m_p in zip(BUCKET, refs, ours):
        for f in INT_FIELDS:
            want = np.asarray(getattr(m_r.forest, f))
            got = getattr(m_p.forest, f).numpy()
            if f == "left_words":
                got = got.view(np.uint32)
            np.testing.assert_array_equal(got, want, err_msg=f"{c} {f}")
        for f in ("leaf", "leaf_w"):
            np.testing.assert_allclose(getattr(m_p.forest, f).numpy(),
                                       np.asarray(getattr(m_r.forest, f)),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
        for k in ("AUC", "logloss", "MSE"):
            assert m_p.training_metrics[k] == pytest.approx(
                m_r.training_metrics[k], abs=1e-5), (c, k)
    # the batch grew the depth-3 model only three levels deep
    assert not ours[0].forest.is_split[:, 3:].any()
    assert ours[2].forest.is_split[:, 4].any()


@pytest.mark.parametrize("case", ["sampled", "stopping", "constraints",
                                  "offset"])
def test_gbm_bucket_bit_equal_to_sequential_fits(frames, case):
    """Seeds and sampling vary; with early stopping each model stops at
    its own tree (the batch drops it there); monotone and interaction
    constraints keep each model's bounds and allowances; an offset
    column enters f0 and every margin."""
    _, fr = frames
    combos = [dict(learn_rate=0.3, sample_rate=0.7, seed=1, max_depth=3),
              dict(learn_rate=0.05, sample_rate=1.0, seed=2, max_depth=4,
                   col_sample_rate_per_tree=0.6, min_rows=4.0),
              dict(learn_rate=0.5, sample_rate=0.5, seed=3, max_depth=6,
                   reg_lambda=1.0)]
    fixed = dict(ntrees=5)
    y = "y"
    if case == "stopping":
        fixed = dict(ntrees=30, stopping_rounds=2, stopping_tolerance=0.05,
                     score_tree_interval=2)
        y = "r"
    elif case == "constraints":
        fixed = dict(ntrees=4, monotone_constraints={"x1": 1},
                     interaction_constraints=[["x0", "x1"]])
    elif case == "offset":
        cols = _cols()
        cols["o"] = 0.3 * np.sin(np.arange(len(cols["y"])))
        fr = h2o.Frame.from_numpy(cols, categorical=["c", "y"],
                                  device="cpu")
        fixed = dict(ntrees=4, offset_column="o")
    x = ["x0", "x1", "x2", "x3", "c"]
    models = fit_gbm_batched(h2o.GBMEstimator,
                             [{**fixed, **c} for c in combos], fr, y=y, x=x)
    _twins(models, fixed, combos, fr, y=y, x=x)
    if case == "stopping":
        sizes = [int(m.forest.feat.shape[0]) for m in models]
        assert min(sizes) < 30 and len(set(sizes)) > 1, sizes


def test_gbm_bucket_in_passes_of_one_model(frames, monkeypatch):
    """A bucket trained a model a pass (a card short of memory) gives the
    same bits as one pass."""
    _, fr = frames
    combos = BUCKET[:3]
    plist = [{**NO_SAMPLING, **c} for c in combos]
    whole = fit_gbm_batched(h2o.GBMEstimator, plist, fr, y="y")
    monkeypatch.setattr(gbm_mod, "models_per_pass", lambda *a: 1)
    passes = fit_gbm_batched(h2o.GBMEstimator, plist, fr, y="y")
    for a, b in zip(whole, passes):
        assert _forests_equal(a.forest, b.forest)


def test_models_level_chain_equals_one_model_chains(frames):
    """``plain_level_models`` (the model-axis routes' plain versions,
    which the CPU fit runs) equals each model's ``plain_level``, with
    ragged depth limits."""
    from h2o3_tpu_torch.frame.binning import bin_frame
    from h2o3_tpu_torch.models.tree import TreeScalars
    _, fr = frames
    bm = bin_frame(fr, ["x0", "x1", "x2", "x3", "c"], nbins=20,
                   nbins_cats=10)
    N, F = bm.bins.shape
    B = bm.nbins_total
    M = 3
    g = torch.Generator().manual_seed(0)
    stats = torch.randint(-4, 5, (M, N, 3), generator=g).float()
    stats[:, :, 0] = stats[:, :, 0].abs()
    stats[:, :, 2] = stats[:, :, 2].abs()
    knobs = torch.tensor([[1.0, 0.0, 1e-5], [5.0, 0.5, 1e-5],
                          [2.0, 1.0, 0.1]])
    limit = torch.tensor([2, 4, 3], dtype=torch.int32)
    cm = torch.rand((M, F), generator=g) < 0.8
    is_cat = torch.tensor(bm.is_cat, dtype=torch.bool)
    lo = torch.full((M, 1), -torch.inf)
    hi = torch.full((M, 1), torch.inf)
    nid = torch.zeros((M, N), dtype=torch.int32)
    nids = [nid[m] for m in range(M)]
    prev, prevs = None, [None] * M
    for d in range(4):
        out = tk.plain_level_models(bm.bins, nid, stats, prev, cm, bm.nbins,
                                    is_cat, None, lo, hi, knobs, limit,
                                    d=d, n_nodes=2 ** d, n_bins=B)
        for m in range(M):
            sc = TreeScalars(knobs[m, 0], knobs[m, 1], knobs[m, 2],
                             limit[m])
            one = tk.plain_level(bm.bins, nids[m], stats[m], prevs[m],
                                 cm[m], bm.nbins, is_cat, None, lo[m],
                                 hi[m], sc, d=d, n_nodes=2 ** d, n_bins=B)
            for a, b in zip(out, one):       # NaN gains where no split
                torch.testing.assert_close(a[m], b, rtol=0, atol=0,
                                           equal_nan=True)
            nids[m], prevs[m] = one[-1], one[0]
        assert not out[8][0].any() or d < 2    # depth limit 2 holds
        prev, nid = out[0], out[-1]


def test_batched_gbm_converts_and_scores_like_its_twin(frames, bucket_fits):
    """A reference batched model carried across predicts like the port's
    batched twin, which predicts exactly as its sequential fit."""
    _, fr_p = frames
    m_r, m_p = bucket_fits[0][1], bucket_fits[1][1]
    bm = m_r.bm
    d = {f: np.asarray(getattr(m_r.forest, f)) for f in m_r.forest._fields}
    d.update(edges=np.asarray(bm.edges), nbins=np.asarray(bm.nbins),
             is_cat=np.asarray(bm.is_cat), names=list(bm.names),
             domains=list(bm.domains), nbins_total=bm.nbins_total,
             nbins_cats=bm.nbins_cats, f0=np.asarray(m_r.f0),
             dist_name=m_r.dist_name, category=m_r.output["category"],
             domain=m_r.output["domain"], response=m_r.output["response"],
             default_threshold=m_r.output.get("default_threshold", 0.5),
             params=m_r.params)
    carried = gbm_model_from_arrays(d, device="cpu")
    p_c = carried.predict(fr_p).col("p1").to_numpy()
    p_p = m_p.predict(fr_p).col("p1").to_numpy()
    np.testing.assert_allclose(p_p, p_c, atol=1e-5)
    twin = h2o.GBMEstimator(**NO_SAMPLING, **BUCKET[1]).train(
        fr_p, y="y", x=["x0", "x1", "x2", "x3", "c"])
    np.testing.assert_array_equal(p_p,
                                  twin.predict(fr_p).col("p1").to_numpy())


@pytest.mark.parametrize("bad", [
    dict(nfolds=2), dict(max_runtime_secs=5.0),
    dict(max_depth=[3, 8]), dict(nbins=[16, 32]), dict(y="m")])
def test_gbm_ineligible_buckets_raise(frames, bad):
    _, fr = frames
    combos = [dict(NO_SAMPLING), dict(NO_SAMPLING, learn_rate=0.3)]
    y = bad.pop("y", "y")
    for k, v in bad.items():
        vals = v if isinstance(v, list) else [v, v]
        for c, val in zip(combos, vals):
            c[k] = val
    if y == "m":
        cols = _cols(300)
        cols["m"] = np.array(["p", "q", "r"], object)[
            np.arange(300) % 3]
        fr = h2o.Frame.from_numpy(cols, categorical=["c", "y", "m"],
                                  device="cpu")
    with pytest.raises(mb.BatchIneligible):
        fit_gbm_batched(h2o.GBMEstimator, combos, fr, y=y)


# ---------------------------------------------------------- GLM buckets

GLM_BUCKET = [dict(alpha=0.0, lambda_=1e-3), dict(alpha=0.5, lambda_=1e-3),
              dict(alpha=0.0, lambda_=1e-2), dict(alpha=0.5, lambda_=1e-2)]


@pytest.mark.parametrize("family,y", [("binomial", "y"),
                                      ("gaussian", "r")])
def test_glm_bucket_against_reference_and_sequential(frames, family, y):
    """Both use_l1 partitions (alpha 0: Cholesky; alpha 0.5: ADMM)."""
    fr_r, fr_p = frames
    plist = [dict(family=family, **c) for c in GLM_BUCKET]
    with _one_device():
        refs = ref_fit_glm_batched(RefGLM, plist, fr_r, y=y)
    ours = fit_glm_batched(h2o.GLMEstimator, plist, fr_p, y=y)
    for p, m_r, m_p in zip(plist, refs, ours):
        seq = h2o.GLMEstimator(**p).train(fr_p, y=y)
        cp, cr, cs = m_p.coefficients, m_r.coefficients, seq.coefficients
        assert set(cp) == set(cr) == set(cs)
        assert max(abs(cp[k] - cr[k]) for k in cp) <= COEF_TOL, p
        assert max(abs(cp[k] - cs[k]) for k in cp) <= COEF_TOL, p
        assert m_p.output["lambda_best"] == seq.output["lambda_best"]


def test_glm_ineligible_buckets_raise(frames):
    _, fr = frames
    for extra in (dict(lambda_search=True), dict(solver="l_bfgs"),
                  dict(nfolds=2), dict(compute_p_values=True)):
        plist = [dict(family="binomial", alpha=0.0, lambda_=1e-3, **extra),
                 dict(family="binomial", alpha=0.5, lambda_=1e-3, **extra)]
        with pytest.raises(mb.BatchIneligible):
            fit_glm_batched(h2o.GLMEstimator, plist, fr, y="y")


# ----------------------------------------------------------------- grid

GRID_HYPER = {"learn_rate": [0.05, 0.2], "sample_rate": [0.7, 1.0],
              "max_depth": [3, 5]}
GRID_FIXED = dict(ntrees=3, seed=4)


def _walk(monkeypatch, mode, hyper=GRID_HYPER, criteria=None, **fixed):
    monkeypatch.setenv("H2O3TPU_BATCH_MODELS", mode)
    fr = h2o.Frame.from_numpy(_cols(1500, seed=2),
                              categorical=["c", "y"], device="cpu")
    return grid_mod.GridSearch(h2o.GBMEstimator, hyper,
                               search_criteria=criteria,
                               **(fixed or GRID_FIXED)).train(fr, y="y")


def _by_params(rows, g):
    names = {m.key: m.output["grid_params"] for m in g.models}
    return [(names[r.pop("model_id")], r) for r in rows]


def test_grid_batched_equals_the_sequential_walk(monkeypatch):
    calls = []
    real = mb.train_bucket
    monkeypatch.setattr(mb, "train_bucket",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    g_b = _walk(monkeypatch, "auto")
    assert calls == [1]                   # one bucket: all eight combos
    g_s = _walk(monkeypatch, "off")
    assert calls == [1]
    assert [m.output["grid_params"] for m in g_b.models] == \
        [m.output["grid_params"] for m in g_s.models]
    for a, b in zip(g_b.models, g_s.models):
        assert _forests_equal(a.forest, b.forest)
        assert h2o.DKV.get(a.key) is a
    assert _by_params(g_b.summary_table(), g_b) == \
        _by_params(g_s.summary_table(), g_s)
    lbs = []
    for g in (g_b, g_s):
        lb = Leaderboard("batch")
        lb.add(*g.models)
        lbs.append([m.output["grid_params"] for m in lb.sorted_models()])
    assert lbs[0] == lbs[1]


def test_grid_max_models_discards_the_extras(monkeypatch):
    """Buckets are planned over the first max_models combos; a stopping
    walk leaves its unreached batched models out of the DKV."""
    before = set(h2o.DKV.keys("model_gbm"))
    g = _walk(monkeypatch, "auto", criteria={
        "strategy": "RandomDiscrete", "seed": 5, "max_models": 3})
    assert len(g.models) == 3
    new = set(h2o.DKV.keys("model_gbm")) - before
    assert new == {m.key for m in g.models}
    g = _walk(monkeypatch, "auto", criteria={"stopping_rounds": 1,
                                             "stopping_tolerance": 1.0})
    new = set(h2o.DKV.keys("model_gbm")) - before
    assert len(g.models) == 3 < 8
    assert {m.key for m in g.models} <= new
    assert len(new) == 3 + 3          # the first walk's and this one's


@pytest.mark.parametrize("algo", ["cv", "drf"])
def test_grid_ineligible_walks_sequentially(monkeypatch, algo):
    """CV combos raise BatchIneligible and walk; an algorithm without a
    batched trainer has no batchable knob, so its buckets are of one
    combo each and never reach ``train_bucket``."""
    seen = []
    real = mb.train_bucket

    def spy(*a, **k):
        seen.append("called")
        try:
            return real(*a, **k)
        except mb.BatchIneligible as e:
            seen.append(str(e))
            raise
    monkeypatch.setattr(mb, "train_bucket", spy)
    monkeypatch.setenv("H2O3TPU_BATCH_MODELS", "auto")
    fr = h2o.Frame.from_numpy(_cols(600), categorical=["c", "y"],
                              device="cpu")
    if algo == "cv":
        cls, fixed = h2o.GBMEstimator, dict(ntrees=2, nfolds=2, seed=1)
    else:
        cls, fixed = h2o.DRFEstimator, dict(ntrees=2, seed=1)
    hyper = {"max_depth": [3, 4]}
    g = grid_mod.GridSearch(cls, hyper, **fixed).train(fr, y="y")
    assert seen == (["called", "cross-validation"] if algo == "cv"
                    else [])
    assert len(g.models) == 2 and not g.failures
    monkeypatch.setenv("H2O3TPU_BATCH_MODELS", "off")
    g_s = grid_mod.GridSearch(cls, hyper, **fixed).train(fr, y="y")
    for a, b in zip(g.models, g_s.models):
        assert _forests_equal(a.forest, b.forest)


def test_grid_invalid_combos_recorded_as_sequentially(monkeypatch):
    """A bucket whose combos fail on their own (an unknown family) walks
    sequentially, so the grid records the same failures as its ``off``
    walk; the valid bucket still trains batched."""
    monkeypatch.setenv("H2O3TPU_BATCH_MODELS", "auto")
    fr = h2o.Frame.from_numpy(_cols(800), categorical=["c", "y"],
                              device="cpu")
    hyper = {"family": ["binomial", "nope"], "lambda_": [1e-3, 1e-2]}
    x = ["x0", "x1", "x2", "x3"]
    calls = []
    real = mb.train_bucket

    def spy(*a, **k):
        try:
            out = real(*a, **k)
            calls.append("batched")
            return out
        except mb.BatchIneligible:
            calls.append("ineligible")
            raise
    monkeypatch.setattr(mb, "train_bucket", spy)
    g_b = grid_mod.GridSearch(h2o.GLMEstimator, hyper).train(fr, y="y",
                                                             x=x)
    monkeypatch.setenv("H2O3TPU_BATCH_MODELS", "off")
    g_s = grid_mod.GridSearch(h2o.GLMEstimator, hyper).train(fr, y="y",
                                                             x=x)
    assert sorted(calls) == ["batched", "ineligible"]
    assert g_b.failures == g_s.failures and len(g_b.failures) == 2
    assert [m.output["grid_params"] for m in g_b.models] == \
        [m.output["grid_params"] for m in g_s.models]


def test_grid_other_batch_errors_raise(monkeypatch):
    """Only BatchIneligible falls back: a failing batch (a kernel that
    does not build, say) raises instead of hiding behind the walk."""
    def broken(*a, **k):
        raise RuntimeError("tree_hist_models kernel failed to launch")
    monkeypatch.setattr(gbm_mod, "fit_gbm_batched", broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        _walk(monkeypatch, "auto")
