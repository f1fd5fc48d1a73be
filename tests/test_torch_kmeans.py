"""KMeans in the PyTorch port (on the CPU) against the reference package.

The same seeded numpy blobs (4,096 rows, which the reference does not
pad: its PlusPlus draw runs over the padded rows) go through both. The
reference seeds its init's host ``RandomState`` from ``jax.random``; the
``ref_draws`` fixture feeds those seeds into the port's
``kmeans.draw_init_seeds``, so both inits pick the same rows (PlusPlus
samples ∝ float32 d², whose last bits differ, so a pick could move
where a uniform draw lands within rounding of a boundary; at the seeds
used here none does).
The design
and the distance product differ in the last float32 bits (another
summation order), so centers are held within 1e-5·max(1, |c|), metrics
within 1e-5 relative, and assignments equal on every row whose two
smallest d² differ by more than 1e-5 of their scale (``near_ties``; the
count of the others is printed). On an unstandardized design far from
the origin the product form d² = ‖x‖² − 2x·c + ‖c‖² cancels in both
packages, so there the within sums of squares are held to that form's
float32 bound, 2^-21·Σ w (‖x‖² + max ‖c‖²) (``product_bound``). The
blobs are well apart, so Lloyd's stops at the same step in both: the
step counts are equal. The
reference's fits run on a one-device mesh (``_one_device``), where no
XLA:CPU collective can abort a test worker.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.frame.datainfo import build_datainfo as ref_build_datainfo
from h2o3_tpu.models import kmeans as ref_km
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.frame.datainfo import build_datainfo
from h2o3_tpu_torch.ml.cv import fold_assignment
from h2o3_tpu_torch.models import kmeans
from h2o3_tpu_torch.models.convert import kmeans_model_from_arrays

CENTER_TOL = 1e-5
METRIC_TOL = 1e-5
X_NAMES = ["x0", "x1", "x2", "c"]


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


def ref_init_seeds(seed, runs):
    """The reference's init seeds: ``randint`` of its key (``runs``
    None), or of each split subkey of ``estimate_k``'s sweep."""
    key = jax.random.PRNGKey(seed)
    if runs is None:
        return [int(jax.random.randint(key, (), 0, 2 ** 31 - 1))]
    out = []
    for _ in range(runs):
        key, sub = jax.random.split(key)
        out.append(int(jax.random.randint(sub, (), 0, 2 ** 31 - 1)))
    return out


@pytest.fixture
def ref_draws(monkeypatch):
    monkeypatch.setattr(kmeans, "draw_init_seeds", ref_init_seeds)


@pytest.fixture
def ref_steps(monkeypatch):
    """Counts the reference's Lloyd steps."""
    calls = []
    real = ref_km._lloyd_step

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ref_km, "_lloyd_step", spy)
    return calls


def blob_cols(n=4096, seed=0, weights=False):
    """Four well-separated blobs over three numerics (x1 on a wide
    scale, NAs in x2) and a categorical that follows the blob (NAs)."""
    r = np.random.RandomState(seed)
    means = np.array([[0.0, 0.0, 0.0], [6.0, 5.0, 0.0], [-5.0, 6.0, 5.0],
                      [0.0, -6.0, -6.0]])
    lab = r.randint(0, 4, n)
    X = means[lab] + 0.7 * r.randn(n, 3)
    X[:, 1] = 20.0 + 5.0 * X[:, 1]
    X[r.rand(n) < 0.03, 2] = np.nan
    c = np.array(["a", "b", "c", "d"], object)[
        np.where(r.rand(n) < 0.85, lab, r.randint(0, 4, n))]
    c[r.rand(n) < 0.02] = None
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "c": c}
    if weights:
        cols["w"] = r.choice([0.5, 1.0, 2.0], n)
    return cols


def frames(cols):
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=["c"])
    return fr_r, h2o3_tpu_torch.Frame.from_numpy(cols, categorical=["c"],
                                                 device="cpu")


def near_ties(X, C):
    """Rows whose two smallest squared distances to the centers ``C``
    differ by at most 1e-5 of their scale (float64)."""
    X, C = X.astype(np.float64), C.astype(np.float64)
    d2 = ((X[:, None, :] - C[None, :, :]) ** 2).sum(2)
    s = np.sort(d2, axis=1)
    scale = (X * X).sum(1) + (C * C).sum(1).max()
    return (s[:, 1] - s[:, 0]) <= 1e-5 * scale


def assert_centers(port, ref, label=""):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, label
    gap = np.abs(port - ref) / np.maximum(1.0, np.abs(ref))
    assert gap.max() <= CENTER_TOL, (label, gap.max())


def product_bound(model, fr, w) -> float:
    """The float32 bound of the product form's within sums of squares
    over ``fr``'s rows weighted ``w``."""
    X = model._design(fr).X.numpy()[:fr.nrows].astype(np.float64)
    c2 = (model.centers_std.numpy().astype(np.float64) ** 2).sum(1).max()
    return 2.0 ** -21 * float((w * ((X * X).sum(1) + c2)).sum())


def assert_metrics(mp, mr, label="", wss_abs=0.0):
    """Metrics within METRIC_TOL relative; the within sums of squares
    (and betweenss) also within ``wss_abs``."""
    def close(a, b, key):
        assert abs(a - b) <= max(METRIC_TOL * abs(b), wss_abs), \
            (label, key, a, b)
    close(mp["totss"], mr["totss"], "totss")
    for key in ("tot_withinss", "betweenss"):
        close(mp[key], mr[key], key)
    close(mp["MSE"] * mp["nobs"], mr["MSE"] * mr["nobs"], "MSE")
    assert mp["nobs"] == mr["nobs"], label
    cs_p, cs_r = mp["centroid_stats"], mr["centroid_stats"]
    np.testing.assert_allclose(cs_p["size"], cs_r["size"], rtol=METRIC_TOL)
    for a, b in zip(cs_p["within_cluster_sum_of_squares"],
                    cs_r["within_cluster_sum_of_squares"]):
        close(a, b, "within_cluster_sum_of_squares")


def assert_assignments(m_p, m_r, fr_p, fr_r, label=""):
    """Predicted clusters equal off the near-ties; returns their count."""
    a_p = m_p.predict(fr_p).col("predict").to_numpy()
    with _one_device():
        a_r = m_r.predict(fr_r).col("predict").to_numpy()
    X = m_p._design(fr_p).X.numpy()[:fr_p.nrows]
    ties = near_ties(X, m_p.centers_std.numpy())
    np.testing.assert_array_equal(a_p[~ties], a_r[~ties], err_msg=label)
    print(f"{label}: {int(ties.sum())} near-tie rows of {len(ties)}")
    return int(ties.sum())


@pytest.mark.parametrize("method", ["random", "plusplus", "furthest"])
def test_init_picks_the_references_rows(method):
    cols = blob_cols(seed=1)
    fr_r, fr_p = frames(cols)
    with _one_device():
        di_r = ref_build_datainfo(fr_r, X_NAMES, standardize=True,
                                  use_all_factor_levels=True)
        X_r = np.asarray(di_r.X)
        w_r = fr_r.valid_weights()
        for seed in (3, 11, 42):
            key = jax.random.PRNGKey(seed)
            c_r = np.asarray(ref_km._init_centers(di_r.X, w_r, 5, method,
                                                  key))
            X_p = build_datainfo(fr_p, X_NAMES, standardize=True,
                                 use_all_factor_levels=True).X
            c_p, rows = kmeans.init_centers(
                X_p, fr_p.valid_weights(), 5, method,
                ref_init_seeds(seed, None)[0])
            rows_r = [int(np.flatnonzero((X_r == c).all(1))[0]) for c in c_r]
            assert rows == rows_r, (method, seed)
            assert_centers(c_p.numpy(), c_r, method)


@pytest.mark.parametrize("init", ["Random", "PlusPlus", "Furthest"])
def test_fit_matches_the_reference(init, ref_draws, ref_steps):
    cols = blob_cols(seed=2)
    fr_r, fr_p = frames(cols)
    kw = dict(k=4, init=init, seed=7, max_iterations=20)
    with _one_device():
        m_r = ref_km.KMeansEstimator(**kw).train(fr_r)
    m_p = h2o3_tpu_torch.KMeansEstimator(**kw).train(fr_p)
    assert m_p.output["iterations"] == len(ref_steps)
    assert m_p.output["coef_names"] == m_r.output["coef_names"]
    assert_centers(m_p.output["centers_std"], m_r.output["centers_std"], init)
    assert_centers(m_p.output["centers"], m_r.output["centers"], init)
    assert_metrics(m_p.training_metrics, m_r.training_metrics, init)
    assert_assignments(m_p, m_r, fr_p, fr_r, init)


def test_weights_and_validation_metrics_match_the_reference(ref_draws):
    cols = blob_cols(seed=3, weights=True)
    vcols = blob_cols(n=1000, seed=4, weights=True)
    fr_r, fr_p = frames(cols)
    vr, vp = frames(vcols)
    kw = dict(k=4, seed=9, weights_column="w", standardize=False)
    with _one_device():
        m_r = ref_km.KMeansEstimator(**kw).train(fr_r, validation_frame=vr)
    m_p = h2o3_tpu_torch.KMeansEstimator(**kw).train(fr_p,
                                                     validation_frame=vp)
    assert "w" not in m_p.output["names"]
    assert_centers(m_p.output["centers"], m_r.output["centers"])
    assert_metrics(m_p.training_metrics, m_r.training_metrics, "train",
                   product_bound(m_p, fr_p, cols["w"]))
    assert_metrics(m_p.validation_metrics, m_r.validation_metrics, "valid",
                   product_bound(m_p, vp, vcols["w"]))


def test_cv_matches_the_reference(ref_draws):
    cols = blob_cols(seed=5)
    fr_r, fr_p = frames(cols)
    kw = dict(k=4, seed=13, nfolds=3)
    with _one_device():
        m_r = ref_km.KMeansEstimator(**kw).train(fr_r)
    m_p = h2o3_tpu_torch.KMeansEstimator(**kw).train(fr_p)
    np.testing.assert_array_equal(
        m_p._cv_folds, fold_assignment(fr_p.nrows, 3, "random", 13))
    assert len(m_p._cv_models) == len(m_r._cv_models) == 3
    for f, (a, b) in enumerate(zip(m_p._cv_models, m_r._cv_models)):
        assert_centers(a.output["centers_std"], b.output["centers_std"],
                       f"fold {f}")
        assert_metrics(a.training_metrics, b.training_metrics, f"fold {f}")
    assert_centers(m_p.output["centers_std"], m_r.output["centers_std"])
    cvm = m_p.cross_validation_metrics
    assert cvm["centroid_stats"] is None
    assert m_r.cross_validation_metrics["centroid_stats"] is None
    assert m_p.training_metrics["centroid_stats"] is not None
    for key in ("totss", "tot_withinss", "betweenss"):
        assert cvm[key] == m_p.training_metrics[key]
        assert cvm[key] == pytest.approx(
            m_r.cross_validation_metrics[key], rel=METRIC_TOL)
    assert m_p.output["nfolds"] == 3
    # the fold models under <main>_cv_<i>, as the reference names them
    assert [k.split("_cv_")[1] for k in m_p.output["cv_model_keys"]] == \
        [k.split("_cv_")[1] for k in m_r.output["cv_model_keys"]] == \
        ["1", "2", "3"]
    assert [h2o3_tpu_torch.DKV.get(k) for k in m_p.output["cv_model_keys"]] \
        == m_p._cv_models


def test_estimate_k_matches_the_reference(ref_draws):
    cols = blob_cols(seed=6)
    fr_r, fr_p = frames(cols)
    kw = dict(k=8, estimate_k=True, seed=21, init="PlusPlus")
    with _one_device():
        m_r = ref_km.KMeansEstimator(**kw).train(fr_r)
    m_p = h2o3_tpu_torch.KMeansEstimator(**kw).train(fr_p)
    assert m_p.output["k"] == m_r.output["k"]
    assert_centers(m_p.output["centers_std"], m_r.output["centers_std"])
    assert_metrics(m_p.training_metrics, m_r.training_metrics)


@pytest.mark.parametrize("constrained", [False, True])
def test_user_points_match_the_reference(constrained):
    cols = blob_cols(seed=7)
    fr_r, fr_p = frames(cols)
    pts = {"p0": np.array([0.0, 6.0, -5.0]),
           "p1": np.array([20.0, 45.0, 50.0]),
           "p2": np.array([0.0, 0.0, 5.0]),
           "p3": np.array(["a", "b", "c"], object)}
    kw = dict(max_iterations=5)
    if constrained:
        kw["cluster_size_constraints"] = [1000, 1000, 1000]
    with _one_device():
        up_r = h2o3_tpu.Frame.from_numpy(pts, categorical=["p3"])
        m_r = ref_km.KMeansEstimator(user_points=up_r, **kw).train(fr_r)
    up_p = h2o3_tpu_torch.Frame.from_numpy(pts, categorical=["p3"],
                                           device="cpu")
    m_p = h2o3_tpu_torch.KMeansEstimator(user_points=up_p, **kw).train(fr_p)
    assert m_p.output["k"] == m_r.output["k"] == 3
    assert_centers(m_p.output["centers_std"], m_r.output["centers_std"])
    assert_metrics(m_p.training_metrics, m_r.training_metrics)
    if constrained:
        assert min(m_p.training_metrics["centroid_stats"]["size"]) >= 1000


def test_user_points_by_key_and_bad_points_raise():
    cols = blob_cols(n=200, seed=8)
    fr_p = frames(cols)[1]
    # a Frame's DKV key starts the fit as the Frame does; a key with no
    # frame under it raises
    with pytest.raises(ValueError, match="no frame under the key"):
        h2o3_tpu_torch.KMeansEstimator(k=2, init="User",
                                       user_points="points_key").train(fr_p)
    num = ["x0", "x1", "x2"]
    pts = {n: np.asarray(cols[n])[:2] for n in num}
    h2o3_tpu_torch.Frame.from_numpy(pts, device="cpu", key="points_key")
    by_key, by_frame = (h2o3_tpu_torch.KMeansEstimator(
        k=2, init="User", user_points=u).train(fr_p, x=num)
        for u in ("points_key",
                  h2o3_tpu_torch.Frame.from_numpy(pts, device="cpu")))
    np.testing.assert_array_equal(by_key.output["centers_std"],
                                  by_frame.output["centers_std"])
    h2o3_tpu_torch.DKV.remove("points_key")
    up = h2o3_tpu_torch.Frame.from_numpy({"a": np.zeros(2)}, device="cpu")
    with pytest.raises(ValueError, match="one column per predictor"):
        h2o3_tpu_torch.KMeansEstimator(user_points=up).train(fr_p)
    with pytest.raises(ValueError, match="Cannot estimate k"):
        h2o3_tpu_torch.KMeansEstimator(
            k=2, estimate_k=True,
            cluster_size_constraints=[1, 1]).train(fr_p)


def test_constrained_lloyds_assign_exactly_as_the_reference():
    """The host float64 rebalance on the same design and the same
    initial centers: assignments, centers and sums EXACT."""
    cols = blob_cols(n=2000, seed=9)
    fr_r, _ = frames(cols)
    with _one_device():
        di_r = ref_build_datainfo(fr_r, X_NAMES, standardize=True,
                                  use_all_factor_levels=True)
        w_r = fr_r.valid_weights()
        key = jax.random.PRNGKey(17)
        mins = [300, 900, 200, 500]
        est = ref_km.KMeansEstimator()
        c_r, a_r, n_r, wss_r = est._run_lloyds_constrained(
            di_r.X, w_r, 4, "furthest", key, 6, mins)
        c0 = ref_km._init_centers(di_r.X, w_r, 4, "furthest", key)
    X = torch.from_numpy(np.array(di_r.X))
    w = torch.from_numpy(np.array(w_r))
    c_p, a_p, n_p, wss_p = kmeans.run_lloyds_constrained(
        X, w, 4, 6, mins, torch.from_numpy(np.array(c0)))
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_r))
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_r))
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_r))
    np.testing.assert_array_equal(wss_p.numpy(), np.asarray(wss_r))
    assert (n_p.numpy() >= np.asarray(mins)).all()


def test_constrained_fit_matches_the_reference(ref_draws):
    cols = blob_cols(n=2000, seed=10)
    fr_r, fr_p = frames(cols)
    kw = dict(k=4, seed=5, cluster_size_constraints=[400, 400, 400, 400],
              max_iterations=4)
    with _one_device():
        m_r = ref_km.KMeansEstimator(**kw).train(fr_r)
    m_p = h2o3_tpu_torch.KMeansEstimator(**kw).train(fr_p)
    assert m_p.training_metrics["centroid_stats"]["size"] == \
        m_r.training_metrics["centroid_stats"]["size"]
    assert_centers(m_p.output["centers_std"], m_r.output["centers_std"])
    assert_metrics(m_p.training_metrics, m_r.training_metrics)


def test_reference_model_carried_across_scores_alike(ref_draws):
    cols = blob_cols(seed=11, weights=True)
    fr_r, _ = frames(cols)
    with _one_device():
        m_r = ref_km.KMeansEstimator(k=4, seed=3,
                                     weights_column="w").train(fr_r)
    m_p = kmeans_model_from_arrays(dict(
        centers_std=np.asarray(m_r.centers_std), di_stats=m_r.di_stats,
        features=m_r.features, standardize=m_r.standardize,
        output=m_r.output, params=m_r.params))
    te = blob_cols(n=1500, seed=12, weights=True)
    te["c"][:40] = "zzz"                           # an unseen level
    te_r, te_p = frames(te)
    assert_assignments(m_p, m_r, te_p, te_r, "carried across")
    with _one_device():
        mr = m_r.model_performance(te_r)
    assert_metrics(m_p.model_performance(te_p), mr, "carried across")
