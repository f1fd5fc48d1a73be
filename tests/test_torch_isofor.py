"""Isolation Forest in the PyTorch port (on the CPU) against the
reference package.

The two packages draw from different generators, so growth is held from
the reference's own draws: the reference grows a tree with a bag and a
key, and the port grows from that tree's feature, threshold and NA
direction at every node with the same bag. ``is_split``, ``leaf_cnt``
and the routed thresholds must be EXACT and ``leaf`` (c(n), the port's
float32 log is the reference's bit for bit) EXACT too. A reference
forest carried across must score within 1e-6 (mean length, score) and
keep its path-length bounds. Whole fits of both packages must find the
planted anomalies (AUC >= 0.95) and rank the rows alike (Spearman >=
0.9).

The reference's whole fits run on a one-device mesh (``_one_device``):
its tree loop dispatches every tree without waiting, and on the suite's
8 virtual CPU devices those programs' all-reduces can be in flight
together, where XLA:CPU's rendezvous can abort the process ("Fatal Python
error: Aborted" in the fit, a crashed xdist worker). On one device there
is no collective, and the fit is the same algorithm."""

import contextlib


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.frame.binning import bin_frame as ref_bin_frame
from h2o3_tpu.models import isofor as ref_iso
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.frame.binning import bin_frame
from h2o3_tpu_torch.models import isofor
from h2o3_tpu_torch.models.convert import isofor_model_from_arrays
from h2o3_tpu_torch.models.tree import Tree


def anomaly_cols(n=8000, frac=0.01, seed=3):
    """Four numeric features (NAs in x3) and a categorical, with
    ``frac`` of the rows planted far out in x0..x2; returns (cols,
    categorical, is_anomaly)."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 4)
    bad = np.zeros(n, bool)
    bad[r.choice(n, int(frac * n), replace=False)] = True
    X[bad, :3] = r.uniform(4.0, 7.0, (bad.sum(), 3)) \
        * r.choice([-1.0, 1.0], (bad.sum(), 3))
    X[r.rand(n) < 0.03, 3] = np.nan
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["c"] = r.choice(["a", "b", "c"], n)
    return cols, ["c"], bad


@contextlib.contextmanager
def _one_device():
    """The reference's frames and fits on a one-device mesh."""
    token = ref_mesh._MESH_OVERRIDE.set(
        ref_mesh.make_mesh(jax.devices()[:1]))
    try:
        yield
    finally:
        ref_mesh._MESH_OVERRIDE.reset(token)


def _frames(cols, cats):
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=cats),
            h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                            device="cpu"))


def auc(score, bad) -> float:
    """Probability that a planted row outscores a normal one."""
    order = np.argsort(score, kind="stable")
    ranks = np.empty(len(score))
    ranks[order] = np.arange(1, len(score) + 1)
    npos, nneg = bad.sum(), (~bad).sum()
    return (ranks[bad].sum() - npos * (npos + 1) / 2) / (npos * nneg)


def spearman(a, b) -> float:
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    return float(np.corrcoef(ra, rb)[0, 1])


def test_path_correction_equals_the_reference():
    n = np.concatenate([np.arange(0, 5000, dtype=np.float32),
                        np.random.RandomState(0).rand(5000).astype(
                            np.float32) * 1e5])
    ref = np.asarray(ref_iso._avg_path_correction(jnp.asarray(n)))
    got = isofor.avg_path_correction(torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("depth,bag", [(8, 256), (6, 2000)])
def test_growth_from_reference_draws_exact(depth, bag):
    cols, cats, _ = anomaly_cols(n=6000)
    fr_r, fr_p = _frames(cols, cats)
    x = list(cols)
    b_r = ref_bin_frame(fr_r, x, nbins=64, nbins_cats=64,
                        histogram_type="uniform")
    b_p = bin_frame(fr_p, x, nbins=64, nbins_cats=64,
                    histogram_type="uniform")
    B = b_p.nbins_total
    assert B == b_r.nbins_total
    r = np.random.RandomState(depth)
    keep = np.zeros(6000, np.float32)
    keep[r.choice(6000, bag, replace=False)] = 1.0
    w_r = np.pad(keep, (0, b_r.bins.shape[0] - 6000))
    w_p = np.pad(keep, (0, b_p.bins.shape[0] - 6000))
    for k in range(3):
        t_r = ref_iso._grow_random_tree(
            b_r.bins, b_r.nbins, jnp.asarray(w_r), jax.random.PRNGKey(k),
            depth=depth, B=B)
        t_p = isofor.grow_isolation_tree(
            b_p.bins, torch.from_numpy(w_p),
            torch.from_numpy(np.array(t_r.feat)),
            torch.from_numpy(np.array(t_r.thresh)),
            torch.from_numpy(np.array(t_r.na_left)), B=B)
        for f in ("feat", "thresh", "na_left", "is_split", "leaf_w",
                  "leaf"):
            np.testing.assert_array_equal(getattr(t_p, f).numpy(),
                                          np.asarray(getattr(t_r, f)),
                                          err_msg=f)
        assert t_p.is_split.sum() > 10
        # the scoring walk of one tree: every row's path length
        np.testing.assert_array_equal(
            isofor.tree_path_length(t_p, b_p.bins, B).numpy()[:6000],
            np.asarray(ref_iso._tree_path_length(t_r, b_r.bins, B))[:6000])


def test_draws_follow_the_reference_layout():
    gen = torch.Generator().manual_seed(5)
    nb = torch.tensor([64, 10, 3, 1], dtype=torch.int32)
    d = isofor.draw_tree(gen, nb, 6, "cpu")
    assert d["feat"].shape == (6, 32)
    for lvl in range(6):
        L = 2 ** lvl
        assert (d["feat"][lvl, L:] == 0).all()
        assert not d["na_left"][lvl, L:].any()
        f = d["feat"][lvl, :L].long()
        assert (d["thresh"][lvl, :L] < torch.clamp_min(nb[f] - 1, 1)).all()


def _ref_arrays(m_r) -> dict:
    d = {f: np.asarray(getattr(m_r.forest, f)) for f in Tree._fields}
    bm = m_r.bm
    d.update(edges=np.asarray(bm.edges), nbins=np.asarray(bm.nbins),
             is_cat=np.asarray(bm.is_cat), names=list(bm.names),
             domains=list(bm.domains), nbins_total=bm.nbins_total,
             nbins_cats=bm.nbins_cats, c_norm=m_r.c_norm,
             min_path_length=m_r.output["min_path_length"],
             max_path_length=m_r.output["max_path_length"])
    return d


def test_reference_forest_carried_across_scores_alike():
    cols, cats, _ = anomaly_cols(n=5000)
    test_cols, _, _ = anomaly_cols(n=3000, seed=9)
    with _one_device():
        fr_r, _ = _frames(cols, cats)
        m_r = ref_iso.IsolationForestEstimator(ntrees=12, seed=4).train(
            fr_r)
        te_r, te_p = _frames(test_cols, cats)
        p_r = m_r.predict(te_r)
        mr = m_r.model_performance(te_r)
    model = isofor_model_from_arrays(_ref_arrays(m_r), device="cpu")
    assert (model.output["min_path_length"],
            model.output["max_path_length"]) == (
        m_r.output["min_path_length"], m_r.output["max_path_length"])
    p_p = model.predict(te_p)
    for c in ("predict", "mean_length"):
        np.testing.assert_allclose(p_p.col(c).to_numpy(),
                                   p_r.col(c).to_numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=c)
    mp = model.model_performance(te_p)
    for k in ("mean_score", "mean_length"):
        assert mp[k] == pytest.approx(mr[k], rel=1e-6), k


def test_full_fits_find_the_planted_anomalies():
    cols, cats, bad = anomaly_cols(n=10_000)
    # 100 trees: at 50 the two packages' forests, from their own draws,
    # rank the normal rows too differently for the 0.9 bound
    with _one_device():
        fr_r, fr_p = _frames(cols, cats)
        m_r = ref_iso.IsolationForestEstimator(ntrees=100, seed=1).train(
            fr_r)
        s_r = m_r.predict(fr_r).col("predict").to_numpy()
    m_p = h2o3_tpu_torch.IsolationForestEstimator(ntrees=100,
                                                  seed=1).train(fr_p)
    s_p = m_p.predict(fr_p).col("predict").to_numpy()
    assert auc(s_r, bad) >= 0.95 and auc(s_p, bad) >= 0.95
    assert spearman(s_r, s_p) >= 0.9
    assert m_p.forest.feat.shape == (100, 8, 128)
    mn, mx = m_p.output["min_path_length"], m_p.output["max_path_length"]
    tot = m_p.predict(fr_p).col("mean_length").to_numpy() * 100
    assert mn == np.floor(tot.min()) and mx == np.ceil(tot.max())
    tm = m_p.training_metrics
    assert tm["mean_score"] == pytest.approx(s_p.mean(), rel=1e-5)
    assert 0.0 < tm["mean_score"] < 1.0


def test_same_seed_refit_is_bit_equal_and_seeds_differ():
    cols, cats, _ = anomaly_cols(n=3000)
    _, fr = _frames(cols, cats)
    a = h2o3_tpu_torch.IsolationForestEstimator(ntrees=5, seed=2).train(fr)
    b = h2o3_tpu_torch.IsolationForestEstimator(ntrees=5, seed=2).train(fr)
    c = h2o3_tpu_torch.IsolationForestEstimator(ntrees=5, seed=3).train(fr)
    for f in Tree._fields:
        assert torch.equal(getattr(a.forest, f), getattr(b.forest, f)), f
    assert a.training_metrics == b.training_metrics
    assert not torch.equal(a.forest.feat, c.forest.feat)


def test_surface_errors_and_partitioned_frame():
    with pytest.raises(ValueError, match="unknown IsolationForest params"):
        h2o3_tpu_torch.IsolationForestEstimator(not_a_param=1)
    cols, cats, _ = anomaly_cols(n=500)
    _, fr = _frames(cols, cats)
    # mtries and contamination are accepted and inert, as in the reference
    a = h2o3_tpu_torch.IsolationForestEstimator(ntrees=2, seed=1).train(fr)
    b = h2o3_tpu_torch.IsolationForestEstimator(
        ntrees=2, seed=1, mtries=2, contamination=0.1).train(fr)
    assert torch.equal(a.forest.thresh, b.forest.thresh)
    from h2o3_tpu_torch.parallel import mesh as mesh_mod
    fr.mesh = mesh_mod.Mesh(None, None, 0, 2)       # as if sharded
    with pytest.raises(NotImplementedError, match="sharded mesh"):
        h2o3_tpu_torch.IsolationForestEstimator(ntrees=1).train(fr)
