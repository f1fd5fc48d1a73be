"""Extended Isolation Forest in the PyTorch port (on the CPU) against the
reference package.

Growth is held from the reference's own draws: the reference grows a
tree with a bag and a key, and the port grows from that tree's normals
and offsets with the same bag; ``is_split`` and ``leaf`` (c of the leaf
counts) must be EXACT. The projections are float32 sums over F, which
the two packages may add in another order: ``proj < offset`` could
differ only at a near-tie, and this data has none. The NA-imputing means
(float32 rollup sums, another add order) agree within 1e-6 relative. A
reference forest carried across scores within 1e-6; whole fits of both
packages find the planted anomalies (AUC >= 0.95) and rank the rows
alike (Spearman >= 0.9).

The reference's whole fits run on a one-device mesh (``_one_device``).
Its tree loop dispatches every tree without waiting, and on the suite's
8 virtual CPU devices those programs' all-reduces can be in flight
together: XLA:CPU's rendezvous then waits on device threads that are
busy in another collective and, after 40 s, aborts the process ("Fatal
Python error: Aborted" in ``jnp.stack`` of the fit, a crashed xdist
worker). On one device there is no collective to wait on, and the fit
is the same algorithm on the same draws."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.frame.rollups import rollups as ref_rollups
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu.models import extisofor as ref_ext
from h2o3_tpu_torch.frame.rollups import rollup_mean
from h2o3_tpu_torch.models import extisofor
from h2o3_tpu_torch.models.convert import extisofor_model_from_arrays

from tests.test_torch_isofor import anomaly_cols, auc, spearman

NUM = ["x0", "x1", "x2", "x3"]


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


def test_rollup_mean_agrees_with_the_reference():
    cols, cats, _ = anomaly_cols(n=6000)
    fr_r, fr_p = _frames(cols, cats)
    for n in NUM:
        assert rollup_mean(fr_p.col(n)) == pytest.approx(
            ref_rollups(fr_r.col(n))["mean"], rel=1e-6, abs=1e-7), n
    empty = {"a": np.full(10, np.nan), "b": np.arange(10.0)}
    fr = h2o3_tpu_torch.Frame.from_numpy(empty, device="cpu")
    assert rollup_mean(fr.col("a")) == 0.0
    assert rollup_mean(fr.col("b")) == 4.5


@pytest.mark.parametrize("ext,bag", [(0, 256), (3, 256), (1, 1500)])
def test_growth_from_reference_draws_exact(ext, bag):
    cols, cats, _ = anomaly_cols(n=6000)
    fr_r, fr_p = _frames(cols, cats)
    X_r, means_r = ref_ext._feature_matrix(fr_r, NUM)
    X_p, means_p = extisofor.feature_matrix(fr_p, NUM)
    np.testing.assert_allclose(means_p, means_r, rtol=1e-6)
    np.testing.assert_allclose(X_p.numpy()[:6000], np.asarray(X_r)[:6000],
                               rtol=1e-6)
    lo, hi = jnp.min(X_r, axis=0), jnp.max(X_r, axis=0)
    r = np.random.RandomState(ext + bag)
    keep = np.zeros(6000, np.float32)
    keep[r.choice(6000, bag, replace=False)] = 1.0
    w_r = jnp.asarray(np.pad(keep, (0, X_r.shape[0] - 6000)))
    w_p = torch.from_numpy(np.pad(keep, (0, X_p.shape[0] - 6000)))
    depth = 8
    for k in range(3):
        t_r = ref_ext._grow_ext_tree(X_r, lo, hi, w_r, jax.random.PRNGKey(k),
                                     depth=depth, ext=ext)
        t_p = extisofor.grow_ext_tree(
            X_p, w_p, torch.from_numpy(np.array(t_r.normals)),
            torch.from_numpy(np.array(t_r.offsets)))
        np.testing.assert_array_equal(t_p.is_split.numpy(),
                                      np.asarray(t_r.is_split))
        np.testing.assert_array_equal(t_p.leaf.numpy(),
                                      np.asarray(t_r.leaf))
        assert t_p.is_split.sum() > 10
        nz = (np.asarray(t_r.normals) != 0).sum(axis=2)
        assert (nz[np.asarray(t_r.is_split)] == ext + 1).all()


def test_box_of_the_padded_matrix():
    """lo/hi count the imputed mean, as the reference's padded rows do:
    the float32 mean of 1000 copies of 0.1 is not 0.1 (each package adds
    in its own order, within 1e-6), and each package's box reaches its
    mean."""
    cols = {"a": np.full(1000, 0.1), "b": np.linspace(-1.0, 1.0, 1000)}
    fr_r, fr_p = _frames(cols, [])
    X_r, means_r = ref_ext._feature_matrix(fr_r, ["a", "b"])
    X_p, means_p = extisofor.feature_matrix(fr_p, ["a", "b"])
    a32 = float(np.float32(0.1))
    for X, lo, hi, mu in ((X_r, jnp.min(X_r, axis=0), jnp.max(X_r, axis=0),
                           means_r[0]),
                          (X_p, *extisofor.value_box(X_p, means_p),
                           means_p[0])):
        assert mu != a32 and mu == pytest.approx(a32, rel=1e-6)
        assert (float(lo[0]), float(hi[0])) == (min(a32, mu), max(a32, mu))
    lo, hi = extisofor.value_box(X_p, means_p)
    d = extisofor.draw_tree(torch.Generator().manual_seed(0), lo, hi, 3, 1)
    assert d["normals"].shape == (3, 4, 2)
    assert (d["normals"][0, 1:] == 0).all()
    assert (d["offsets"][1, 2:] == 0).all()


def _ref_arrays(m_r) -> dict:
    f = m_r.forest
    return dict(normals=np.asarray(f.normals), offsets=np.asarray(f.offsets),
                is_split=np.asarray(f.is_split), leaf=np.asarray(f.leaf),
                means=list(m_r.means), features=list(m_r.features),
                c_norm=m_r.c_norm)


def test_reference_forest_carried_across_scores_alike():
    cols, cats, _ = anomaly_cols(n=5000)
    test_cols, _, _ = anomaly_cols(n=3000, seed=9)
    with _one_device():
        fr_r, _ = _frames(cols, cats)
        m_r = ref_ext.ExtendedIsolationForestEstimator(
            ntrees=12, extension_level=2, seed=4).train(fr_r)
        te_r, te_p = _frames(test_cols, cats)
        p_r = m_r.predict(te_r)
    model = extisofor_model_from_arrays(_ref_arrays(m_r), device="cpu")
    p_p = model.predict(te_p)
    for c in ("anomaly_score", "mean_length"):
        np.testing.assert_allclose(p_p.col(c).to_numpy(),
                                   p_r.col(c).to_numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=c)


@pytest.mark.parametrize("ext", [0, 3])
def test_full_fits_find_the_planted_anomalies(ext):
    cols, cats, bad = anomaly_cols(n=10_000)
    with _one_device():
        fr_r, fr_p = _frames(cols, cats)
        m_r = ref_ext.ExtendedIsolationForestEstimator(
            extension_level=ext, seed=1).train(fr_r)
        s_r = m_r.predict(fr_r).col("anomaly_score").to_numpy()
    m_p = h2o3_tpu_torch.ExtendedIsolationForestEstimator(
        extension_level=ext, seed=1).train(fr_p)
    assert m_p.features == m_r.features == NUM       # categorical dropped
    s_p = m_p.predict(fr_p).col("anomaly_score").to_numpy()
    assert auc(s_r, bad) >= 0.95 and auc(s_p, bad) >= 0.95
    assert spearman(s_r, s_p) >= 0.9
    assert m_p.forest.normals.shape == (100, 8, 128, 4)
    assert m_p.training_metrics["mean_score"] == pytest.approx(
        float(s_p.mean()), rel=1e-6)


def test_same_seed_refit_is_bit_equal():
    cols, cats, _ = anomaly_cols(n=3000)
    _, fr = _frames(cols, cats)
    a, b = (h2o3_tpu_torch.ExtendedIsolationForestEstimator(
        ntrees=5, extension_level=1, seed=2).train(fr) for _ in range(2))
    for x, y in zip(a.forest, b.forest):
        assert torch.equal(x, y)
    assert a.training_metrics == b.training_metrics


def test_surface_errors_and_partitioned_frame():
    cols, cats, _ = anomaly_cols(n=500)
    fr_r, fr = _frames(cols, cats)
    for bad in (-1, 4):
        with pytest.raises(ValueError, match=r"extension_level must be in "
                                             r"\[0, 3\]"):
            ref_ext.ExtendedIsolationForestEstimator(
                extension_level=bad).train(fr_r)
        with pytest.raises(ValueError, match=r"extension_level must be in "
                                             r"\[0, 3\]"):
            h2o3_tpu_torch.ExtendedIsolationForestEstimator(
                extension_level=bad).train(fr)
    with pytest.raises(ValueError, match="unknown ExtendedIsolationForest"):
        h2o3_tpu_torch.ExtendedIsolationForestEstimator(not_a_param=1)
    from h2o3_tpu_torch.parallel import mesh as mesh_mod
    fr.mesh = mesh_mod.Mesh(None, None, 0, 2)       # as if sharded
    with pytest.raises(NotImplementedError, match="sharded mesh"):
        h2o3_tpu_torch.ExtendedIsolationForestEstimator(ntrees=1).train(fr)
