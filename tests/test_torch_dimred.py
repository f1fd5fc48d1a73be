"""PCA, SVD and GLRM in the PyTorch port (on the CPU) against the
reference package.

The same seeded low-rank numpy data (4,096 rows, which the reference
does not pad; NAs among the numerics, a categorical) go through both.
Eigenvectors have no sign (LAPACK under torch and JAX may pick either),
so vectors and scores are compared up to a sign a column (``sign_fit``),
and only where the compared eigenvalues lie at least 10% apart
(``assert_gaps``, checked on the reference's values). Eigen- and singular
values are held within 1e-4 relative, vectors and scores within
1e-4·max(1, |v|). Randomized PCA runs on the reference's Ω (fed into
``pca.draw_omega``) and is held by subspace: the singular values of
V_port' V_ref at least 1 − 1e-4. GLRM's sums run in another float32
order (GEMMs here, einsums there): objectives within 1e-4 relative, A·Y
within 1e-3·max(1, |X|), iteration counts equal; its L1 and NonNegative
fits start from the reference's random Y (fed into ``glrm.draw_init_y``),
where no sign is free. The reference's fits run on a one-device mesh.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import glrm as ref_glrm
from h2o3_tpu.models import pca as ref_pca
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.models import glrm, pca
from h2o3_tpu_torch.models.convert import (glrm_model_from_arrays,
                                           pca_model_from_arrays,
                                           svd_model_from_arrays)

VAL_TOL = 1e-4
VEC_TOL = 1e-4
OBJ_TOL = 1e-4
AY_TOL = 1e-3
NUM = ["x0", "x1", "x2", "x3", "x4", "x5"]


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


def lowrank_cols(n=4096, seed=0, na=0.03):
    """Six numerics from a rank-3 signal (singular values 4 : 2.5 : 1.5)
    plus noise, on unequal scales, NAs at rate ``na``, and a categorical
    following the first factor."""
    r = np.random.RandomState(seed)
    U = r.randn(n, 3) * np.array([4.0, 2.5, 1.5])
    V = np.linalg.qr(r.randn(6, 3))[0]
    X = U @ V.T + 0.1 * r.randn(n, 6)
    X = X * np.array([1.0, 3.0, 0.5, 2.0, 1.0, 8.0]) + np.arange(6)
    X[r.rand(n, 6) < na] = np.nan
    c = np.array(["lo", "mid", "hi"], object)[np.digitize(U[:, 0], [-2, 2])]
    cols = {name: X[:, i] for i, name in enumerate(NUM)}
    cols["c"] = c
    return cols


def frames(cols):
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=["c"])
    return fr_r, h2o3_tpu_torch.Frame.from_numpy(cols, categorical=["c"],
                                                 device="cpu")


def assert_gaps(vals, k):
    """The first k + 1 values lie at least 10% apart."""
    v = np.asarray(vals, np.float64)[:k + 1]
    assert (v[1:] <= 0.9 * v[:-1]).all(), v


def sign_fit(port, ref):
    """``port`` [n, k] with each column's sign turned to ``ref``'s."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    s = np.sign((port * ref).sum(0))
    return port * np.where(s == 0, 1.0, s)


def assert_close_up_to_sign(port, ref, tol=VEC_TOL, label=""):
    ref = np.asarray(ref, np.float64)
    gap = np.abs(sign_fit(port, ref) - ref) / np.maximum(1.0, np.abs(ref))
    assert gap.max() <= tol, (label, gap.max())


def score_matrix(pred_frame, prefix, k):
    cols = [pred_frame.col(f"{prefix}{i + 1}") for i in range(k)]
    return np.stack([c.to_numpy() for c in cols], 1)


def ref_scores(model, fr, prefix, k):
    with _one_device():
        p = model.predict(fr).to_pandas()
    return np.stack([p[f"{prefix}{i + 1}"].to_numpy() for i in range(k)], 1)


@pytest.mark.parametrize("transform,all_levels", [
    ("standardize", False), ("standardize", True), ("none", False)])
def test_pca_gramsvd_matches_the_reference(transform, all_levels):
    cols = lowrank_cols(seed=1)
    fr_r, fr_p = frames(cols)
    kw = dict(k=3, transform=transform, use_all_factor_levels=all_levels)
    with _one_device():
        m_r = ref_pca.PCAEstimator(**kw).train(fr_r)
    m_p = h2o3_tpu_torch.PCAEstimator(**kw).train(fr_p)
    sd_r = np.asarray(m_r.output["std_deviation"])
    assert_gaps(sd_r ** 2, 2)
    assert m_p.output["coef_names"] == m_r.output["coef_names"]
    np.testing.assert_allclose(m_p.output["std_deviation"], sd_r,
                               rtol=VAL_TOL)
    np.testing.assert_allclose(m_p.output["pct_variance"],
                               m_r.output["pct_variance"], rtol=VAL_TOL)
    assert_close_up_to_sign(m_p.output["eigenvectors"],
                            m_r.output["eigenvectors"], label="vectors")
    assert_close_up_to_sign(score_matrix(m_p.predict(fr_p), "PC", 3),
                            ref_scores(m_r, fr_r, "PC", 3), label="scores")
    assert m_p.training_metrics["pct_variance_explained"] == pytest.approx(
        m_r.training_metrics["pct_variance_explained"], rel=VAL_TOL)


def test_randomized_pca_spans_the_references_subspace(monkeypatch):
    monkeypatch.setattr(pca, "draw_omega", lambda seed, P, k: torch.from_numpy(
        np.array(jax.random.normal(jax.random.PRNGKey(seed), (P, k),
                                   jnp.float32))))
    cols = lowrank_cols(seed=2)
    fr_r, fr_p = frames(cols)
    kw = dict(k=3, pca_method="Randomized", seed=5, max_iterations=4)
    with _one_device():
        m_r = ref_pca.PCAEstimator(**kw).train(fr_r)
    m_p = h2o3_tpu_torch.PCAEstimator(**kw).train(fr_p)
    np.testing.assert_allclose(m_p.output["std_deviation"],
                               m_r.output["std_deviation"], rtol=VAL_TOL)
    np.testing.assert_allclose(m_p.output["pct_variance"],
                               m_r.output["pct_variance"], rtol=VAL_TOL)
    Vp = np.asarray(m_p.output["eigenvectors"], np.float64)
    Vr = np.asarray(m_r.output["eigenvectors"], np.float64)
    cosines = np.linalg.svd(Vp.T @ Vr, compute_uv=False)
    assert cosines.min() >= 1 - 1e-4, cosines


def test_svd_matches_the_reference():
    cols = lowrank_cols(seed=3)
    fr_r, fr_p = frames(cols)
    kw = dict(nv=3, transform="standardize")
    with _one_device():
        m_r = ref_pca.SVDEstimator(**kw).train(fr_r)
    m_p = h2o3_tpu_torch.SVDEstimator(**kw).train(fr_p)
    assert_gaps(np.asarray(m_r.output["d"]) ** 2, 2)
    np.testing.assert_allclose(m_p.output["d"], m_r.output["d"],
                               rtol=VAL_TOL)
    assert_close_up_to_sign(m_p.output["v"], m_r.output["v"],
                            label="vectors")
    assert_close_up_to_sign(score_matrix(m_p.predict(fr_p), "u", 3),
                            ref_scores(m_r, fr_r, "u", 3), label="u")


def test_pca_and_svd_carried_across_score_alike():
    cols = lowrank_cols(seed=4)
    fr_r, _ = frames(cols)
    te = lowrank_cols(n=1200, seed=5)
    te["c"][:25] = "zzz"                           # an unseen level
    te_r, te_p = frames(te)
    with _one_device():
        pm = ref_pca.PCAEstimator(k=3).train(fr_r)
        sm = ref_pca.SVDEstimator(nv=2).train(fr_r)
    common = lambda m: dict(di_stats=m.di_stats, features=m.features,
                            transform=m.transform,
                            use_all_levels=m.use_all_levels,
                            output=m.output, params=m.params)
    p_p = pca_model_from_arrays(dict(eigvecs=np.asarray(pm.eigvecs),
                                     **common(pm)))
    s_p = svd_model_from_arrays(dict(V=np.asarray(sm.V), **common(sm)))
    np.testing.assert_allclose(score_matrix(p_p.predict(te_p), "PC", 3),
                               ref_scores(pm, te_r, "PC", 3), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(score_matrix(s_p.predict(te_p), "u", 2),
                               ref_scores(sm, te_r, "u", 2), rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------- GLRM


@pytest.fixture
def ref_y(monkeypatch):
    """Feeds the reference's random init into the port."""
    monkeypatch.setattr(glrm, "draw_init_y", lambda seed, k, P:
                        torch.from_numpy(np.array(jax.random.normal(
                            jax.random.PRNGKey(seed), (k, P),
                            jnp.float32))))


def reconstruction(m, fr):
    return np.stack([c.to_numpy() for c in
                     (m.reconstruct(fr).col(n) for n in
                      m.output["coef_names"])], 1)


def ref_reconstruction(m, fr):
    with _one_device():
        return m.reconstruct(fr).to_pandas().to_numpy()


def assert_glrm(m_p, m_r, fr_p, fr_r, signed: bool):
    assert m_p.output["iterations"] == m_r.output["iterations"]
    assert m_p.output["objective"] == pytest.approx(
        m_r.output["objective"], rel=OBJ_TOL)
    assert m_p.training_metrics["MSE"] == pytest.approx(
        m_r.training_metrics["MSE"], rel=OBJ_TOL)
    ay_r = ref_reconstruction(m_r, fr_r)
    gap = np.abs(reconstruction(m_p, fr_p) - ay_r) / np.maximum(
        1.0, np.abs(ay_r))
    assert gap.max() <= AY_TOL, gap.max()
    Y_p = np.asarray(m_p.output["archetypes"]).T
    Y_r = np.asarray(m_r.output["archetypes"]).T
    if not signed:
        Y_p = sign_fit(Y_p, Y_r)
    np.testing.assert_allclose(Y_p, Y_r, atol=AY_TOL, rtol=AY_TOL)


def test_glrm_quadratic_matches_the_reference():
    cols = lowrank_cols(seed=6, na=0.05)
    fr_r, fr_p = frames(cols)
    kw = dict(k=3, transform="standardize", regularization_x="Quadratic",
              regularization_y="Quadratic", gamma_x=0.1, gamma_y=0.1)
    with _one_device():
        m_r = ref_glrm.GLRMEstimator(**kw).train(fr_r)
    m_p = h2o3_tpu_torch.GLRMEstimator(**kw).train(fr_p)
    assert m_p.output["coef_names"] == m_r.output["coef_names"]
    assert_glrm(m_p, m_r, fr_p, fr_r, signed=False)
    assert_close_up_to_sign(score_matrix(m_p.predict(fr_p), "Arch", 3),
                            ref_scores(m_r, fr_r, "Arch", 3), tol=AY_TOL,
                            label="Arch")


@pytest.mark.parametrize("regx,regy", [("L1", "None"),
                                       ("NonNegative", "NonNegative"),
                                       ("None", "L1")])
def test_glrm_regularizers_match_the_reference(regx, regy, ref_y):
    cols = lowrank_cols(n=2048, seed=7, na=0.05)
    fr_r, fr_p = frames(cols)
    kw = dict(k=3, transform="standardize", init="Random", seed=11,
              regularization_x=regx, regularization_y=regy, gamma_x=0.05,
              gamma_y=0.05, max_iterations=30)
    with _one_device():
        m_r = ref_glrm.GLRMEstimator(**kw).train(fr_r)
    m_p = h2o3_tpu_torch.GLRMEstimator(**kw).train(fr_p)
    assert_glrm(m_p, m_r, fr_p, fr_r, signed=True)


def test_glrm_carried_across_scores_alike():
    cols = lowrank_cols(seed=8, na=0.05)
    fr_r, _ = frames(cols)
    with _one_device():
        m_r = ref_glrm.GLRMEstimator(k=3, transform="standardize").train(
            fr_r)
    m_p = glrm_model_from_arrays(dict(
        Y=np.asarray(m_r.Y), di_stats=m_r.di_stats, features=m_r.features,
        transform=m_r.transform, output=m_r.output, params=m_r.params))
    te = lowrank_cols(n=1500, seed=9, na=0.1)
    te_r, te_p = frames(te)
    np.testing.assert_allclose(score_matrix(m_p.predict(te_p), "Arch", 3),
                               ref_scores(m_r, te_r, "Arch", 3), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(reconstruction(m_p, te_p),
                               ref_reconstruction(m_r, te_r), rtol=1e-4,
                               atol=1e-4)
