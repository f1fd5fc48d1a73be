"""GLM in the PyTorch port (on the CPU) against the reference package.

The same seeded numpy inputs go through the reference's functions and
the port's: the design matrix (within 1e-6, coefficient names, domains
and statistics equal), the Gram, each optimizer, every single-vector
family x link under IRLSM and each family under L-BFGS and COD, the
lambda path, the p-values, predictions and metrics, and a reference
model carried across. Float32 sums run in another order in the two
packages (the reference's Gram adds 8192-row blocks per device and then
across its 8 CPU devices, the port one SGEMM), so coefficients are held
within 1e-4·max(1, |c|) (tighter where the test says), probabilities
within 1e-5. Every frame has fewer than 32,768 rows, so the CPU's float32
reductions do not depend on its thread count; torch runs on one thread
here (``_one_thread``), where its small CPU ops are fastest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.frame.datainfo import build_datainfo as ref_build_datainfo
from h2o3_tpu.frame.datainfo import coef_stats as ref_coef_stats
from h2o3_tpu.frame.rollups import rollups as ref_rollups
from h2o3_tpu.models import glm as ref_glm
from h2o3_tpu.ops import gram as ref_gram
from h2o3_tpu.ops import optimize as ref_opt
from h2o3_tpu.parallel.mesh import get_mesh
from h2o3_tpu_torch.frame.datainfo import build_datainfo, coef_stats
from h2o3_tpu_torch.frame.rollups import rollup_mean_sigma
from h2o3_tpu_torch.models import glm
from h2o3_tpu_torch.models.convert import glm_model_from_arrays
from h2o3_tpu_torch.ops import gram as port_gram
from h2o3_tpu_torch.ops import optimize as port_opt

COEF_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames(cols, cats=()):
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=list(cats)),
            h2o3_tpu_torch.Frame.from_numpy(cols, categorical=list(cats),
                                            device="cpu"))


def mixed_cols(n=3000, seed=0, response="binomial", bias=0.0):
    """Three numerics (NAs in x2, x1 on a wide scale), two categoricals
    (NAs in c1) and a response of the asked kind (``bias`` added to its
    linear predictor)."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 3)
    X[:, 1] = 40.0 + 15.0 * X[:, 1]
    c0 = r.choice(["red", "green", "blue", "grey"], n)
    c1 = r.choice(["a", "b", "c"], n).astype(object)
    eta = (0.8 * X[:, 0] - 0.02 * (X[:, 1] - 40) + 0.3 * X[:, 2]
           + 0.6 * (c0 == "green") - 0.4 * (c1 == "c") + bias)
    X[r.rand(n) < 0.05, 2] = np.nan
    c1[r.rand(n) < 0.04] = None
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "c0": c0, "c1": c1}
    if response == "binomial":
        cols["y"] = np.array(["no", "yes"], object)[
            (r.rand(n) < 1 / (1 + np.exp(-eta))).astype(int)]
    else:
        cols["y"] = 2.0 + eta + 0.3 * r.randn(n)
    return cols


def assert_coefs(c_port: dict, c_ref: dict, tol=COEF_TOL, label=""):
    """Names equal, values within ``tol``·max(1, |c|); where the
    reference's fit diverged to NaN the port's must too."""
    assert list(c_port) == list(c_ref), label
    for k in c_ref:
        if np.isnan(c_ref[k]):
            assert np.isnan(c_port[k]), (label, k, c_port[k])
            continue
        assert abs(c_port[k] - c_ref[k]) <= tol * max(1.0, abs(c_ref[k])), \
            (label, k, c_port[k], c_ref[k])


# ---------------------------------------------------------------- frame


def test_rollup_mean_and_sigma_agree_with_the_reference():
    cols = mixed_cols(n=5000)
    fr_r, fr_p = frames(cols, ["c0", "c1", "y"])
    for n in ("x0", "x1", "x2"):
        r = ref_rollups(fr_r.col(n))
        mu, sd = rollup_mean_sigma(fr_p.col(n))
        assert mu == pytest.approx(r["mean"], rel=1e-6, abs=1e-7), n
        assert sd == pytest.approx(r["sigma"], rel=1e-6), n
    one = h2o3_tpu_torch.Frame.from_numpy({"a": np.array([3.0, np.nan])},
                                          device="cpu")
    assert rollup_mean_sigma(one.col("a")) == (3.0, 0.0)


@pytest.mark.parametrize("standardize,all_levels",
                         [(True, False), (False, False), (True, True)])
def test_design_matrix_matches_the_reference(standardize, all_levels):
    cols = mixed_cols(n=4000, seed=1)
    x = ["x0", "c0", "x1", "c1", "x2"]
    fr_r, fr_p = frames(cols, ["c0", "c1", "y"])
    di_r = ref_build_datainfo(fr_r, x, standardize=standardize,
                              use_all_factor_levels=all_levels)
    di_p = build_datainfo(fr_p, x, standardize=standardize,
                          use_all_factor_levels=all_levels)
    assert di_p.coef_names == di_r.coef_names
    assert di_p.domains == di_r.domains
    np.testing.assert_array_equal(di_p.cat_offsets, di_r.cat_offsets)
    # float32 sums in another order: means within 1e-6 of their column's
    # spread (a mean near 0 has no relative precision)
    np.testing.assert_allclose(di_p.num_means, di_r.num_means, rtol=1e-6,
                               atol=1e-6 * float(np.min(di_r.num_sigmas)))
    np.testing.assert_allclose(di_p.num_sigmas, di_r.num_sigmas, rtol=1e-6)
    np.testing.assert_allclose(di_p.X.numpy()[:4000],
                               np.asarray(di_r.X)[:4000], atol=1e-6,
                               rtol=1e-6)
    assert (di_p.X1[:, -1] == 1.0).all()
    for a, b in zip(coef_stats(di_p), ref_coef_stats(di_r)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * float(
            np.min(di_r.num_sigmas)))
    # a scoring frame with levels reordered, an unseen level and NAs,
    # adapted through the training stats
    r = np.random.RandomState(5)
    te = {"x0": r.randn(300), "x1": r.randn(300),
          "x2": np.where(r.rand(300) < 0.2, np.nan, r.randn(300)),
          "c0": r.choice(["blue", "violet", "red"], 300),
          "c1": r.choice(["c", "a"], 300)}
    te_r, te_p = frames(te, ["c0", "c1"])
    stats_r = ref_glm.stats_of(di_r)
    stats_p = {k: v for k, v in stats_r.items()}
    X_r = ref_build_datainfo(te_r, x, standardize=standardize,
                             use_all_factor_levels=all_levels,
                             stats_override=stats_r).X
    X_p = build_datainfo(te_p, x, standardize=standardize,
                         use_all_factor_levels=all_levels,
                         stats_override=stats_p).X
    np.testing.assert_allclose(X_p.numpy()[:300], np.asarray(X_r)[:300],
                               atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------- ops


def test_gram_matches_the_reference(monkeypatch):
    r = np.random.RandomState(2)
    X = r.randn(6000, 7).astype(np.float32)
    X[:, -1] = 1.0
    w = r.rand(6000).astype(np.float32)
    w[-40:] = 0.0                                   # padding rows
    z = r.randn(6000).astype(np.float32)
    want = ref_gram.gram(jnp.asarray(X), jnp.asarray(w), jnp.asarray(z),
                         mesh=get_mesh())
    monkeypatch.setattr(port_gram, "BLOCK_ROWS", 2048)    # three blocks
    got = port_gram.gram(torch.from_numpy(X), torch.from_numpy(w),
                         torch.from_numpy(z))
    monkeypatch.undo()
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=2e-5,
                                   atol=2e-4)
    # the blocked sums equal the unblocked ones within float32 order
    one = port_gram.gram(torch.from_numpy(X), torch.from_numpy(w),
                         torch.from_numpy(z))
    np.testing.assert_allclose(one[0].numpy(), got[0].numpy(), rtol=1e-5,
                               atol=1e-4)
    exact = (X.astype(np.float64) * w[:, None]).T @ X
    np.testing.assert_allclose(got[0].numpy(), exact, rtol=1e-5, atol=1e-3)


def _quadratic(P=9, seed=3):
    r = np.random.RandomState(seed)
    M = r.randn(50, P).astype(np.float32)
    A = (M.T @ M / 50).astype(np.float32)
    q = r.randn(P).astype(np.float32)
    pen = np.ones(P, np.float32)
    pen[-1] = 0.0
    return A, q, pen


def test_optimizers_match_the_reference():
    A, q, pen = _quadratic()
    jA, jq, jp = jnp.asarray(A), jnp.asarray(q), jnp.asarray(pen)
    tA, tq, tp = torch.from_numpy(A), torch.from_numpy(q), \
        torch.from_numpy(pen)
    x = np.linspace(-2, 2, 9).astype(np.float32)
    np.testing.assert_array_equal(
        port_opt.soft_threshold(torch.from_numpy(x), 0.5).numpy(),
        np.asarray(ref_opt.soft_threshold(jnp.asarray(x), 0.5)))
    for l1 in (0.0, 0.05, 0.3):
        want = ref_opt.admm_l1_quadratic(jA, jq, jnp.float32(l1), jp)
        got = port_opt.admm_l1_quadratic(tA, tq, torch.tensor(np.float32(l1)),
                                         tp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   err_msg=f"admm l1={l1}")
    for l2 in (0.0, 0.1):
        want = ref_opt.cholesky_solve_regularized(jA, jq, jnp.float32(l2), jp)
        got = port_opt.cholesky_solve_regularized(
            tA, tq, torch.tensor(np.float32(l2)), tp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    lo = np.full(9, -0.2, np.float32)
    hi = np.full(9, 0.25, np.float32)
    for l1, l2, box in ((0.0, 0.0, False), (0.05, 0.02, False),
                        (0.01, 0.0, True)):
        want = ref_opt.coordinate_descent_quadratic(
            jA, jq, jnp.float32(l1), jnp.float32(l2), jp,
            lower=jnp.asarray(lo) if box else None,
            upper=jnp.asarray(hi) if box else None, sweeps=50)
        got = port_opt.coordinate_descent_quadratic(
            tA, tq, torch.tensor(np.float32(l1)), torch.tensor(np.float32(l2)),
            tp, lower=torch.from_numpy(lo) if box else None,
            upper=torch.from_numpy(hi) if box else None, sweeps=50)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   err_msg=f"cod {l1} {l2} {box}")
    # L-BFGS: the same host float64 recursion, step for step
    A64, q64 = A.astype(np.float64), q.astype(np.float64)

    def vg(xv):
        return 0.5 * xv @ A64 @ xv - q64 @ xv, A64 @ xv - q64

    xr, fr_, nr = ref_opt.lbfgs(vg, np.zeros(9), max_iter=30)
    xp, fp, n_p = port_opt.lbfgs(vg, np.zeros(9), max_iter=30)
    np.testing.assert_array_equal(xp, xr)
    assert (fp, n_p) == (fr_, nr)


def test_a_factor_that_is_not_positive_definite_is_nan():
    """``cho_factor`` returns NaN (torch.linalg.cholesky would raise), as
    the reference's solve does: the NaN flows on."""
    A = np.array([[1., 2., 0.], [2., 1., 0.], [0., 0., 1.]], np.float32)
    q = np.ones(3, np.float32)
    pen = np.array([1., 1., 0.], np.float32)
    want = ref_opt.cholesky_solve_regularized(
        jnp.asarray(A), jnp.asarray(q), jnp.float32(0.0), jnp.asarray(pen))
    got = port_opt.cholesky_solve_regularized(
        torch.from_numpy(A), torch.from_numpy(q), torch.tensor(0.0),
        torch.from_numpy(pen))
    assert np.isnan(np.asarray(want)).all() and torch.isnan(got).all()
    got = port_opt.admm_l1_quadratic(torch.from_numpy(A), torch.from_numpy(q),
                                     torch.tensor(0.1), torch.from_numpy(pen),
                                     rho=-2.0)
    assert torch.isnan(got).all()


@pytest.mark.parametrize("seed", range(6))
def test_line_search_argmin_picks_as_jnp(seed):
    """Ties, infinities and NaNs: the first NaN, else the first of the
    tied minima (an overflowing candidate's inf objective included)."""
    r = np.random.RandomState(seed)
    p = np.array([.25, .25, .2, .05, .1 if seed % 2 else 0, .15])
    v = r.choice([1.0, 2.0, np.inf, -np.inf, np.nan, 0.5], 9, p=p / p.sum())
    v = v.astype(np.float32)
    assert int(glm.first_argmin(torch.from_numpy(v))) == \
        int(jnp.argmin(jnp.asarray(v))), v
    for v in ([np.inf] * 9, [3.0, np.inf, 3.0, 1.0, 1.0, 7, 7, 7, 1.0],
              [np.nan, 1.0, np.nan] + [0.0] * 6):
        v = np.asarray(v, np.float32)
        assert int(glm.first_argmin(torch.from_numpy(v))) == \
            int(jnp.argmin(jnp.asarray(v))), v


def test_a_step_that_overflows_the_log_link_is_rejected_alike():
    """A Poisson fit on an unstandardized wide-scale predictor: the first
    full Newton step drives exp(eta) into its clamp, the line search
    keeps a shorter step, and both packages end on the same
    coefficients."""
    r = np.random.RandomState(4)
    n = 3000
    x = r.randn(n) * 3.0
    y = r.poisson(np.exp(0.5 + 0.6 * x)).astype(float)
    fr_r, fr_p = frames({"x": x, "y": y})
    kw = dict(family="poisson", lambda_=0.0, standardize=False)
    m_r = ref_glm.GLMEstimator(**kw).train(fr_r, y="y")
    m_p = glm.GLMEstimator(**kw).train(fr_p, y="y")
    assert_coefs(m_p.coefficients, m_r.coefficients)
    assert m_p.coefficients["x"] == pytest.approx(0.6, abs=0.02)


# ------------------------------------------------------------- families


def family_cols(family: str, link: str, n=2500, seed=7):
    """Positive predictors and a response of ``family``'s domain whose
    mean stays inside the link's range."""
    r = np.random.RandomState(seed)
    x0 = r.rand(n) + 0.5
    x1 = r.rand(n)
    c = r.choice(["p", "q", "s"], n)
    eta_lin = 0.4 + 0.5 * x0 + 0.3 * x1 + 0.2 * (c == "q")
    if link in ("log", "tweedie"):
        mu = np.exp(eta_lin - 0.5)
    elif link == "inverse":
        mu = 1.0 / eta_lin
    elif link == "logit":
        mu = 1 / (1 + np.exp(-(2 * eta_lin - 2.2)))
    else:
        mu = eta_lin
    if family == "gaussian":
        y = mu + 0.1 * r.randn(n)
    elif family in ("binomial", "quasibinomial"):
        y = (r.rand(n) < mu).astype(float)
    elif family == "fractionalbinomial":
        y = np.clip(mu + 0.05 * r.randn(n), 0.0, 1.0)
    elif family in ("poisson", "negativebinomial"):
        y = r.poisson(mu).astype(float)
    elif family == "gamma":
        y = r.gamma(4.0, mu / 4.0)
    else:                                           # tweedie
        y = np.where(r.rand(n) < 0.3, 0.0, r.gamma(2.0, mu / 2.0))
    cols = {"x0": x0, "x1": x1, "c": c, "y": y}
    if family == "binomial":
        cols["y"] = np.array(["f", "t"], object)[y.astype(int)]
    return cols


FAMILY_LINKS = [("gaussian", "identity"), ("gaussian", "log"),
                ("gaussian", "inverse"), ("binomial", "logit"),
                ("quasibinomial", "logit"), ("fractionalbinomial", "logit"),
                ("poisson", "log"), ("poisson", "identity"),
                ("gamma", "log"), ("gamma", "identity"),
                ("gamma", "inverse"), ("tweedie", "tweedie"),
                ("negativebinomial", "log"), ("negativebinomial", "identity")]
DEFAULT_LINK = [fl for fl in FAMILY_LINKS if fl[1] == glm.Family(fl[0]).link]
# identity-link count families: the float32 deviance cannot tell points
# ~1e-4 apart here, so each package's line search stops where rounding
# stalls it (seen: 1.1e-5 and 2.9e-4 from the float64 MLE for the
# reference, 1.3e-4 and 5e-6 for the port)
STALL_TOL = {("poisson", "identity"): 1e-3,
             ("negativebinomial", "identity"): 1e-3}


def _fit_both(cols, cats, **kw):
    fr_r, fr_p = frames(cols, cats)
    m_r = ref_glm.GLMEstimator(**kw).train(fr_r, y="y")
    m_p = glm.GLMEstimator(**kw).train(fr_p, y="y")
    return m_r, m_p, fr_r, fr_p


@pytest.mark.parametrize("family,link", FAMILY_LINKS)
def test_irlsm_family_link_matches_the_reference(family, link):
    cols = family_cols(family, link)
    cats = ["c", "y"] if family == "binomial" else ["c"]
    # beta_epsilon 1e-6: with the default 1e-4 one package may stop an
    # iteration before the other, a step of up to 1e-4 apart
    kw = dict(family=family, link=link, lambda_=0.0, solver="irlsm",
              beta_epsilon=1e-6,
              theta=0.5 if family == "negativebinomial" else 1e-5)
    m_r, m_p, fr_r, fr_p = _fit_both(cols, cats, **kw)
    assert_coefs(m_p.coefficients, m_r.coefficients,
                 tol=STALL_TOL.get((family, link), COEF_TOL),
                 label=family + link)
    key = "AUC" if family == "binomial" else "mean_residual_deviance"
    want, got = m_r.training_metrics[key], m_p.training_metrics[key]
    if np.isnan(want):            # from a zero start the inverse link
        assert np.isnan(got)      # diverges in both packages
    else:
        assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("family,link", DEFAULT_LINK)
@pytest.mark.parametrize("solver", ["l_bfgs", "coordinate_descent"])
def test_lbfgs_and_cod_families_match_the_reference(family, link, solver):
    cols = family_cols(family, link, seed=8)
    cats = ["c", "y"] if family == "binomial" else ["c"]
    kw = dict(family=family, lambda_=0.0, solver=solver,
              theta=0.5 if family == "negativebinomial" else 1e-5,
              max_iterations=60 if solver == "l_bfgs" else 10)
    m_r, m_p, _, _ = _fit_both(cols, cats, **kw)
    # L-BFGS: float32 gradients through a float64 host recursion; its
    # iterates agree to float32 order, its line search may stop a step
    # apart near the optimum
    assert_coefs(m_p.coefficients, m_r.coefficients,
                 tol=2e-3 if solver == "l_bfgs" else COEF_TOL,
                 label=f"{family} {solver}")


# ---------------------------------------------------------- lambda path


@pytest.mark.parametrize("alpha,family", [(0.5, "gaussian"),
                                          (1.0, "binomial")])
def test_lambda_path_matches_the_reference(alpha, family):
    # off-centre classes: at lambda_max the intercept has far to go, so
    # the line search's candidates are not near-tied there
    cols = mixed_cols(n=3000, seed=2, response=family, bias=1.5)
    cats = ["c0", "c1"] + (["y"] if family == "binomial" else [])
    kw = dict(family=family, alpha=alpha, lambda_search=True, nlambdas=8,
              lambda_min_ratio=1e-3)
    m_r, m_p, _, _ = _fit_both(cols, cats, **kw)
    np.testing.assert_allclose(m_p._lambda_path_vals, m_r._lambda_path_vals,
                               rtol=1e-5)
    assert len(m_p._lambda_path_vals) == 8
    path_r = np.asarray(m_r._coef_path)
    np.testing.assert_allclose(m_p._coef_path, path_r, rtol=COEF_TOL,
                               atol=COEF_TOL)
    assert m_p.output["lambda_best"] == pytest.approx(
        m_r.output["lambda_best"], rel=1e-5)
    assert_coefs(m_p.coefficients, m_r.coefficients)
    # L1 zeroes coefficients at the largest lambda
    assert (np.abs(path_r[0][:-1]) < 1e-6).all()
    assert (np.abs(m_p._coef_path[0][:-1]) < 1e-6).all()


# ------------------------------------------------------------- p-values


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
def test_p_values_table_matches_the_reference(family):
    cols = mixed_cols(n=3000, seed=3, response=family)
    cats = ["c0", "c1"] + (["y"] if family == "binomial" else [])
    kw = dict(family=family, lambda_=0.0, compute_p_values=True)
    m_r, m_p, _, _ = _fit_both(cols, cats, **kw)
    t_r = m_r.output["coefficients_table"]
    t_p = m_p.output["coefficients_table"]
    assert [r["name"] for r in t_p] == [r["name"] for r in t_r]
    for a, b in zip(t_p, t_r):
        # z = coefficient / std_error carries the coefficient's float32
        # error divided by a small std_error
        for k, tol in (("coefficient", 1e-5), ("std_error", 1e-5),
                       ("z_value", 1e-3)):
            assert a[k] == pytest.approx(b[k], rel=1e-3, abs=tol), (k, a, b)
        assert a["p_value"] == pytest.approx(b["p_value"], rel=1e-2,
                                             abs=1e-3), (a, b)
    with pytest.raises(ValueError, match="requires no regularization"):
        glm.GLMEstimator(family=family, lambda_=0.1,
                         compute_p_values=True).train(frames(cols, cats)[1],
                                                      y="y")


# ------------------------------------------------- predictions, metrics


def test_predictions_and_metrics_match_the_reference():
    cols = mixed_cols(n=4000, seed=4)
    te = mixed_cols(n=1000, seed=9)
    te["c0"][:50] = "violet"                        # unseen level
    m_r, m_p, _, _ = _fit_both(cols, ["c0", "c1", "y"], family="binomial",
                               lambda_=1e-3, alpha=0.3)
    te_r, te_p = frames(te, ["c0", "c1", "y"])
    p_r = m_r.predict(te_r).to_pandas()
    p_p = m_p.predict(te_p)
    np.testing.assert_allclose(p_p.col("p1").to_numpy(),
                               p_r["p1"].to_numpy(), atol=1e-5)
    t = m_r.output["default_threshold"]
    assert m_p.output["default_threshold"] == t
    away = np.abs(p_r["p1"].to_numpy() - t) > 1e-4
    pred_r = np.array([m_r.output["domain"].index(v)
                       for v in p_r["predict"]])
    np.testing.assert_array_equal(
        p_p.col("predict").to_numpy()[away], pred_r[away])
    mr, mp = m_r.model_performance(te_r), m_p.model_performance(te_p)
    for k in ("AUC", "logloss", "MSE", "pr_auc"):
        assert mp[k] == pytest.approx(mr[k], rel=1e-5, abs=1e-6), k
    for k in ("AUC", "logloss"):
        assert m_p.training_metrics[k] == pytest.approx(
            m_r.training_metrics[k], rel=1e-5), k
    # regression
    cols = mixed_cols(n=4000, seed=5, response="gaussian")
    m_r, m_p, fr_r, fr_p = _fit_both(cols, ["c0", "c1"], family="gaussian",
                                     lambda_=0.0)
    np.testing.assert_allclose(
        m_p.predict(fr_p).col("predict").to_numpy(),
        m_r.predict(fr_r).to_pandas()["predict"].to_numpy(), rtol=1e-5,
        atol=1e-5)
    for k in ("MSE", "mae", "r2", "mean_residual_deviance"):
        assert m_p.training_metrics[k] == pytest.approx(
            m_r.training_metrics[k], rel=1e-5), k


# ------------------------------------------------------------ conversion


def ref_arrays(m) -> dict:
    return dict(coef=np.asarray(m.coef),
                coef_multinomial=(None if m.coef_multinomial is None
                                  else np.asarray(m.coef_multinomial)),
                family=m.family.name, link=m.family.link,
                tweedie_power=float(m.family.p), theta=float(m.family.theta),
                di_stats=m.di_stats, features=list(m.features),
                output=dict(m.output), params=dict(m.params))


@pytest.mark.parametrize("kind", ["binomial", "gaussian", "multinomial",
                                  "ordinal"])
def test_reference_model_carried_across_predicts_alike(kind):
    cols = mixed_cols(n=3000, seed=6, response="gaussian"
                      if kind == "gaussian" else "binomial")
    cats = ["c0", "c1"]
    kw = dict(lambda_=0.0)
    if kind in ("multinomial", "ordinal"):
        cols["y"] = np.array(["lo", "mid", "hi"], object)[
            np.digitize(cols["x0"] + 0.5 * cols["x2"].clip(-3, 3),
                        [-0.4, 0.5])]
        kw["family"] = kind
    if kind != "gaussian":
        cats.append("y")
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    m_r = ref_glm.GLMEstimator(**kw).train(fr_r, y="y")
    m_p = glm_model_from_arrays(ref_arrays(m_r))
    te = mixed_cols(n=800, seed=12)
    te["c1"][:30] = "zzz"                            # unseen level
    te.pop("y")
    te_r, te_p = frames(te, ["c0", "c1"])
    p_r = m_r.predict(te_r).to_pandas()
    p_p = m_p.predict(te_p)
    for c in p_r.columns:
        want = p_r[c].to_numpy()
        if c == "predict" and m_r.output["domain"]:
            want = np.array([m_r.output["domain"].index(v) for v in want])
            np.testing.assert_array_equal(p_p.col(c).to_numpy(), want)
            continue
        np.testing.assert_allclose(p_p.col(c).to_numpy(),
                                   want.astype(np.float64), atol=1e-6,
                                   err_msg=c)
    assert m_p.coefficients == pytest.approx(m_r.coefficients, abs=1e-12)
