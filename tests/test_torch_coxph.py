"""CoxPH in the PyTorch port (on the CPU) against the reference package.

The risk-set structure is host numpy in both packages and EXACT: the
sort orders, tie groups, ranks and gather positions, with strata, start
times, heavy ties and NaN times. The port places a stratum's groups with
one search, not one a group: 400,000 rows with 12,000 tie groups take
well under 10 s (the reference's loop takes minutes there).

The objective at a fixed beta agrees within 1e-5 relative; the port's
closed-form gradient and Hessian agree with ``jax.grad`` and
``jax.hessian`` of the reference's objective within 1e-4 of their
largest entry.

Fits: the port's sums are float64 and in a fixed order (row-permuted
port fits are equal to the last bits), the reference's float32. Its
row-permuted fits of the tests' Efron data without strata move the
coefficients by up to 9.5e-4, and the port lies as far from it, so the
coefficients are held within 2e-3 (COEF_TOL), ``se_coef`` within 1e-3
relative, ``loglik`` within 1e-6 relative and the centred linear
predictor within 1e-2. The concordance of the same linear predictor is
EXACT; the models' concordances (of their own lp) agree within 1e-4.
The reference's fits run on a one-device mesh (``_one_device``)."""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import coxph as ref_cox
from h2o3_tpu_torch.models import coxph as port_cox
from h2o3_tpu_torch.models.convert import coxph_model_from_arrays

from test_torch_isofor import _one_device
from torch_threads import one_torch_thread  # noqa: F401 - autouse

COEF_TOL = 2e-3
SE_REL = 1e-3
LOGLIK_REL = 1e-6
LP_TOL = 1e-2
CONC_TOL = 1e-4
RS_KEYS = ("ord_stop", "ord_start", "gid_row", "rank_row", "d_g",
           "n_groups", "pos_stop", "pos_start", "blk0_stop", "blk0_start")
X_COLS = ["x0", "x1", "x2", "c"]


def cox_cols(n=2003, seed=1, strata=False, start=False, weights=False):
    """Three numeric covariates and a 3-level categorical, whole-day
    times (many ties), ~70% events; optionally a strata column ``g``
    that moves the baseline, left-truncated entries and weights."""
    r = np.random.RandomState(seed)
    X = r.randn(n, 3)
    c = r.randint(0, 3, n)
    g = r.randint(0, 3, n)
    eta = X @ [0.7, -0.4, 0.2] + 0.5 * (c == 1) - 0.3 * (c == 2)
    t = -np.log(r.rand(n)) / (0.01 * np.exp(eta + (0.3 * g if strata
                                                    else 0.0)))
    cens = r.uniform(20, 400, n)
    stop = np.ceil(np.minimum(t, cens))
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
            "c": np.array(["a", "b", "c"])[c],
            "g": np.array(["g0", "g1", "g2"])[g],
            "stop": stop, "event": (t <= cens).astype(float)}
    if start:
        cols["start"] = np.floor(stop * r.uniform(0, 0.5, n))
    if weights:
        cols["w"] = r.uniform(0.5, 2, n)
    return cols


CASES = {
    "efron": (dict(), dict()),
    "breslow": (dict(), dict(ties="breslow")),
    "strata_start": (dict(strata=True, start=True),
                     dict(start_column="start", stratify_by=["g"])),
    "weights": (dict(weights=True), dict(weights_column="w")),
}


@functools.lru_cache(maxsize=None)
def _fit(case, **extra):
    data_kw, kw = CASES[case]
    cols = cox_cols(**data_kw)
    kw = dict(kw, stop_column="stop", **extra)
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=["c", "g"])
        m_r = ref_cox.CoxPHEstimator(**kw).train(fr_r, y="event", x=X_COLS)
        lp_r = m_r._score_raw(fr_r)["lp"]
    fr_p = h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu")
    m_p = h2o3_tpu_torch.CoxPHEstimator(**kw).train(fr_p, y="event",
                                                    x=X_COLS)
    return cols, m_r, lp_r, m_p, fr_p


def _structure_inputs(n, seed, strata, start, nan):
    r = np.random.RandomState(seed)
    stop = np.ceil(r.exponential(50, n))
    st = np.floor(stop * r.uniform(0, 0.8, n)) if start else \
        np.full(n, -np.inf)
    ev = (r.rand(n) < 0.6).astype(np.float64)
    s = r.randint(0, 5, n).astype(np.int64) if strata else \
        np.zeros(n, np.int64)
    if nan:
        stop[::53] = np.nan
    return st, stop, ev, s


@pytest.mark.parametrize("strata,start,nan", [
    (False, False, False), (True, False, False), (True, True, False),
    (False, True, True)])
def test_risk_structure_exact(strata, start, nan):
    args = _structure_inputs(3001, 5, strata, start, nan)
    ref = ref_cox._risk_structure(*args)
    got = port_cox._risk_structure(*args)
    for k in RS_KEYS:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_risk_structure_is_not_quadratic():
    args = _structure_inputs(400_000, 6, True, True, False)
    t0 = time.perf_counter()
    rs = port_cox._risk_structure(*args)
    assert rs["n_groups"] > 1000
    assert time.perf_counter() - t0 < 10.0


def _ref_args(rs, X, w, ev):
    j = lambda a: jnp.asarray(a)  # noqa: E731
    return (j(X), j(w), j(ev.astype(np.float32)), j(rs["gid_row"]),
            j(rs["rank_row"]), j(rs["d_g"]), j(rs["ord_stop"]),
            j(rs["ord_start"]), j(rs["pos_stop"]), j(rs["pos_start"]),
            j(rs["blk0_stop"]), j(rs["blk0_start"]))


@pytest.mark.parametrize("efron", [True, False])
def test_objective_gradient_hessian_at_fixed_beta(efron):
    r = np.random.RandomState(2)
    st, stop, ev, s = _structure_inputs(1501, 3, True, True, False)
    X = r.randn(1501, 4).astype(np.float32)
    w = r.uniform(0.5, 2, 1501).astype(np.float32)
    rs = ref_cox._risk_structure(st, stop, ev, s)
    beta = np.array([0.3, -0.2, 0.1, 0.05], np.float32)
    with _one_device():
        f = lambda b: ref_cox._cox_nll(  # noqa: E731
            b, *_ref_args(rs, X, w, ev), n_groups=rs["n_groups"],
            efron=efron)
        b = jnp.asarray(beta)
        nll_r = float(f(b))
        g_r = np.asarray(jax.grad(f)(b))
        H_r = np.asarray(jax.hessian(f)(b))
    data = port_cox._CoxData(torch.from_numpy(X), torch.from_numpy(w), ev,
                             port_cox._risk_structure(st, stop, ev, s),
                             efron=efron)
    nll_p, g_p, H_p = (t.numpy() for t in data.terms(torch.from_numpy(beta),
                                                       2))
    assert float(nll_p) == pytest.approx(nll_r, rel=1e-5)
    assert np.abs(g_p - g_r).max() <= 1e-4 * np.abs(g_r).max()
    assert np.abs(H_p - H_r).max() <= 1e-4 * np.abs(H_r).max()


def test_prefix_sums_are_row_prefix_sums():
    v = torch.from_numpy(np.random.RandomState(1).randn(5000, 3))
    np.testing.assert_allclose(port_cox.prefix_sums(v).numpy(),
                               np.cumsum(v.numpy(), 0), rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_reference(case):
    cols, m_r, lp_r, m_p, fr_p = _fit(case)
    assert m_p.output["coef_names"] == m_r.output["coef_names"]
    np.testing.assert_allclose(m_p.coef, m_r.coef, rtol=0, atol=COEF_TOL)
    se = lambda m: np.array([t["se_coef"]  # noqa: E731
                             for t in m.output["coefficients_table"]])
    np.testing.assert_allclose(se(m_p), se(m_r), rtol=SE_REL)
    for k in ("loglik", "null_loglik"):
        assert m_p.output[k] == pytest.approx(m_r.output[k], rel=LOGLIK_REL)
    for k in ("n_events", "n"):
        assert m_p.output[k] == m_r.output[k]
    np.testing.assert_allclose(m_p.output["x_mean_design"],
                               m_r.output["x_mean_design"], rtol=1e-6,
                               atol=1e-7)
    lp_p = m_p.predict(fr_p).col("lp").to_numpy()
    np.testing.assert_allclose(lp_p, lp_r, rtol=0, atol=LP_TOL)
    assert m_p.training_metrics["concordance"] == pytest.approx(
        m_r.training_metrics["concordance"], abs=CONC_TOL)
    # the concordance of one linear predictor is the reference's EXACTLY
    t = cols["stop"]
    assert port_cox.concordance_index(t, cols["event"], lp_r) == \
        ref_cox.concordance_index(t, cols["event"], lp_r)
    # Efron recovers the planted effects
    if case == "efron":
        np.testing.assert_allclose(m_p.coef[:3], [0.7, -0.4, 0.2], atol=0.1)


def test_concordance_subsample_exact():
    r = np.random.RandomState(4)
    t, e, lp = r.exponential(size=3000), (r.rand(3000) < .5) * 1.0, \
        r.randn(3000)
    for mp in (4_000_000, 60_000):
        assert port_cox.concordance_index(t, e, lp, max_pairs=mp) == \
            ref_cox.concordance_index(t, e, lp, max_pairs=mp)


def test_reference_model_carried_across_scores_alike():
    cols, m_r, lp_r, _, fr_p = _fit("strata_start")
    m_c = coxph_model_from_arrays(dict(
        coef=m_r.coef, di_stats=m_r.di_stats, features=m_r.features,
        output=dict(m_r.output), params=dict(m_r.params)))
    np.testing.assert_allclose(m_c._score_raw(fr_p)["lp"], lp_r, rtol=0,
                               atol=1e-5)
    assert m_c.model_performance(fr_p)["concordance"] == pytest.approx(
        m_r.training_metrics["concordance"], abs=1e-6)


def test_parameters():
    fr = h2o3_tpu_torch.Frame.from_numpy(cox_cols(n=200), device="cpu")
    with pytest.raises(ValueError, match="stop_column"):
        h2o3_tpu_torch.CoxPHEstimator().train(fr, y="event")
    with pytest.raises(NotImplementedError, match="cross-validation"):
        h2o3_tpu_torch.CoxPHEstimator(stop_column="stop", nfolds=3)
    with pytest.raises(ValueError, match="unknown CoxPH params"):
        h2o3_tpu_torch.CoxPHEstimator(stop_column="stop", alpha=1)
    # the strata and times are not covariates
    m = h2o3_tpu_torch.CoxPHEstimator(stop_column="stop",
                                      stratify_by=["g"]).train(fr, y="event")
    assert m.output["names"] == ["x0", "x1", "x2", "c"]
