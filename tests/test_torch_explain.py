"""Partial dependence and permutation importance of the PyTorch port
(``ml/explain.py``) on the CPU, held against the reference's
``ml/explain.py`` on the same model and frame.

Each case trains a reference GBM (binomial and regression, with NAs and
a categorical), carries it to the port with
``models/convert.gbm_model_from_arrays`` and explains it on fresh rows
in both packages: the PDP tables (the grid values EXACT; mean, spread
and standard error within 1e-6 relative) and the permutation importance
tables (the same features in the same order, each number within 1e-6)
equal; the port draws the reference's permutations
(``RandomState(seed).permutation(n)``, one a feature a repeat). The
reference's own checks (tests/test_model_support.py) hold on the port's
tables too. The reference runs on one device (``_one_device``)."""

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.ml import explain as ref_explain
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu_torch.ml import explain
from h2o3_tpu_torch.models.convert import gbm_model_from_arrays

from test_torch_gbm import _ref_arrays
from test_torch_isofor import _one_device
from torch_ranks import mixed_cols, regression_cols
from torch_threads import one_torch_thread  # noqa: F401 - autouse

TOL = 1e-6
CASES = {
    "binomial": (mixed_cols, dict(seed=3), ["x0", "x1", "c"],
                 dict(ntrees=6, max_depth=4, seed=2)),
    "regression": (regression_cols, dict(seed=2), ["x0", "x2", "k"],
                   dict(ntrees=6, max_depth=4, seed=2,
                        distribution="gaussian")),
}
_MODELS = {}


def _carried(name):
    """(reference model, port model, reference frame, port frame): the
    reference GBM trained on 800 rows, explained on 500 fresh rows."""
    if name not in _MODELS:
        make, kw, _, params = CASES[name]
        cols, cats = make(n=800, **kw)
        with _one_device():
            fr = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
            m_r = RefGBM(**params).train(fr, y="y")
            test, _ = make(n=500, **dict(kw, seed=kw["seed"] + 10))
            te_r = h2o3_tpu.Frame.from_numpy(test, categorical=cats)
        m_p = gbm_model_from_arrays(_ref_arrays(m_r), device="cpu")
        te_p = h2o3_tpu_torch.Frame.from_numpy(test, categorical=cats,
                                               device="cpu")
        _MODELS[name] = (m_r, m_p, te_r, te_p)
    return _MODELS[name]


def _close(got, want, what):
    got, want = np.asarray(got, float), np.asarray(want, float)
    gap = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert gap.max(initial=0) <= TOL, (what, gap.max())


@pytest.mark.parametrize("nbins", [4, 20])
@pytest.mark.parametrize("name", sorted(CASES))
def test_partial_dependence_matches_the_reference(name, nbins):
    m_r, m_p, te_r, te_p = _carried(name)
    cols = CASES[name][2]
    with _one_device():
        want = ref_explain.partial_dependence(m_r, te_r, cols, nbins=nbins)
    got = explain.partial_dependence(m_p, te_p, cols, nbins=nbins)
    assert list(got) == list(want)
    for c in cols:
        assert got[c]["values"] == want[c]["values"], c
        for k in ("mean_response", "std_response",
                  "std_error_mean_response"):
            _close(got[c][k], want[c][k], (c, k))
    t = got[cols[1 if name == "binomial" else 0]]
    # the informative feature's PDP rises (tests/test_model_support.py)
    assert t["mean_response"][-1] > t["mean_response"][0]
    assert all(s >= 0 for c in cols for s in got[c]["std_response"])


@pytest.mark.parametrize("n_repeats", [1, 2])
@pytest.mark.parametrize("name", sorted(CASES))
def test_permutation_varimp_matches_the_reference(name, n_repeats):
    m_r, m_p, te_r, te_p = _carried(name)
    with _one_device():
        want = ref_explain.permutation_varimp(m_r, te_r, seed=1,
                                              n_repeats=n_repeats)
    got = explain.permutation_varimp(m_p, te_p, seed=1, n_repeats=n_repeats)
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        _close(g[1:], w[1:], g[0])
    assert got[0][2] == pytest.approx(1.0)
    assert set(r[0] for r in got) == set(m_p.output["names"])


def test_explain_metric_names_and_frames_left_alone():
    """A named metric reads that key of the metrics; the scored frame is
    not changed by the pinned and permuted copies."""
    m_r, m_p, te_r, te_p = _carried("binomial")
    before = {c: te_p.col(c).host_view().copy() for c in ("x0", "x1")}
    with _one_device():
        want = ref_explain.permutation_varimp(m_r, te_r, metric="MSE",
                                              seed=3)
    got = explain.permutation_varimp(m_p, te_p, metric="MSE", seed=3)
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        _close(g[1:], w[1:], g[0])
    explain.partial_dependence(m_p, te_p, ["x0", "c"], nbins=5)
    for c, v in before.items():
        np.testing.assert_array_equal(te_p.col(c).host_view(), v)
    assert te_p.col("c").domain == ["a", "b", "c", "d"]
