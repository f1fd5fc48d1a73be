"""``offset_column``: GBM parity of the PyTorch port (on the CPU) against
the reference package.

The offset is a per-row base margin. f0 is the Newton solve of the
offset-adjusted prior (25 steps on float32 sums, added in another order
than the reference's: within 1e-6 relative); the trees grow on the
margins offset + f0 + the forest; ``predict`` and ``model_performance``
add the scored frame's offset. On tie-free data the forests' integer
fields are EXACTLY the reference's, predictions and metrics within 1e-6
(absolute, or relative where a log link scales them).

The reference's frames and fits of the parity test run on a one-device
mesh (``_one_device``): on the suite's 8 virtual CPU devices the
all-reduces of its fits can be in flight together, where XLA:CPU's
rendezvous can abort the process (a crashed xdist worker). The early
stopping test stays on the 8 devices: its seeds were chosen there, and
on one device the reference's validation deviance moves by 1%."""

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM

from test_torch_gbm import _assert_forests, family_cols
from test_torch_isofor import _one_device
from torch_ranks import mixed_cols
from torch_threads import one_torch_thread  # noqa: F401 - autouse

KW = dict(ntrees=4, max_depth=4, seed=11, sample_rate=1.0)


def _with_offset(cols, seed, scale):
    return dict(cols, off=scale * np.random.RandomState(seed).randn(
        len(cols["y"])))


def _frames(cols, cats):
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=cats),
            h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                            device="cpu"))


# (data, parameters, the column predict holds, the offset's seed: each
# tie-free with its data in either summation order)
CASES = {
    "bernoulli": (lambda: mixed_cols(seed=6), {}, "p1", 4),
    "gaussian": (lambda: family_cols("gaussian", seed=1),
                 dict(distribution="gaussian", min_rows=5.0), "predict", 4),
    "poisson": (lambda: family_cols("poisson", seed=1),
                dict(distribution="poisson", min_rows=5.0), "predict", 3),
}


@pytest.mark.parametrize("family", list(CASES))
def test_offset_fit_matches_reference(family):
    make, extra, col, off_seed = CASES[family]
    cols, cats = make()
    cols = _with_offset(cols, off_seed, 0.3)
    kw = dict(KW, offset_column="off", **extra)
    test_cols = _with_offset(make()[0], 8, 0.5)
    keys = ("AUC", "logloss", "MSE") if family == "bernoulli" else \
        ("MSE", "mean_residual_deviance")
    with _one_device():
        fr_r, fr_p = _frames(cols, cats)
        m_r = RefGBM(**kw).train(fr_r, y="y")
        te_r, te_p = _frames(test_cols, cats)
        pred_r = m_r.predict(te_r).col(col).to_numpy()
        perf_r = m_r.model_performance(te_r)
    m_p = h2o3_tpu_torch.GBMEstimator(**kw).train(fr_p, y="y")
    assert "off" not in m_p.output["names"]
    assert float(m_p.f0) == pytest.approx(float(m_r.f0), rel=1e-6)
    assert m_p.output["init_f"] == pytest.approx(m_r.output["init_f"],
                                                 rel=1e-6)
    _assert_forests(m_r, m_p)
    # a fresh frame with its own offset
    np.testing.assert_allclose(m_p.predict(te_p).col(col).to_numpy(),
                               pred_r, rtol=1e-6, atol=1e-6)
    for k in keys:
        assert m_p.training_metrics[k] == pytest.approx(
            m_r.training_metrics[k], rel=1e-6, abs=1e-6), k
        assert m_p.model_performance(te_p)[k] == pytest.approx(
            perf_r[k], rel=1e-6, abs=1e-6), k


def test_offset_moves_the_margins():
    """The offset is applied at scoring: the same rows with a shifted
    offset move every margin by the shift."""
    cols, cats = mixed_cols(seed=6)
    cols = _with_offset(cols, 3, 0.3)
    _, fr = _frames(cols, cats)
    m = h2o3_tpu_torch.GBMEstimator(offset_column="off", **KW).train(
        fr, y="y")
    shifted = dict(cols, off=cols["off"] + 0.5)
    _, fs = _frames(shifted, cats)
    p0 = m.predict(fr).col("p1").to_numpy()
    p1 = m.predict(fs).col("p1").to_numpy()
    logit = lambda p: np.log(p / (1 - p))  # noqa: E731
    np.testing.assert_allclose(logit(p1) - logit(p0), 0.5, atol=1e-4)
    no_off = {k: v for k, v in cols.items() if k != "off"}
    _, fn = _frames(no_off, cats)     # a frame without the column: no offset
    assert not np.allclose(m.predict(fn).col("p1").to_numpy(), p0)


def test_validation_offset_under_early_stopping_matches_reference():
    """The validation frame's own offset moves its margins as the
    training frame's moves theirs: the same stopping point and scoring
    history as the reference."""
    (cols, cats), (vcols, _) = mixed_cols(seed=2), mixed_cols(seed=9)
    cols, vcols = _with_offset(cols, 3, 0.3), _with_offset(vcols, 4, 0.3)
    fr_r, fr_p = _frames(cols, cats)
    v_r, v_p = _frames(vcols, cats)
    kw = dict(ntrees=20, max_depth=3, seed=11, learn_rate=0.3,
              stopping_rounds=2, score_tree_interval=2,
              stopping_tolerance=0.2, offset_column="off")
    m_r = RefGBM(**kw).train(fr_r, y="y", validation_frame=v_r)
    m_p = h2o3_tpu_torch.GBMEstimator(**kw).train(fr_p, y="y",
                                                  validation_frame=v_p)
    assert m_p.forest.feat.shape[0] == m_r.forest.feat.shape[0] < 20
    h_r, h_p = m_r.output["scoring_history"], m_p.output["scoring_history"]
    assert [e["ntrees"] for e in h_p] == [e["ntrees"] for e in h_r]
    for a, b in zip(h_p, h_r):
        assert a["deviance"] == pytest.approx(b["deviance"], rel=1e-5)
    for k in ("AUC", "logloss"):
        assert m_p.validation_metrics[k] == pytest.approx(
            m_r.validation_metrics[k], rel=1e-5, abs=1e-5), k
