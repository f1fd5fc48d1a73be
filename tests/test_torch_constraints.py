"""Monotone and interaction constraints: GBM parity of the PyTorch port
(on the CPU) against the reference package.

``monotone_constraints`` (the dict and h2o-py's KeyValue list) become
``grow_tree``'s per-node value bounds; ``interaction_constraints`` its
per-path feature sets, an [L, F] column mask at every level (each of a
multinomial iteration's K class trees keeps its own). On tie-free data
(no sampling) the forests' integer fields are EXACTLY the reference's,
leaves within rtol 1e-5, predictions within 1e-5; the reference's
violation probe (tests/test_monotone.py) finds no violation in the
port's constrained model; each validation error has the reference's
words."""

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM

from test_torch_gbm import _assert_forests
from torch_ranks import mixed_cols, multi_cols

KW = dict(ntrees=6, max_depth=4, seed=3, sample_rate=1.0)


def _mono_cols(direction, n=2000, seed=0):
    """tests/test_monotone.py's data: a trend in x0 with non-monotone
    wiggles, signed by ``direction``."""
    r = np.random.RandomState(seed)
    x0, x1 = r.randn(n), r.randn(n)
    y = direction * (2.0 * x0 + 2.5 * np.sin(3 * x0)) + x1 \
        + 0.5 * r.randn(n)
    return {"x0": x0, "x1": x1, "y": y}, []


def _violations(model, direction, frame_of):
    """The reference probe: predictions on a 60-point grid over x0 (x1 at
    0) that move against ``direction`` by more than 1e-6."""
    grid = np.linspace(-3, 3, 60)
    pred = model.predict(frame_of({"x0": grid, "x1": np.zeros(60)})
                         ).col("predict").to_numpy()
    return int((np.diff(pred) * direction < -1e-6).sum())


def _both(cols, cats, **kw):
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    fr_p = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                           device="cpu")
    return (RefGBM(**kw).train(fr_r, y="y"),
            h2o3_tpu_torch.GBMEstimator(**kw).train(fr_p, y="y"), fr_r, fr_p)


def _assert_predictions(m_r, m_p, fr_r, fr_p, col):
    np.testing.assert_allclose(m_p.predict(fr_p).col(col).to_numpy(),
                               m_r.predict(fr_r).col(col).to_numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("direction", [1, -1],
                         ids=["increasing", "decreasing"])
def test_monotone_regression_matches_reference(direction):
    cols, cats = _mono_cols(direction)
    m_r, m_p, fr_r, fr_p = _both(cols, cats, distribution="gaussian",
                                 monotone_constraints={"x0": direction},
                                 **KW)
    _assert_forests(m_r, m_p)
    _assert_predictions(m_r, m_p, fr_r, fr_p, "predict")
    port_frame = lambda c: h2o3_tpu_torch.Frame.from_numpy(  # noqa: E731
        c, device="cpu")
    assert _violations(m_p, direction, port_frame) == 0
    free = h2o3_tpu_torch.GBMEstimator(distribution="gaussian", **KW).train(
        fr_p, y="y")
    assert _violations(free, direction, port_frame) > 0   # probe works


def test_monotone_binomial_keyvalue_form_matches_reference():
    cols, cats = mixed_cols(seed=6)
    mc = [{"key": "x1", "value": 1}, {"key": "x2", "value": -1}]
    m_r, m_p, fr_r, fr_p = _both(cols, cats, monotone_constraints=mc, **KW)
    _assert_forests(m_r, m_p)
    _assert_predictions(m_r, m_p, fr_r, fr_p, "p1")
    as_dict = h2o3_tpu_torch.GBMEstimator(
        monotone_constraints={"x1": 1, "x2": -1}, **KW).train(fr_p, y="y")
    assert torch.equal(as_dict.forest.leaf, m_p.forest.leaf)


@pytest.mark.parametrize("case", ["binomial", "multinomial"])
def test_interaction_constraints_match_reference(case):
    if case == "binomial":
        cols, cats = mixed_cols(seed=6)
        ic = [["x0", "x1"], ["x2", "c"]]
    else:
        cols, cats = multi_cols(seed=4)
        ic = [["x0", "x1"]]
    m_r, m_p, fr_r, fr_p = _both(cols, cats, interaction_constraints=ic,
                                 **KW)
    _assert_forests(m_r, m_p)
    _assert_predictions(m_r, m_p, fr_r, fr_p, "p1")
    # no path splits on features of two sets
    names = m_p.output["names"]
    group = {c: i for i, g in enumerate(ic) for c in g}
    feat, split = m_p.forest.feat.numpy(), m_p.forest.is_split.numpy()
    for t in range(feat.shape[0]):
        for d in range(feat.shape[1]):
            for node in np.nonzero(split[t, d])[0]:
                path = {group.get(names[feat[t, a, node >> (d - a)]],
                                  names[feat[t, a, node >> (d - a)]])
                        for a in range(d + 1)
                        if split[t, a, node >> (d - a)]}
                assert len(path) == 1, (t, d, node, path)


@pytest.mark.parametrize("kw,data", [
    (dict(monotone_constraints={"nope": 1}), "binomial"),
    (dict(monotone_constraints={"c": 1}), "binomial"),
    (dict(monotone_constraints={"x1": 1}), "multinomial"),
    (dict(interaction_constraints=[["x0", "nope"]]), "binomial"),
], ids=["unknown_column", "categorical", "multinomial", "unknown_set_column"])
def test_constraint_errors_match_reference(kw, data):
    cols, cats = (mixed_cols(n=200, seed=1) if data == "binomial"
                  else multi_cols(n=200, seed=1))
    fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    fr_p = h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                           device="cpu")
    with pytest.raises(Exception) as ref_err:
        RefGBM(ntrees=1, **kw).train(fr_r, y="y")
    with pytest.raises(ValueError) as port_err:
        h2o3_tpu_torch.GBMEstimator(ntrees=1, **kw).train(fr_p, y="y")
    assert str(port_err.value) in str(ref_err.value)
