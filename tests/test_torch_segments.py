"""Segment models of the port (``ml/segments.py``) on the CPU against the
reference's (``h2o3_tpu/ml/segments.py``).

The frame splits by a categorical and a numeric column into eight
segments, one of which has a constant response and fails. Segment
order, statuses, errors and ``as_frame`` are EXACT; each segment's GLM
is within COEF_TOL (``tests/test_torch_grid.py``'s) of the reference's
and each segment's GBM (sampling off, tie-free data) has the reference's
split fields EXACT. ``parallelism=2`` gives the same models as 1, and
each model equals a fit on its segment's rows alone."""

import contextlib

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch as h2o
from h2o3_tpu.core.kv import DKV as REF_DKV
from h2o3_tpu.ml.segments import train_segments as ref_train_segments
from h2o3_tpu.models.gbm import GBMEstimator as RefGBM
from h2o3_tpu.models.glm import GLMEstimator as RefGLM
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.models.tree import Tree

COEF_TOL = 1e-4
SEG = ["s", "g"]
INT_FIELDS = ("feat", "thresh", "na_left", "is_split", "cat_split")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _one_device():
    token = ref_mesh._MESH_OVERRIDE.set(
        ref_mesh.make_mesh(jax.devices()[:1]))
    try:
        yield
    finally:
        ref_mesh._MESH_OVERRIDE.reset(token)


def _cols(n=2400, seed=3):
    r = np.random.RandomState(seed)
    X = r.randn(n, 3)
    s = r.choice(["d", "b", "c", "a"], n)
    g = r.randint(0, 2, n).astype(float)
    y = 1.5 * X[:, 0] - X[:, 1] + (s == "b") + g + 0.3 * r.randn(n)
    y[(s == "c") & (g == 1.0)] = 3.0            # this segment fails
    return {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2], "s": s, "g": g,
            "y": y}


@pytest.fixture(scope="module")
def frames():
    cols = _cols()
    return (h2o3_tpu.Frame.from_numpy(cols, categorical=["s"]),
            h2o.Frame.from_numpy(cols, categorical=["s"], device="cpu"))


def _models(seg):
    return [h2o.DKV.get(r["model_key"]) if r["status"] == "SUCCEEDED"
            else None for r in seg.results]


def _check_results(seg_p, seg_r, n_failed):
    assert seg_p.segment_columns == seg_r.segment_columns == SEG
    assert [r["segment"] for r in seg_p.results] == \
        [r["segment"] for r in seg_r.results]
    assert [r["status"] for r in seg_p.results] == \
        [r["status"] for r in seg_r.results]
    assert [r.get("error") for r in seg_p.results] == \
        [r.get("error") for r in seg_r.results]
    assert [r["status"] for r in seg_p.results].count("FAILED") == n_failed
    fp, fr = seg_p.as_frame(), seg_r.as_frame()
    assert fp.names == fr.names
    for n in fp.names:
        if n == "model":             # keys differ between the packages
            continue
        assert fp.col(n).domain == fr.col(n).domain, n
        np.testing.assert_array_equal(fp.col(n).to_numpy(),
                                      fr.col(n).to_numpy())


def test_glm_segments_equal_the_reference(frames):
    fr_r, fr_p = frames
    params = dict(family="gaussian", lambda_=0.0)
    with _one_device():
        seg_r = ref_train_segments(RefGLM, params, fr_r, SEG, y="y")
    seg_p = h2o.train_segments(h2o.GLMEstimator, params, fr_p, SEG, y="y")
    _check_results(seg_p, seg_r, 0)   # a constant response fits a GLM
    for m_p, r in zip(_models(seg_p), seg_r.results):
        if m_p is None:
            continue
        cr = REF_DKV.get(r["model_key"]).coefficients
        cp = m_p.coefficients
        assert set(cp) == set(cr)
        assert max(abs(cp[k] - cr[k]) for k in cp) <= COEF_TOL, r["segment"]


def test_gbm_segments_equal_the_reference_and_parallel(frames):
    fr_r, fr_p = frames
    params = dict(ntrees=3, max_depth=3, seed=1, sample_rate=1.0,
                  col_sample_rate_per_tree=1.0)
    with _one_device():
        seg_r = ref_train_segments(RefGBM, params, fr_r, SEG, y="y")
    seg_p = h2o.train_segments(h2o.GBMEstimator, params, fr_p, SEG, y="y")
    _check_results(seg_p, seg_r, 1)
    seg_2 = h2o.train_segments(h2o.GBMEstimator, params, fr_p, SEG, y="y",
                               parallelism=2)
    _check_results(seg_2, seg_r, 1)
    cols = _cols()
    for m_p, m_2, r in zip(_models(seg_p), _models(seg_2), seg_r.results):
        if m_p is None:
            assert m_2 is None
            continue
        m_r = REF_DKV.get(r["model_key"])
        for f in INT_FIELDS:
            np.testing.assert_array_equal(
                getattr(m_p.forest, f).numpy(),
                np.asarray(getattr(m_r.forest, f)),
                err_msg=f"{r['segment']} {f}")
        assert all(torch.equal(getattr(m_p.forest, f),
                               getattr(m_2.forest, f)) for f in Tree._fields)
        # the model is a fit on its segment's rows alone
        rows = ((cols["s"] == r["segment"]["s"])
                & (cols["g"].astype(str) == r["segment"]["g"]))
        alone = h2o.GBMEstimator(**params).train(
            h2o.Frame.from_numpy({k: v[rows] for k, v in cols.items()
                                  if k not in SEG}, device="cpu"), y="y")
        assert all(torch.equal(getattr(m_p.forest, f),
                               getattr(alone.forest, f))
                   for f in Tree._fields)
