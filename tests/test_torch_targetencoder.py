"""The Target Encoder in the PyTorch port (on the CPU) against the
reference package.

The same seeded numpy frames (categoricals with NAs and a rare level, a
binomial response with NAs, or an integer-valued numeric one, a 5-fold
modulo fold column) go through both. The level sums are sums of integer
responses and weights, exact in float32 in any order, and the rest is
float64 numpy with the reference's noise stream: the encoding maps, the
encodings (noise included) and the transformed frame are held EXACTLY.
The reference's fits run on a one-device mesh.
"""

import contextlib

import jax
import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models import targetencoder as ref_te
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.models.convert import targetencoder_model_from_arrays
from torch_threads import one_torch_thread  # noqa: F401 - autouse

CATS = ["c0", "c1", "c2"]


@contextlib.contextmanager
def _one_device():
    """The reference's frames and fits on a one-device mesh."""
    token = ref_mesh._MESH_OVERRIDE.set(
        ref_mesh.make_mesh(jax.devices()[:1]))
    try:
        yield
    finally:
        ref_mesh._MESH_OVERRIDE.reset(token)


def te_cols(n=4096, seed=0, numeric=False):
    """Three categoricals (NAs; c1 with a rare level "z"), a numeric,
    a fold column and a response tied to c0 and c1."""
    r = np.random.RandomState(seed)
    c0 = r.choice(["a", "b", "c", "d", "e"], n).astype(object)
    c1 = r.choice(["p", "q", "r"], n, p=[0.5, 0.45, 0.05]).astype(object)
    c1[r.rand(n) < 0.01] = "z"
    c2 = np.array(["UA", "AA", "DL"], object)[r.randint(0, 3, n)]
    c0[r.rand(n) < 0.03] = None
    c2[r.rand(n) < 0.02] = None
    eta = (c0 == "a") * 1.2 - (c1 == "q") * 0.8 + 0.3 * r.randn(n)
    if numeric:
        y = np.round(3 + 2 * eta + r.randn(n)).astype(np.float64)
        y[r.rand(n) < 0.02] = np.nan
    else:
        y = np.array(["NO", "YES"], object)[(eta > 0.2).astype(int)]
        y[r.rand(n) < 0.02] = None
    return {"c0": c0, "c1": c1, "x": r.randn(n), "c2": c2,
            "fold": np.arange(n) % 5, "y": y}


def frames(cols, numeric=False):
    cats = CATS + ([] if numeric else ["y"])
    with _one_device():
        fr_r = h2o3_tpu.Frame.from_numpy(cols, categorical=cats)
    return fr_r, h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats,
                                                 device="cpu")


def assert_same_frame(fp, fr):
    """The port's frame equals the reference's: names, types, domains,
    codes and values, bit for bit."""
    assert fp.names == fr.names
    for n in fr.names:
        a, b = fp.col(n), fr.col(n)
        assert a.is_categorical == b.is_categorical, n
        if b.is_categorical:
            assert a.domain == b.domain, n
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy(), err_msg=n)


def assert_same_maps(mp, mr):
    assert list(mp.enc_maps) == list(mr.enc_maps)
    for col, m in mr.enc_maps.items():
        q = mp.enc_maps[col]
        assert q["domain"] == m["domain"] and q["prior"] == m["prior"]
        np.testing.assert_array_equal(q["sum"], m["sum"])
        np.testing.assert_array_equal(q["cnt"], m["cnt"])


@pytest.mark.parametrize("handling,blending,numeric", [
    ("none", False, False), ("none", True, True), ("loo", True, False),
    ("loo", False, True), ("kfold", True, False), ("kfold", False, True)])
def test_encodings_equal_the_references(handling, blending, numeric):
    cols = te_cols(seed=3, numeric=numeric)
    fr_r, fr_p = frames(cols, numeric)
    kw = dict(data_leakage_handling=handling, blending=blending,
              inflection_point=5.0, smoothing=10.0, noise=0.01, seed=1234)
    if handling == "kfold":
        kw["fold_column"] = "fold"
    with _one_device():
        m_r = ref_te.TargetEncoderEstimator(**kw).train(fr_r, y="y")
        t_r = m_r.transform(fr_r, as_training=True)
        s_r = m_r.transform(fr_r)
    m_p = h2o3_tpu_torch.TargetEncoderEstimator(**kw).train(fr_p, y="y")
    assert m_p.cross_validation_metrics is None
    assert m_p.output["names"] == m_r.output["names"] == CATS
    assert_same_maps(m_p, m_r)
    assert_same_frame(m_p.transform(fr_p, as_training=True), t_r)
    assert_same_frame(m_p.transform(fr_p), s_r)
    assert_same_frame(m_p.predict(fr_p), s_r)


def test_new_frame_levels_and_noise_arguments_match():
    """Unseen and absent levels, an NA, and transform's own noise and
    seed; the re-interned domains drop absent levels in both."""
    cols = te_cols(seed=4)
    fr_r, fr_p = frames(cols)
    kw = dict(blending=True, data_leakage_handling="loo")
    with _one_device():
        m_r = ref_te.TargetEncoderEstimator(**kw).train(fr_r, y="y")
    te = te_cols(n=600, seed=5)
    te["c0"][:20] = "unseen"
    te["c1"][te["c1"] == "z"] = "p"               # a level now absent
    te_r, te_p = frames(te)
    m_p = targetencoder_model_from_arrays(dict(
        enc_maps=m_r.enc_maps, output=m_r.output, params=m_r.params))
    for kw_t in ({}, {"as_training": True, "noise": 0.2, "seed": 7},
                 {"as_training": True, "noise": 0.0}):
        with _one_device():
            want = m_r.transform(te_r, **kw_t)
        assert_same_frame(m_p.transform(te_p, **kw_t), want)


def test_invalid_setups_raise_as_in_the_reference():
    with pytest.raises(ValueError, match="nfolds must be 0"):
        h2o3_tpu_torch.TargetEncoderEstimator(nfolds=3)
    cols = te_cols(n=200, seed=6)
    fr_p = frames(cols)[1]
    with pytest.raises(ValueError, match="requires fold_column"):
        h2o3_tpu_torch.TargetEncoderEstimator(
            data_leakage_handling="kfold").train(fr_p, y="y")
    cols["y"] = np.array(["a", "b", "c"], object)[np.arange(200) % 3]
    with pytest.raises(ValueError, match="binomial or numeric"):
        h2o3_tpu_torch.TargetEncoderEstimator().train(frames(cols)[1], y="y")
