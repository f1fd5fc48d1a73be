"""The port's persistence (``h2o3_tpu_torch/io/persist.py``) against the
reference's (``h2o3_tpu/io/persist.py``): frame bytes cross both ways
EXACT (NAs, narrowed integer columns, categoricals, strings), a model's
round trip scores bit for bit on the CPU, the hex (ice) driver, the
errors of an unknown, a read-only and a pyarrow scheme, and
``export_file`` through the drivers writing the reference's bytes."""

import io
import os
import pickle

import numpy as np
import pytest
import torch

import h2o3_tpu
import h2o3_tpu_torch as h2o
from h2o3_tpu.io import parser as ref_parser
from h2o3_tpu.io import persist as ref_persist
from h2o3_tpu_torch.io import persist

from torch_threads import one_torch_thread  # noqa: F401 - autouse


def frame_cols(n=300, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(n)
    x[::7] = np.nan
    g = np.array(["a", "b", "c"], object)[r.randint(0, 3, n)]
    g[::11] = None
    s = np.array([f"s{i % 13}" for i in range(n)], object)
    s[::5] = None
    return {"x": x,                        # stored as float32 by both
            "i8": r.randint(-100, 100, n).astype(np.float64),
            "i16": r.randint(-30000, 30000, n).astype(np.float64),
            "i32": r.randint(-2 ** 30, 2 ** 30, n).astype(np.float64),
            "g": g, "s": s,
            "y": np.array(["no", "yes"], object)[r.randint(0, 2, n)]}


def frames(c):
    kw = dict(categorical=["g", "y"], strings=["s"])
    return h2o3_tpu.Frame.from_numpy(c, **kw), \
        h2o.Frame.from_numpy(c, device="cpu", **kw)


def _npz(blob):
    z = np.load(io.BytesIO(blob), allow_pickle=False)
    return {k: z[k] for k in z.files}


def _assert_same_frame(a, b):
    """Two frames (either package) with the same names, types, domains,
    NA masks and values bit for bit."""
    assert list(a.names) == list(b.names)
    for n in a.names:
        ca, cb = a.col(n), b.col(n)
        assert ca.type == cb.type, n
        assert ca.domain == cb.domain, n
        va, vb = ca.to_numpy(), cb.to_numpy()
        if ca.type == "string":
            assert list(va) == list(vb), n
        else:
            np.testing.assert_array_equal(va, vb, err_msg=n)


@pytest.mark.parametrize("way", ["reference_to_port", "port_to_reference",
                                 "same_arrays"])
def test_frame_bytes_cross_both_ways_exact(way):
    fr_r, fr_p = frames(frame_cols())
    if way == "reference_to_port":
        blob = ref_persist.frame_to_bytes(fr_r)
        _assert_same_frame(persist.frame_from_bytes(blob, device="cpu"),
                           ref_persist.frame_from_bytes(blob))
    elif way == "port_to_reference":
        blob = persist.frame_to_bytes(fr_p)
        _assert_same_frame(ref_persist.frame_from_bytes(blob),
                           persist.frame_from_bytes(blob, device="cpu"))
    else:
        a, b = _npz(persist.frame_to_bytes(fr_p)), \
            _npz(ref_persist.frame_to_bytes(fr_r))
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["c1"].dtype == np.int8 and a["c2"].dtype == np.int16 and \
            a["c3"].dtype == np.int32 and a["c0"].dtype == np.float32


def test_save_load_frame_through_a_uri(tmp_path, monkeypatch):
    monkeypatch.setenv("H2O3_TPU_ICE_DIR", str(tmp_path / "ice"))
    fr_r, fr_p = frames(frame_cols(n=50, seed=1))
    want = ref_persist.frame_from_bytes(ref_persist.frame_to_bytes(fr_r))
    for uri in (str(tmp_path / "f.h2o"), f"file://{tmp_path}/g.h2o",
                "hex://frames/f.h2o"):
        assert h2o.save_frame(fr_p, uri) == uri
        _assert_same_frame(h2o.load_frame(uri, device="cpu"), want)
    assert os.path.exists(tmp_path / "ice" / "frames" / "f.h2o")


def _fit(algo, fr):
    kw = {"gbm": (h2o.GBMEstimator, dict(ntrees=3, max_depth=3, seed=1)),
          "drf": (h2o.DRFEstimator, dict(ntrees=3, max_depth=3, seed=1)),
          "glm": (h2o.GLMEstimator, dict(family="binomial", lambda_=0.0)),
          "deeplearning": (h2o.DeepLearningEstimator,
                           dict(hidden=[5], epochs=1, seed=1))}[algo]
    return kw[0](**kw[1]).train(fr, y="y", x=["x", "i8", "g"])


@pytest.mark.parametrize("algo", ["gbm", "drf", "glm", "deeplearning"])
def test_model_round_trip_scores_bit_identically(algo, tmp_path):
    _, fr = frames(frame_cols())
    m = _fit(algo, fr)
    uri = str(tmp_path / "m.bin")
    h2o.save_model(m, uri)
    got = h2o.load_model(uri, device="cpu")
    assert got.key == m.key and h2o.DKV.get(m.key) is got
    a, b = m.predict(fr), got.predict(fr)
    assert a.names == b.names
    for n in a.names:
        np.testing.assert_array_equal(a.col(n).to_numpy(),
                                      b.col(n).to_numpy(), err_msg=n)
    assert got.training_metrics.to_dict() == m.training_metrics.to_dict()
    for t in _tensors(got):
        assert t.device.type == "cpu"


def _tensors(model):
    out = []

    def walk(v, depth=0):
        if depth > 4:
            return
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x, depth + 1)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x, depth + 1)
        elif hasattr(v, "__dict__") and not isinstance(v, type):
            walk(vars(v), depth + 1)
    walk(vars(model))
    return out


def test_a_pickled_model_holds_no_device_state(tmp_path):
    """Tensors come back on the named device, a generator's state and a
    binning's weak reference to its frame travel as host values."""
    _, fr = frames(frame_cols(n=120))
    m = _fit("deeplearning", fr)
    assert isinstance(m._gen_state[1], np.ndarray)
    blob = persist.model_to_bytes(m)
    got = persist.model_from_bytes(blob, device="cpu")
    np.testing.assert_array_equal(got._gen_state[1], m._gen_state[1])
    gbm = _fit("gbm", fr)
    assert gbm.bm.source_ref is not None
    back = persist.model_from_bytes(persist.model_to_bytes(gbm),
                                    device="cpu")
    assert back.bm.source_ref is None
    assert torch.equal(back.bm.edges, gbm.bm.edges)
    g = torch.Generator().manual_seed(5)
    g2 = pickle.loads(persist.model_to_bytes({"gen": g}))["gen"]
    assert torch.equal(g2.get_state(), g.get_state())


def test_hex_ice_driver(tmp_path, monkeypatch):
    monkeypatch.setenv("H2O3_TPU_ICE_DIR", str(tmp_path / "ice"))
    pm = persist.PersistManager()
    pm.write("hex://spill/blob.bin", b"cold value")
    assert pm.read("hex://spill/blob.bin") == b"cold value"
    assert pm.exists("hex://spill/blob.bin")
    assert pm.list("hex://spill") == [str(tmp_path / "ice" / "spill" /
                                          "blob.bin")]
    pm.delete("hex://spill/blob.bin")
    assert not pm.exists("hex://spill/blob.bin")


@pytest.mark.parametrize("uri,err,match", [
    ("ftp://bucket/key", IOError, "no persist driver"),
    ("s3://bucket/key", NotImplementedError, "pyarrow"),
    ("hdfs://nn:8020/user/x", NotImplementedError, "pyarrow"),
])
def test_unknown_and_unported_schemes_raise(uri, err, match):
    with pytest.raises(err, match=match):
        h2o.persist_manager.read(uri)
    with pytest.raises(err, match=match):
        h2o.persist_manager.write(uri, b"x")


def test_http_is_read_only():
    with pytest.raises(IOError, match="read-only"):
        h2o.persist_manager.write("http://localhost:1/x", b"x")


@pytest.mark.parametrize("scheme", ["file", "hex", "path"])
def test_export_file_writes_the_references_bytes(scheme, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("H2O3_TPU_ICE_DIR", str(tmp_path / "ice"))
    c = frame_cols(n=60, seed=3)
    c.pop("s")
    fr_r = h2o3_tpu.Frame.from_numpy(c, categorical=["g", "y"])
    fr_p = h2o.Frame.from_numpy(c, categorical=["g", "y"], device="cpu")
    uri = {"file": f"file://{tmp_path}/out.csv", "hex": "hex://out.csv",
           "path": str(tmp_path / "out.csv")}[scheme]
    ref_parser.export_file(fr_r, str(tmp_path / "ref.csv"))
    assert h2o.export_file(fr_p, uri) == uri
    assert h2o.persist_manager.read(uri) == \
        (tmp_path / "ref.csv").read_bytes()
    with pytest.raises(IOError, match="exists"):
        h2o.export_file(fr_p, uri)
    h2o.export_file(fr_p, uri, force=True)
