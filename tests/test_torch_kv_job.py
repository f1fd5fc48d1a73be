"""The port's DKV, Scope and Job (``h2o3_tpu_torch/core``) against the
reference's (``h2o3_tpu/core``), and every key path of the port's
estimators: each call made with a key gives what the same call made
with the object gives.

The store operations run the same sequence on both packages' DKVs and
compare every result. Jobs: a foreground job returns its result or
raises its error after FAILED; a background job's thread surfaces its
exception as FAILED with the traceback; a cancelled GBM (``job_update``
once a tree) ends CANCELLED before its last tree; ``train(...,
background=True)`` returns the Job whose ``dest`` holds the model.
"""

import contextlib
import os
import sys

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu_torch as h2o
from h2o3_tpu.core import job as ref_job
from h2o3_tpu.core.kv import DKV as REF_DKV
from h2o3_tpu.core.scope import Scope as RefScope
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.core import job as port_job
from h2o3_tpu_torch.core.kv import DKV, make_key
from h2o3_tpu_torch.core.scope import Scope

from test_torch_ingest import _assert_port_identical

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _one_device():
    """The reference's fits on a one-device mesh."""
    token = ref_mesh._MESH_OVERRIDE.set(
        ref_mesh.make_mesh(jax.devices()[:1]))
    try:
        yield
    finally:
        ref_mesh._MESH_OVERRIDE.reset(token)


def _cols(n=600, seed=0):
    r = np.random.RandomState(seed)
    X = r.randn(n, 4)
    y = (X[:, 0] - 0.7 * X[:, 1] + 0.5 * r.randn(n) > 0).astype(np.int32)
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["y"] = y
    return cols


def _frame(n=600, seed=0, key=None):
    return h2o.Frame.from_numpy(_cols(n, seed), domains={"y": ["N", "Y"]},
                                device=CPU, key=key)


def _store_ops(dkv, tag):
    """One sequence of store operations; every observable result."""
    a, b = object(), object()
    k1, k2 = f"{tag}_a", f"{tag}_b"
    out = [dkv.put(k1, a) == k1, dkv.get(k1) is a, k1 in dkv,
           dkv.get_raw(k1) is a, dkv.replace_if(k1, b, a),
           dkv.replace_if(k1, a, b), dkv.get(k1) is b]
    dkv.put(k2, a)
    out.append(sorted(dkv.keys(tag)) == [k1, k2])
    dkv.remove(k1)
    out += [dkv.get(k1) is None, k1 in dkv, sorted(dkv.keys(tag)) == [k2]]
    dkv.remove(k2)
    dkv.remove("no_such_key")
    return out


def test_store_operations_equal_the_reference():
    assert _store_ops(DKV, "kvtest_port") == _store_ops(REF_DKV,
                                                        "kvtest_ref")
    assert make_key("frame").startswith("frame_")
    assert make_key("x") != make_key("x")


def test_scope_drops_what_it_did_not_keep():
    for dkv, scope in ((DKV, Scope), (REF_DKV, RefScope)):
        with scope() as s:
            dkv.put("scope_keep", 1)
            with scope() as inner:
                dkv.put("scope_inner", 2)
                inner.keep("scope_inner")
            dkv.put("scope_drop", 3)
            s.keep("scope_keep")
        assert "scope_keep" in dkv and "scope_drop" not in dkv
        assert "scope_inner" not in dkv    # kept by the inner scope only
        dkv.remove("scope_keep")


@pytest.mark.parametrize("background", [False, True])
def test_job_lifecycle_matches_the_reference(background):
    """DONE with the result under ``dest``, progress 1, the same
    ``to_dict`` keys and statuses as the reference."""
    seen = {}
    for mod in (port_job, ref_job):
        j = mod.Job("unit", work=2.0, dest=f"jobdest_{mod.__name__}")

        def work(job):
            job.update(1.0, "half")
            assert abs(job.progress - 0.5) < 1e-12
            return 42

        j.start(work, background=background).join()
        d = j.to_dict()
        seen[mod] = (j.status, j.result, j.progress, d["progress_msg"],
                     sorted(set(d) - {"trace_id"}), d["status"])
        dkv = DKV if mod is port_job else REF_DKV
        assert dkv.get(j.key) is j and dkv.get(j.dest) == 42
        dkv.remove(j.key)
        dkv.remove(j.dest)
    assert seen[port_job] == seen[ref_job]
    assert seen[port_job][:2] == ("DONE", 42)
    j = port_job.Job("listed").start(lambda job: 1)
    assert j.to_dict() in port_job.list_jobs()


def test_job_failure_and_cancellation():
    def boom(job):
        raise ValueError("no good")

    with pytest.raises(ValueError, match="no good"):
        port_job.Job("fg").start(boom)
    bg = port_job.Job("bg").start(boom, background=True).join()
    assert bg.status == "FAILED" and "ValueError: no good" in bg.exception
    assert "Traceback" in bg.exception

    started = port_job.Job("cancel me")

    def spin(job):
        while True:
            job.update(0.0)

    started.start(spin, background=True)
    started.cancel()
    assert started.join(10.0).status == "CANCELLED"


def test_cancelled_gbm_stops_at_a_tree():
    """``job_update`` once a tree: a GBM cancelled from its first tree
    ends CANCELLED with no model under its key."""
    fr = _frame(2000)
    est = h2o.GBMEstimator(ntrees=200, max_depth=3, seed=1)
    real = port_job.Job.update
    hits = []

    def update(self, units, msg=""):
        hits.append(msg)
        if len(hits) == 3:
            self.cancel()
        return real(self, units, msg)

    port_job.Job.update = update
    try:
        job = est.train(fr, y="y", background=True).join()
    finally:
        port_job.Job.update = real
    assert job.status == "CANCELLED" and job.result is None
    assert hits[:3] == ["tree 1/200", "tree 2/200", "tree 3/200"]
    assert DKV.get(job.dest) is None


def test_background_train_returns_the_job_and_keys_the_model():
    fr = _frame()
    job = h2o.GBMEstimator(ntrees=3, max_depth=3, seed=1).train(
        fr, y="y", background=True, dest_key="my_gbm")
    assert isinstance(job, port_job.Job)
    m = job.join().result
    assert job.status == "DONE" and m.key == "my_gbm" == job.dest
    assert DKV.get("my_gbm") is m
    fg = h2o.GBMEstimator(ntrees=3, max_depth=3, seed=1).train(fr, y="y")
    assert DKV.get(fg.key) is fg and fg.key != m.key
    assert torch.equal(fg.forest.leaf, m.forest.leaf)
    assert fg.default_metrics is fg.training_metrics
    DKV.remove("my_gbm")


def test_remove_frees_the_model_its_folds_and_frames():
    """``DKV.remove(model.key)`` drops the model with its fold models and
    kept CV frames; the finished Job keeps only the key, so nothing holds
    the model after that. A ``train`` inside another fit stores nothing:
    ModelSelection's GLM fits are not keyed, an ensemble's metalearner is
    stored and removed with its ensemble."""
    import gc
    import weakref
    fr = _frame()
    job = h2o.GBMEstimator(
        ntrees=3, max_depth=3, seed=1, nfolds=2,
        keep_cross_validation_predictions=True,
        keep_cross_validation_fold_assignment=True).train(
            fr, y="y", background=True)
    m = job.join().result
    owned = m._owned_keys()
    assert m.output["cv_model_keys"] == [f"{m.key}_cv_1", f"{m.key}_cv_2"]
    assert len(owned) == 2 + 2 + 2 and all(k in DKV for k in owned)
    alive = [weakref.ref(o) for o in [m, m.forest.leaf] + m._cv_models]
    del m
    DKV.remove(job.dest)
    gc.collect()
    assert [r() for r in alive] == [None] * len(alive)
    assert not any(k in DKV for k in owned)
    assert DKV.get(job.key) is job and job.result is None

    before = set(DKV.keys("model_"))
    sel = h2o.ModelSelectionEstimator(mode="maxr", max_predictor_number=2,
                                      family="binomial").train(fr, y="y")
    assert set(DKV.keys("model_")) - before == {sel.key}
    a = h2o.GLMEstimator(nfolds=2, seed=1).train(fr, y="y")
    b = h2o.GBMEstimator(nfolds=2, seed=1, ntrees=2, max_depth=2).train(
        fr, y="y")
    se = h2o.StackedEnsembleEstimator(base_models=[a, b]).train(fr, y="y")
    meta = se.output["metalearner"]
    assert DKV.get(meta) is se.metalearner
    DKV.remove(se.key)
    assert meta not in DKV and a.key in DKV and b.key in DKV
    for k in (sel.key, a.key, b.key):
        DKV.remove(k)


def test_frame_keys_and_import_destination(tmp_path):
    fr = _frame(key="train_frame")
    assert fr.key == "train_frame" and DKV.get("train_frame") is fr
    assert _frame().key is None
    p = tmp_path / "f.csv"
    p.write_text("a,b\n1,x\n2,y\n3,x\n")
    got = h2o.import_file(str(p), destination_frame="imported", device=CPU)
    assert DKV.get("imported") is got and got.key == "imported"
    from h2o3_tpu_torch.io.stream import stream_import_csv
    got2 = stream_import_csv(str(p), destination_frame="streamed",
                             device=CPU)
    assert DKV.get("streamed") is got2
    for c in ("a", "b"):
        assert np.array_equal(got.col(c).host_view(),
                              got2.col(c).host_view())
    for k in ("train_frame", "imported", "streamed"):
        DKV.remove(k)


def test_checkpoint_by_key():
    fr = _frame()
    donor = h2o.GBMEstimator(ntrees=2, max_depth=3, seed=1).train(fr, y="y")
    by_obj = h2o.GBMEstimator(ntrees=4, max_depth=3, seed=1,
                              checkpoint=donor).train(fr, y="y")
    by_key = h2o.GBMEstimator(ntrees=4, max_depth=3, seed=1,
                              checkpoint=donor.key).train(fr, y="y")
    assert all(torch.equal(getattr(by_obj.forest, f),
                           getattr(by_key.forest, f))
               for f in by_obj.forest._fields)
    with pytest.raises(ValueError, match="not found"):
        h2o.GBMEstimator(ntrees=4, checkpoint="no_such_model").train(
            fr, y="y")


def test_calibration_frame_by_key():
    fr = _frame(800)
    cal = _frame(400, seed=3, key="cal_frame")
    kw = dict(ntrees=3, max_depth=3, seed=1, calibrate_model=True)
    a = h2o.GBMEstimator(calibration_frame=cal, **kw).train(fr, y="y")
    b = h2o.GBMEstimator(calibration_frame="cal_frame", **kw).train(fr,
                                                                    y="y")
    pa = a.predict(fr).col("cal_p1").to_numpy()
    pb = b.predict(fr).col("cal_p1").to_numpy()
    assert np.array_equal(pa, pb)
    with pytest.raises(ValueError, match="no frame"):
        h2o.GBMEstimator(calibration_frame="nope", **kw).train(fr, y="y")
    DKV.remove("cal_frame")


def test_user_points_and_beta_constraints_by_key():
    fr = _frame(500)
    x = ["x0", "x1", "x2", "x3"]
    pts = h2o.Frame.from_numpy({c: np.array([-1.0, 0.0, 1.0]) for c in x},
                               device=CPU, key="pts")
    a = h2o.KMeansEstimator(k=3, user_points=pts, init="User").train(
        fr, x=x)
    b = h2o.KMeansEstimator(k=3, user_points="pts", init="User").train(
        fr, x=x)
    assert np.array_equal(np.asarray(a.centers_std), np.asarray(b.centers_std))
    bc = h2o.Frame.from_numpy(
        {"names": np.array(["x0", "x1"], dtype=object),
         "lower_bounds": np.array([0.0, -0.1]),
         "upper_bounds": np.array([0.2, 0.1])}, device=CPU, key="bc")
    kw = dict(family="binomial", lambda_=0.0)
    ga = h2o.GLMEstimator(beta_constraints=bc, **kw).train(fr, y="y")
    gb = h2o.GLMEstimator(beta_constraints="bc", **kw).train(fr, y="y")
    assert ga.coefficients == gb.coefficients
    assert ga.coefficients != h2o.GLMEstimator(**kw).train(
        fr, y="y").coefficients            # the bounds bind
    DKV.remove("pts")
    DKV.remove("bc")


@pytest.mark.parametrize("algo", ["gbm", "drf", "glm"])
def test_cv_frames_and_model_keys(algo):
    """keep_cross_validation_predictions / _fold_assignment as frame
    keys, the fold models as ``<main>_cv_<i>``; the merged holdout frame
    holds ``_cv_holdout``."""
    fr = _frame(600)
    cls = h2o.models.get_builder(algo)
    kw = dict(nfolds=3, seed=1, keep_cross_validation_predictions=True,
              keep_cross_validation_fold_assignment=True)
    if algo != "glm":
        kw.update(ntrees=3, max_depth=3)
    m = cls(**kw).train(fr, y="y")
    out = m.output
    assert len(out["cv_model_keys"]) == 3
    for i, k in enumerate(out["cv_model_keys"]):
        assert DKV.get(k) is m._cv_models[i] and k.endswith(f"_cv_{i + 1}")
    hold = DKV.get(out["cv_holdout_frame_key"])
    assert np.array_equal(hold.col("p1").host_view(),
                          m._cv_holdout.astype(np.float64))
    fa = DKV.get(out["cv_fold_assignment_key"])
    assert np.array_equal(fa.col("fold_assignment").host_view(),
                          m._cv_folds.astype(np.float64))
    preds = [DKV.get(k) for k in out["cv_predictions_keys"]]
    total = sum(p.col("p1").host_view() for p in preds)
    assert np.allclose(total, m._cv_holdout, atol=1e-7)
    plain = cls(**{**kw, "keep_cross_validation_predictions": False,
                   "keep_cross_validation_fold_assignment": False}
                ).train(fr, y="y")
    assert plain.output["cv_holdout_frame_key"] is None
    assert plain.output["cv_fold_assignment_key"] is None
    assert np.array_equal(plain._cv_holdout, m._cv_holdout)


def test_aggregator_output_frame_and_dl_weights_by_key():
    fr = _frame(3000)
    ag = h2o.AggregatorEstimator(target_num_exemplars=100).train(
        fr, x=["x0", "x1", "x2", "x3"])
    key = ag.output["output_frame"]
    assert DKV.get(key) is ag.aggregated_frame
    assert ag.aggregated_frame.nrows == ag.output["num_exemplars"]
    dl = h2o.DeepLearningEstimator(hidden=[5, 3], epochs=1, seed=1,
                                   export_weights_and_biases=True).train(
        fr, y="y")
    shapes = [(4, 5), (5, 3), (3, 2)]
    for i, (wk, bk) in enumerate(zip(dl.output["weights_keys"],
                                     dl.output["biases_keys"])):
        wf, bf = DKV.get(wk), DKV.get(bk)
        W = np.stack([wf.col(c).host_view() for c in wf.names])
        assert W.shape == shapes[i]
        assert np.array_equal(W.astype(np.float32),
                              dl.net[i]["W"].cpu().numpy())
        assert np.array_equal(bf.col("C1").host_view().astype(np.float32),
                              dl.net[i]["b"].cpu().numpy())


# ------------------------------------------------ lazy frames (slice 16)


def _lazy_csv(path, n=400):
    """tests/test_lazy_frames.py's file."""
    r = np.random.RandomState(0)
    with open(path, "w") as f:
        f.write("a,b,c\n")
        for _ in range(n):
            f.write(f"{r.randn():.5f},{r.randint(0, 5)},lvl{r.randint(3)}\n")
    return str(path)


def test_lazy_import_defers_parse(tmp_path):
    from h2o3_tpu.io.parser import import_file as ref_import
    from h2o3_tpu_torch.io.lazy import FileBackedFrame
    p = _lazy_csv(tmp_path / "lazy.csv")
    stub = h2o.import_file(p, destination_frame="lazyfr", lazy=True,
                           device=CPU)
    ref_stub = ref_import(p, destination_frame="lazyfr_ref", lazy=True)
    assert isinstance(stub, FileBackedFrame)
    assert (stub.names, stub.nrows, stub.nbytes, stub.paths) == (
        ref_stub.names, ref_stub.nrows, ref_stub.nbytes, ref_stub.paths)
    assert stub.names == ["a", "b", "c"] and stub.nrows == 400
    REF_DKV.remove("lazyfr_ref")
    assert DKV.get_raw("lazyfr") is stub and stub._frame is None
    fr = DKV.get("lazyfr")                 # the first get parses
    assert isinstance(fr, h2o.Frame) and fr.key == "lazyfr"
    assert DKV.get_raw("lazyfr") is fr and DKV.get("lazyfr") is fr
    _assert_port_identical(fr, h2o.import_file(p, device=CPU))
    DKV.remove("lazyfr")
    assert "lazyfr" not in DKV


def test_lazy_glob_headerless_and_sniffed_metadata(tmp_path):
    from h2o3_tpu.io import lazy as ref_lazy
    from h2o3_tpu_torch.io import lazy
    (tmp_path / "d").mkdir()
    a = _lazy_csv(tmp_path / "d" / "0.csv", 50)
    _lazy_csv(tmp_path / "d" / "1.csv", 70)
    for hdr in (None, True, False):
        assert lazy.sniff_meta(a, header=hdr) == \
            ref_lazy.sniff_meta(a, header=hdr)
    stub = h2o.import_file(str(tmp_path / "d"), lazy=True, device=CPU)
    assert stub.names == [] and stub.nrows is None
    assert stub.nbytes == sum(p.stat().st_size
                              for p in (tmp_path / "d").iterdir())
    _assert_port_identical(DKV.get(stub.key),
                h2o.import_file(str(tmp_path / "d"), device=CPU))
    DKV.remove(stub.key)
    stub = h2o.import_file(a, lazy=True, header=False, device=CPU)
    assert stub.names == ["C1", "C2", "C3"] and stub.nrows == 51
    assert DKV.get(stub.key).nrows == 51
    DKV.remove(stub.key)


def test_lazy_restore_parses_once_under_concurrent_gets(tmp_path,
                                                        monkeypatch):
    import threading
    import time
    from h2o3_tpu_torch.io import parser
    p = _lazy_csv(tmp_path / "c.csv")
    stub = h2o.import_file(p, destination_frame="conc", lazy=True,
                           device=CPU)
    real, calls = parser.import_file, []

    def slow_import(*a, **kw):
        calls.append(a)
        time.sleep(0.2)                    # the other gets arrive meanwhile
        return real(*a, **kw)

    monkeypatch.setattr(parser, "import_file", slow_import)
    n = (os.cpu_count() or 4) + 1          # more threads than cores
    barrier, got = threading.Barrier(n), []

    def get():
        barrier.wait(timeout=30)
        got.append(DKV.get("conc"))

    threads = [threading.Thread(target=get) for _ in range(n)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == n
    assert all(g is got[0] for g in got) and DKV.get_raw("conc") is got[0]
    assert isinstance(got[0], h2o.Frame) and stub._frame is got[0]
    DKV.remove("conc")


def test_lazy_newer_put_wins_and_a_failed_parse_raises(tmp_path,
                                                      monkeypatch):
    from h2o3_tpu_torch.io.lazy import FileBackedFrame
    p = _lazy_csv(tmp_path / "n.csv")
    h2o.import_file(p, destination_frame="newer", lazy=True, device=CPU)
    other = _frame()
    DKV.put("newer", other)
    assert DKV.get("newer") is other
    # a parse that fails while the stub is stored raises ...
    gone = tmp_path / "gone.csv"
    gone.write_text("a\n1\n")
    h2o.import_file(str(gone), destination_frame="gone", lazy=True,
                    device=CPU)
    gone.unlink()
    with pytest.raises(FileNotFoundError):
        DKV.get("gone")
    assert isinstance(DKV.get_raw("gone"), FileBackedFrame)
    # ... but not once a newer value took the key: get returns that
    replacement = _frame(seed=1)

    def put_then_fail(self):
        DKV.put("gone", replacement)
        raise FileNotFoundError("the file went away")

    monkeypatch.setattr(FileBackedFrame, "restore", put_then_fail)
    assert DKV.get("gone") is replacement
    for k in ("newer", "gone"):
        DKV.remove(k)
