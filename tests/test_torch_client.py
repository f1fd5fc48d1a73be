"""The port's h2o-py-compatible client (``h2o3_tpu_torch.client``) against
the port's server on the CPU, beside the reference's client against the
reference's server.

The flows are tests/test_client.py's: connect, ``import_file``, the
estimators generated from ``/3/ModelBuilders``, training and ``predict``,
``x`` subsets, the unknown-parameter error, the XGBoost facade, AutoML,
``H2OFrame`` arithmetic and scalars, and the MOJO/POJO downloads. Each
flow runs through both stacks on the same CSV and holds the port's
answers to the reference's assertions; where both compute the same
thing, the port equals the reference: frame shapes, names and heads
EXACT, Rapids scalars on the host path EXACT, a GBM's AUC within 1e-3
(the default GBM samples no rows, but its 3,000-row fit meets near-tie
splits). ``download_mojo`` writes exactly the port's ``mojo_bytes``.
``init()`` starts the port's server, on the card unless ``device=``
names another."""

import numpy as np
import pandas as pd
import pytest

from h2o3_tpu import client as ref_h2o
from h2o3_tpu.api import server as ref_server
from h2o3_tpu_torch import client as h2o
from h2o3_tpu_torch.api import server as port_server
from h2o3_tpu_torch.core.kv import DKV as PDKV

from torch_threads import one_torch_thread  # noqa: F401 - autouse

pytestmark = pytest.mark.allow_key_leak   # handler threads make the keys


@pytest.fixture(scope="module")
def conns():
    before = set(PDKV.keys())
    rp = ref_server.start_server(port=0, background=True)
    pp = port_server.start_server(port=0, background=True, device="cpu")
    ref_h2o.connect(f"http://127.0.0.1:{rp}")
    h2o.connect(f"http://127.0.0.1:{pp}")
    yield rp, pp
    ref_server.stop_server()
    port_server.stop_server()
    for k in set(PDKV.keys()) - before:
        PDKV.remove(k)


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    """tests/test_client.py's CSV."""
    r = np.random.RandomState(0)
    n = 3000
    df = pd.DataFrame({
        "x0": r.randn(n), "x1": r.randn(n),
        "g": np.array(["a", "b", "c"], object)[r.randint(0, 3, n)],
    })
    logit = df.x0 * 1.3 + (df.g == "b") - df.x1
    df["target"] = np.array(["no", "yes"], object)[
        (r.rand(n) < 1 / (1 + np.exp(-logit))).astype(int)]
    p = tmp_path_factory.mktemp("d") / "c.csv"
    df.to_csv(p, index=False)
    return str(p)


def test_import_and_frame(conns, csv_path):
    fr_r, fr_p = ref_h2o.import_file(csv_path), h2o.import_file(csv_path)
    assert fr_p.shape == fr_r.shape == (3000, 4)
    assert fr_p.names == fr_r.names
    assert fr_p["x0"].shape[1] == 1
    assert fr_p.head(5) == fr_r.head(5)


def test_generated_estimators(conns):
    ref = {n for n in vars(ref_h2o.estimators) if n.startswith("H2O")}
    port = {n for n in vars(h2o.estimators) if n.startswith("H2O")}
    assert port == ref | {"H2OStackedEnsembleEstimator"}
    assert "H2OGradientBoostingEstimator" in port
    with pytest.raises(ValueError, match="unknown gbm params"):
        h2o.estimators.H2OGradientBoostingEstimator(bogus_knob=1)


def test_train_predict(conns, csv_path):
    out = []
    for lib in (ref_h2o, h2o):
        fr = lib.import_file(csv_path)
        m = lib.estimators.H2OGradientBoostingEstimator(
            ntrees=8, max_depth=3, seed=4).train(y="target",
                                                 training_frame=fr)
        assert m.algo == "gbm" and m.auc() > 0.7
        preds = m.predict(fr)
        assert preds.nrows == 3000 and "p1" in preds.names
        out.append((m.auc(), preds.names))
    assert out[1][1] == out[0][1]
    assert out[1][0] == pytest.approx(out[0][0], abs=1e-3)


def test_x_subsets_predictors(conns, csv_path):
    fr = h2o.import_file(csv_path)
    est = h2o.estimators.H2OGradientBoostingEstimator(ntrees=4, max_depth=3,
                                                      seed=2)
    m = est.train(x=["x0"], y="target", training_frame=fr)
    assert m._info()["models"][0]["output"]["names"] == ["x0", "target"]
    m2 = h2o.estimators.H2OGradientBoostingEstimator(ntrees=3, seed=2).train(
        ["x0", "x1"], "target", fr)
    assert set(m2._info()["models"][0]["output"]["names"]) == \
        {"x0", "x1", "target"}
    with pytest.raises(ValueError, match="training_frame"):
        est.train(y="target")


def test_xgboost_facade(conns, csv_path):
    fr = h2o.import_file(csv_path)
    m = h2o.estimators.H2OXGBoostEstimator(ntrees=5, eta=0.3).train(
        y="target", training_frame=fr)
    assert m.auc() > 0.65


def test_automl(conns, csv_path):
    fr = h2o.import_file(csv_path)
    aml = h2o.H2OAutoML(max_models=2, seed=1, project_name="clienttest")
    leader = aml.train(y="target", training_frame=fr)
    assert leader is not None
    assert len(aml.leaderboard) >= 2


def test_frame_expressions(conns, csv_path):
    vals = []
    for lib in (ref_h2o, h2o):
        fr = lib.import_file(csv_path)
        x0 = fr["x0"]
        doubled = x0 * 2.0
        assert doubled.mean() == pytest.approx(x0.mean() * 2.0, rel=1e-5)
        shifted = 1.0 + x0
        frac = (x0 > 0).mean()
        assert 0.3 < frac < 0.7
        assert x0.abs().min() >= 0
        rows = fr.head(3)
        assert len(rows) == 3 and "target" in rows[0]
        vals.append([x0.mean(), doubled.sum(), shifted.max(), frac,
                     x0.abs().min(), (x0 / 3.0).min(), x0.exp().max()])
    assert vals[1] == vals[0]


def test_mojo_pojo_download(conns, csv_path, tmp_path):
    from h2o3_tpu_torch.genmodel import load_mojo
    from h2o3_tpu_torch.genmodel.export import mojo_artifacts
    from h2o3_tpu_torch.genmodel.mojo import mojo_bytes
    fr = h2o.import_file(csv_path)
    m = h2o.estimators.H2OGradientBoostingEstimator(
        ntrees=5, max_depth=3).train(y="target", training_frame=fr)
    zp = m.download_mojo(str(tmp_path / "m.zip"))
    with open(zp, "rb") as fh:
        assert fh.read() == mojo_bytes(*mojo_artifacts(
            PDKV.get(m.model_id)))
    out = load_mojo(zp).predict({"x0": np.array([1.0]),
                                 "x1": np.array([0.5]),
                                 "g": np.array(["b"], object)})
    assert 0.0 <= float(out["p1"][0]) <= 1.0
    src = open(m.download_pojo(str(tmp_path / "m_pojo.java"))).read()
    assert "score0" in src


def test_init_starts_the_ports_server(conns):
    """``init()`` boots the port's server on the named device (and on the
    card by default: tests/test_torch_boundary.py)."""
    prev = port_server._SERVER
    try:
        c = h2o.init(device="cpu")
        assert c.url != f"http://127.0.0.1:{conns[1]}"
        assert h2o.cluster_status()["nodes"][0]["h2o"] == "cpu"
        port_server.stop_server()
    finally:
        port_server._SERVER = prev
        h2o.connect(f"http://127.0.0.1:{conns[1]}")
