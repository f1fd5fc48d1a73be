"""The PyTorch port's REST server (``h2o3_tpu_torch.api.server``) on the
CPU, held against the reference's server on the same requests.

Both servers run in this process on ephemeral ports: the reference's
``h2o3_tpu.api.server.start_server`` and the port's with
``device="cpu"``. Each test sends the same requests to both and compares
the JSON with keys, job keys and timings left out. Tolerances:

- frames (ImportFiles + Parse of a seeded CSV, CreateFrame, Interaction,
  MissingInserter under one seed) EXACT: names, wire types, domains and
  every preview cell, NA and zero counts, min and max; a column's mean
  and sigma (float32 sums in both) within the float32 summation bound
  n·2^-24·(mean|x| + sigma);
- ``/3/DownloadDataset`` bytes equal; ParseSetup's names and types equal;
- ``/3/ModelBuilders``: every reference builder with the same parameter
  names and defaults (the port also lists ``stackedensemble``, which the
  reference trains outside its registry);
- a GBM over ``/3/ModelBuilders/gbm`` on tests/test_torch_gbm.py's
  tie-free data and parameters: forests' integer fields EXACT, leaves and
  training metrics within rtol 1e-5 (that file's tolerances);
  ``/3/Models/{id}`` with the reference's keys; ``/3/Predictions``
  within 1e-6; ``/3/Predictions/models/{id}`` rows bit-equal to the
  port's own ``predict``;
- ``/99/Grid/gbm`` over two combos: the reference's combo order, every
  model bit-equal to its standalone fit;
- ``/99/AutoMLBuilder`` (``max_models=2, nfolds=2, seed=1``, 2,000 rows,
  the reference on one device as tests/test_torch_automl.py runs it):
  the same steps and leaderboard columns; the GLM's leaderboard metrics
  within 1e-4 (tests/test_torch_automl.py's bound). The GBMs differ by
  their random streams, and so do the ensembles over them (their
  logloss 5.3e-4 apart here: ROADMAP C's 1.4e-5 was a regression probe
  whose deviance the GBMs moved less): both within that file's
  ``AUC_GAP`` of AUC.

``/99/Rapids`` answers as the reference does (its group-by means within
1e-6: float32 sums in another order; tests/test_torch_rapids.py holds the
prims). Also: job cancel, the 501 of every route that waits for ROADMAP A #13,
the admission gate's 503 and the body cap's 413."""

import json
import time
import urllib.error
import urllib.parse
import urllib.request

import jax
import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.api import server as ref_server
from h2o3_tpu.core.kv import DKV as RDKV
from h2o3_tpu.parallel import mesh as ref_mesh
from h2o3_tpu_torch.api import server as port_server
from h2o3_tpu_torch.core.kv import DKV as PDKV

from test_torch_automl import AUC_GAP
from test_torch_gbm import PARAMS as GBM_PARAMS
from test_torch_gbm import _assert_forests
from torch_ranks import mixed_cols
from torch_threads import one_torch_thread  # noqa: F401 - autouse

pytestmark = pytest.mark.allow_key_leak   # handler threads make the keys

TIMING_KEYS = {"timestamp", "msec", "start_time", "end_time", "run_time",
               "run_time_ms", "cloud_uptime_millis", "last_ping", "pid",
               "scoring_time"}


@pytest.fixture(scope="module")
def ports():
    before = set(PDKV.keys())
    rp = ref_server.start_server(port=0, background=True)
    pp = port_server.start_server(port=0, background=True, device="cpu")
    yield rp, pp
    ref_server.stop_server()
    port_server.stop_server()
    for k in set(PDKV.keys()) - before:
        PDKV.remove(k)


@pytest.fixture
def one_device_ref(monkeypatch):
    """The reference's job threads on a one-device mesh."""
    monkeypatch.setattr(ref_mesh, "_GLOBAL_MESH",
                        ref_mesh.make_mesh(jax.devices()[:1]))


def _req(port, method, path, raw=False, headers=None, data=None,
         **params):
    url = f"http://127.0.0.1:{port}{path}"
    if method == "POST" and data is None:
        data = urllib.parse.urlencode(
            {k: (json.dumps(v) if isinstance(v, (list, dict)) else v)
             for k, v in params.items()}).encode()
    elif params:
        url += "?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, data=data, method=method)
    if data:
        req.add_header("Content-Type", "application/x-www-form-urlencoded")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req) as resp:
            body = resp.read()
            return resp.status, (body if raw else json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _both(ports, method, path, **params):
    out = []
    for p in ports:
        st, j = _req(p, method, path, **params)
        assert st == 200, (p, path, j)
        out.append(j)
    return out


def _wait(port, key, timeout=300):
    t0 = time.time()
    while time.time() - t0 < timeout:
        st, j = _req(port, "GET", f"/3/Jobs/{key}")
        assert st == 200, j
        job = j["jobs"][0]
        if job["status"] in ("DONE", "FAILED", "CANCELLED"):
            return job
        time.sleep(0.05)
    raise TimeoutError(key)


def _run_both(ports, method, path, **params):
    """POST a job-starting request to both servers; their finished jobs."""
    jobs = []
    for j in _both(ports, method, path, **params):
        jd = j.get("job", j)
        jobs.append(jd["key"]["name"])
    done = [_wait(p, k) for p, k in zip(ports, jobs)]
    for d in done:
        assert d["status"] == "DONE", d["exception"]
    return done


def _strip(o):
    """The JSON without its timing fields."""
    if isinstance(o, dict):
        return {k: _strip(v) for k, v in o.items() if k not in TIMING_KEYS}
    if isinstance(o, list):
        return [_strip(v) for v in o]
    return o


def _frame_cols(port, key, rows=1000):
    st, j = _req(port, "GET", f"/3/Frames/{key}", row_count=rows)
    assert st == 200, j
    return j["frames"][0]


def _assert_close_frame(fr_r, fr_p, rtol):
    """FrameV3 of both servers whose numeric cells are float32 sums
    (a Rapids group-by): names and types EXACT, numbers within ``rtol``."""
    assert fr_p["column_names"] == fr_r["column_names"]
    for cr, cp in zip(fr_r["columns"], fr_p["columns"]):
        assert (cp["type"], cp["domain"]) == (cr["type"], cr["domain"])
        for k in ("data", "mins", "maxs", "mean", "sigma"):
            a = np.asarray(cr[k] if isinstance(cr[k], list) else [cr[k]],
                           np.float64)
            b = np.asarray(cp[k] if isinstance(cp[k], list) else [cp[k]],
                           np.float64)
            np.testing.assert_allclose(b, a, rtol=rtol, err_msg=k)


def _assert_same_frame(fr_r, fr_p):
    """FrameV3 of both servers: EXACT but mean and sigma, which are
    float32 sums in both: within n·2^-24·(mean|x| + sigma) of each other,
    n the column's valid rows (every row is in the preview)."""
    assert fr_p["column_names"] == fr_r["column_names"]
    assert (fr_p["rows"], fr_p["num_columns"]) == \
        (fr_r["rows"], fr_r["num_columns"])
    for cr, cp in zip(fr_r["columns"], fr_p["columns"]):
        for k in cr:
            if k in ("mean", "sigma"):
                if cr[k] is None:
                    assert cp[k] is None, (cr["label"], k)
                else:
                    x = np.asarray([v for v in cr["data"] if v != "NaN"
                                    and v == v], np.float64)
                    tol = x.size * 2.0 ** -24 * (
                        np.mean(np.abs(x)) + (cr["sigma"] or 0.0))
                    assert abs(cp[k] - cr[k]) <= tol, \
                        (cr["label"], k, cp[k], cr[k], tol)
            else:
                assert cp[k] == cr[k], (cr["label"], k, cp[k], cr[k])


def _csv(tmp_path, n=300, seed=3):
    r = np.random.RandomState(seed)
    path = tmp_path / "t.csv"
    with open(path, "w") as f:
        f.write("x1,x2,n,c,y\n")
        for i in range(n):
            x2 = "" if r.rand() < 0.1 else f"{r.randn():.5f}"
            f.write(f"{r.randn():.6f},{x2},{r.randint(-5, 6)},"
                    f"{'abcd'[r.randint(4)]},"
                    f"{'yes' if r.rand() < 0.4 else 'no'}\n")
    return str(path)


def test_cloud_and_about_shape(ports):
    ref, port = _both(ports, "GET", "/3/Cloud")
    assert set(port) == set(ref) - {"heartbeat"}
    assert port["cloud_size"] == 1 and port["cloud_healthy"]
    assert port["nodes"][0]["h2o"] == "cpu"
    left_out = {"mem_value_size", "free_mem", "max_mem", "swap_mem",
                "gflops", "mem_bw", "metrics_summary", "sched"}
    assert set(port["nodes"][0]) == set(ref["nodes"][0]) - left_out
    ref, port = _both(ports, "GET", "/3/About")
    assert [e["name"] for e in port["entries"]] == \
        [e["name"] for e in ref["entries"]]
    for path in ("/3/Ping", "/3/Capabilities", "/3/Capabilities/Core",
                 "/3/Capabilities/API"):
        ref, port = _both(ports, "GET", path)
        assert port == ref, path


def test_import_parse_frames_and_download(ports, tmp_path):
    path = _csv(tmp_path)
    ref, port = _both(ports, "POST", "/3/ImportFilesMulti",
                      paths=json.dumps([path]))
    assert port == ref
    ref, port = _both(ports, "POST", "/3/ParseSetup",
                      source_frames=json.dumps([path]))
    for k in ("column_names", "column_types", "separator", "check_header",
              "destination_frame", "number_columns"):
        assert port[k] == ref[k], k
    _run_both(ports, "POST", "/3/Parse",
              source_frames=json.dumps([path]), destination_frame="t.hex")
    _assert_same_frame(*[_frame_cols(p, "t.hex") for p in ports])
    ref, port = _both(ports, "GET", "/3/Frames/t.hex/summary")
    _assert_same_frame(ref["frames"][0], port["frames"][0])
    for k in ("min", "max", "na_count", "zero_count", "cardinality",
              "type"):
        assert [c.get(k) for c in port["frames"][0]["columns"]] == \
            [c.get(k) for c in ref["frames"][0]["columns"]], k
    ref, port = (_req(p, "GET", "/3/DownloadDataset", raw=True,
                      frame_id="t.hex")[1] for p in ports)
    assert port == ref
    ref, port = _both(ports, "GET", "/3/Frames")
    assert {"frame_id": {"name": "t.hex"}, "rows": 300,
            "num_columns": 5} in port["frames"]
    # a multi-file parse: the files' frames concatenated
    _run_both(ports, "POST", "/3/Parse",
              source_frames=json.dumps([path, path]),
              destination_frame="tt.hex")
    _assert_same_frame(*[_frame_cols(p, "tt.hex") for p in ports])


def test_create_frame_interaction_missing_inserter(ports):
    spec = dict(dest="cf.hex", rows=200, cols=8, seed=7,
                categorical_fraction=0.25, integer_fraction=0.25,
                binary_fraction=0.125, string_fraction=0.125,
                missing_fraction=0.1, factors=5, has_response="true",
                response_factors=3)
    _run_both(ports, "POST", "/3/CreateFrame", **spec)
    _assert_same_frame(*[_frame_cols(p, "cf.hex") for p in ports])
    _run_both(ports, "POST", "/3/Interaction", source_frame="cf.hex",
              dest="ia.hex", factor_columns=json.dumps(["C1", "C2"]),
              pairwise="true", max_factors=10, min_occurrence=2)
    _assert_same_frame(*[_frame_cols(p, "ia.hex") for p in ports])
    _run_both(ports, "POST", "/3/MissingInserter", dataset="cf.hex",
              fraction=0.2, seed=11)
    _assert_same_frame(*[_frame_cols(p, "cf.hex") for p in ports])


def test_model_builders_and_metadata(ports):
    ref, port = _both(ports, "GET", "/3/ModelBuilders")
    rb, pb = ref["model_builders"], port["model_builders"]
    assert sorted(pb) == sorted(list(rb) + ["stackedensemble"])
    for algo, info in rb.items():
        assert pb[algo] == info, algo
    for name in ("CloudV3", "H2OErrorV3", "FrameV3", "JobV3", "Nope"):
        ref, port = _both(ports, "GET", f"/3/Metadata/schemas/{name}")
        assert port == ref, name
    ref, port = _both(ports, "GET", "/3/Metadata/endpoints")
    ported = {(r["http_method"], r["url_pattern"]) for r in port["routes"]}
    # the reference server's own routes (a test module may add its own
    # to the reference's table) are each answered: ported or 501
    reference = {(m, rx.pattern.strip("^$"))
                 for m, rx, fn in ref_server.ROUTES
                 if fn.__module__.startswith("h2o3_tpu.api")}
    assert reference <= {(r["http_method"], r["url_pattern"])
                         for r in ref["routes"]}
    assert reference <= ported


def _gbm_frames(ports):
    cols, cats = mixed_cols(seed=6)
    h2o3_tpu.Frame.from_numpy(cols, categorical=cats, key="gbm.hex")
    h2o3_tpu_torch.Frame.from_numpy(cols, categorical=cats, device="cpu",
                                    key="gbm.hex")
    return cols, cats


def _train_rest(ports, model_id, **params):
    _run_both(ports, "POST", "/3/ModelBuilders/gbm",
              training_frame="gbm.hex", response_column="y",
              model_id=model_id, **params)
    return RDKV.get(model_id), PDKV.get(model_id)


def _keys(o):
    """The nested key structure of a JSON value."""
    if isinstance(o, dict):
        return {k: _keys(v) for k, v in o.items()}
    if isinstance(o, list) and o and isinstance(o[0], dict):
        return [_keys(o[0])]
    return None


def test_gbm_over_rest(ports):
    cols, cats = _gbm_frames(ports)
    m_r, m_p = _train_rest(ports, "gbm_rest", **GBM_PARAMS)
    _assert_forests(m_r, m_p)
    for k in ("AUC", "logloss", "MSE"):
        assert m_p.training_metrics[k] == pytest.approx(
            m_r.training_metrics[k], rel=1e-5, abs=1e-7), k
    ref, port = _both(ports, "GET", "/3/Models/gbm_rest")
    kr, kp = _keys(_strip(ref)), _keys(_strip(port))
    out_r = kr["models"][0].pop("output")
    out_p = kp["models"][0].pop("output")
    assert kp == kr
    # the output's algo extras: the reference's carries the fit's seconds
    # as ``run_time`` (the port keeps them on the model, ``run_time``)
    assert set(out_p) == set(out_r)
    tm_r = ref["models"][0]["output"]["training_metrics"]
    tm_p = port["models"][0]["output"]["training_metrics"]
    assert set(tm_p) == set(tm_r)
    for k in ("AUC", "logloss", "MSE", "RMSE", "Gini", "nobs"):
        assert tm_p[k] == pytest.approx(tm_r[k], rel=1e-5), k
    ref, port = _both(ports, "POST",
                      "/3/Predictions/models/gbm_rest/frames/gbm.hex")
    pr = RDKV.get(ref["predictions_frame"]["name"])
    pp = PDKV.get(port["predictions_frame"]["name"])
    assert pp.names == list(pr.names)
    np.testing.assert_array_equal(pp.col("predict").to_numpy(),
                                  pr.col("predict").to_numpy())
    for n in ("p0", "p1"):
        np.testing.assert_allclose(pp.col(n).to_numpy(),
                                   pr.col(n).to_numpy(), atol=1e-6)
    # rows through the serving engine: bit-equal to the port's predict
    rows = [{k: (None if isinstance(v, float) and np.isnan(v) else
                 (float(v) if isinstance(v, (float, np.floating))
                  else str(v)))
             for k, v in zip(cols, vals) if k != "y"}
            for vals in zip(*[cols[k][:40] for k in cols])]
    st, j = _req(ports[1], "POST", "/3/Predictions/models/gbm_rest",
                 data=json.dumps({"rows": rows}).encode(),
                 headers={"Content-Type": "application/json"})
    assert st == 200, j
    direct = m_p.predict(PDKV.get("gbm.hex"))
    for n in ("p0", "p1"):
        np.testing.assert_array_equal(
            np.asarray(j["predictions"][n], np.float64),
            direct.col(n).to_numpy()[:40])
    assert j["predictions"]["predict"] == [
        m_p.output["domain"][int(c)]
        for c in direct.col("predict").to_numpy()[:40]]
    # the MOJO bytes are the port's mojo_bytes
    from h2o3_tpu_torch.genmodel.export import mojo_artifacts
    from h2o3_tpu_torch.genmodel.mojo import mojo_bytes
    st, blob = _req(ports[1], "GET", "/3/Models/gbm_rest/mojo", raw=True)
    assert st == 200 and blob == mojo_bytes(*mojo_artifacts(m_p))
    ref, port = _both(ports, "POST",
                      "/3/ModelMetrics/models/gbm_rest/frames/gbm.hex")
    assert port["model_metrics"][0]["AUC"] == pytest.approx(
        ref["model_metrics"][0]["AUC"], abs=1e-6)


def test_grid_over_rest(ports):
    _gbm_frames(ports)
    hyper = {"max_depth": [2, 4]}
    _run_both(ports, "POST", "/99/Grid/gbm", training_frame="gbm.hex",
              response_column="y", grid_id="g_rest",
              hyper_parameters=json.dumps(hyper), ntrees=3, seed=11,
              sample_rate=1.0, col_sample_rate_per_tree=1.0)
    ref, port = _both(ports, "GET", "/99/Grids/g_rest")
    assert port["hyper_names"] == ref["hyper_names"] == ["max_depth"]
    combos = [[m] for m in port["summary_table"]["data"][0]]
    assert combos == [[m] for m in ref["summary_table"]["data"][0]]
    for mid in port["model_ids"]:
        m = PDKV.get(mid["name"])
        alone = h2o3_tpu_torch.GBMEstimator(**m.params).train(
            PDKV.get("gbm.hex"), y="y")
        for f in ("feat", "thresh", "is_split", "leaf"):
            assert np.array_equal(getattr(m.forest, f).numpy(),
                                  getattr(alone.forest, f).numpy()), f
    ref, port = _both(ports, "GET", "/99/Grids")
    assert {"name": "g_rest", "type": "Key<Grid>"} in port["grids"]


def test_automl_over_rest(ports, one_device_ref):
    from test_torch_automl import _cols
    cols = _cols()
    h2o3_tpu.Frame.from_numpy(cols, categorical=["y"], key="aml.hex")
    h2o3_tpu_torch.Frame.from_numpy(cols, device="cpu", key="aml.hex")
    ctl = {"project_name": "aml_rest", "nfolds": 2,
           "stopping_criteria": {"max_models": 2, "seed": 1}}
    _run_both(ports, "POST", "/99/AutoMLBuilder",
              build_control=json.dumps(ctl),
              input_spec=json.dumps({"training_frame": "aml.hex",
                                     "response_column": "y"}),
              build_models=json.dumps(
                  {"include_algos": ["glm", "gbm", "stackedensemble"]}))
    ref, port = _both(ports, "GET", "/99/Leaderboards/aml_rest")
    steps_r = {RDKV.get(m["name"]).output["automl_step"]: m["name"]
               for m in ref["models"]}
    steps_p = {PDKV.get(m["name"]).output["automl_step"]: m["name"]
               for m in port["models"]}
    assert set(steps_p) == set(steps_r)
    assert port["table"]["columns"] == ref["table"]["columns"]
    assert port["table"]["rowcount"] == ref["table"]["rowcount"]
    rows_r = {r["model_id"]: r for r in ref["leaderboard_table"]}
    rows_p = {r["model_id"]: r for r in port["leaderboard_table"]}
    glm_r, glm_p = rows_r[steps_r["GLM_1"]], rows_p[steps_p["GLM_1"]]
    for k in glm_r:
        if k != "model_id":
            assert glm_p[k] == pytest.approx(glm_r[k], abs=1e-4), \
                (k, glm_p, glm_r)
    for step in steps_r:
        if step.startswith(("GBM", "StackedEnsemble")):
            dr = RDKV.get(steps_r[step]).default_metrics
            dp = PDKV.get(steps_p[step]).default_metrics
            assert abs(dp["AUC"] - dr["AUC"]) <= AUC_GAP, step
    ref, port = _both(ports, "GET", "/99/AutoML/aml_rest")
    assert set(port) == set(ref)
    assert [r[2] for r in zip(*port["event_log_table"]["data"])][-1] == \
        [r[2] for r in zip(*ref["event_log_table"]["data"])][-1]


def test_job_cancel(ports):
    _gbm_frames(ports)
    st, j = _req(ports[1], "POST", "/3/ModelBuilders/gbm",
                 training_frame="gbm.hex", response_column="y",
                 ntrees=100000, max_depth=3)
    assert st == 200, j
    key = j["job"]["key"]["name"]
    time.sleep(0.3)
    st, _ = _req(ports[1], "POST", f"/3/Jobs/{key}/cancel")
    assert st == 200
    assert _wait(ports[1], key)["status"] == "CANCELLED"
    st, j = _req(ports[1], "GET", "/3/Jobs")
    assert key in [d["key"]["name"] for d in j["jobs"]]


OUT_OF_SCOPE = [
    ("GET", "/3/Cleaner"), ("GET", "/3/Metrics"), ("GET", "/3/Alerts"),
    ("GET", "/3/WaterMeterCpuTicks"), ("GET", "/3/Timeline"),
    ("GET", "/3/Profiler"), ("POST", "/3/Profiler/capture"),
    ("GET", "/3/Logs"), ("GET", "/3/Logs/download"),
    ("GET", "/3/Jobs/job_x/trace"), ("GET", "/3/Jobs/job_x/telemetry"),
    ("GET", "/3/Trace"), ("POST", "/3/CloudCheckpoint"),
    ("GET", "/3/Models/m_x/profile")]


@pytest.mark.parametrize("method,path", OUT_OF_SCOPE)
def test_out_of_scope_routes_answer_501(ports, method, path):
    st, j = _req(ports[1], method, path)
    assert st == 501, j
    assert j["__meta"]["schema_name"] == "H2OErrorV3"
    assert j["http_status"] == 501 and "ROADMAP A #13" in j["msg"]
    # the reference answers the route (some need a job or a model)
    st_r, _ = _req(ports[0], method, path, raw=True)
    assert st_r != 501


def test_out_of_scope_list_is_pinned():
    assert [(m, re_pat) for m, re_pat, _ in port_server.OUT_OF_SCOPE] == [
        ("GET", "/3/Cleaner"), ("GET", "/3/Metrics"), ("GET", "/3/Alerts"),
        ("GET", "/3/WaterMeterCpuTicks"), ("GET", "/3/Timeline"),
        ("GET", "/3/Profiler"), ("POST", "/3/Profiler/capture"),
        ("GET", "/3/Logs"), ("GET", "/3/Logs/download"),
        ("GET", r"/3/Jobs/(?P<key>[^/]+)/trace"),
        ("GET", r"/3/Jobs/(?P<key>[^/]+)/telemetry"),
        ("GET", "/3/Trace"), ("POST", "/3/CloudCheckpoint"),
        ("GET", r"/3/Models/(?P<mid>[^/]+)/profile")]


def test_admission_gate_503_and_body_cap_413(ports, monkeypatch):
    gate = port_server.AdmissionGate(max_inflight=1, queue_depth=0,
                                     queue_wait_s=0.1)
    assert gate.enter()                 # the one slot, held
    monkeypatch.setattr(port_server, "_GATE", gate)
    st, j = _req(ports[1], "GET", "/3/Cloud")
    assert st == 503 and "saturated" in j["msg"]
    st, _ = _req(ports[1], "GET", "/3/Ping")     # exempt
    assert st == 200
    gate.leave()
    st, _ = _req(ports[1], "GET", "/3/Cloud")
    assert st == 200
    monkeypatch.setenv("H2O3TPU_REST_MAX_BODY_MB", "0")
    st, j = _req(ports[1], "POST", "/3/LogAndEcho", message="hello")
    assert st == 413 and "exceeds" in j["msg"]
    for p in ports:                      # the reference answers alike
        st, _ = _req(p, "POST", "/3/LogAndEcho", message="hello")
        assert st == 413


def test_rapids_and_flow_over_rest(ports):
    _gbm_frames(ports)
    for ast in ('(sum (cols_py gbm.hex ["x1"]))',
                '(GB gbm.hex ["c"] "mean" "x1" "all")',
                '(cols_py gbm.hex ["x0" "c"])'):
        ref, port = _both(ports, "POST", "/99/Rapids", ast=ast)
        if "scalar" in ref:
            assert port["scalar"] == ref["scalar"]
        else:
            assert (port["num_rows"], port["num_cols"]) == \
                (ref["num_rows"], ref["num_cols"])
            if ast.startswith("(GB"):
                _assert_close_frame(ref["frame"], port["frame"], 1e-6)
            else:
                _assert_same_frame(ref["frame"], port["frame"])
    st, j = _req(ports[1], "POST", "/99/Rapids", ast="(nope 1)")
    assert st == 412 and j["__meta"]["schema_name"] == "H2OErrorV3"
    for p in ports:
        st, page = _req(p, "GET", "/flow/index.html", raw=True)
        assert st == 200 and b"Flow" in page
    st, j = _req(ports[1], "GET", "/3/NetworkTest")
    assert st == 200 and j["table"][0]["op"] == "psum-32KB"


def test_start_server_defaults_to_cuda_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_server.start_server(port=0)


def test_config_fields_and_readers(monkeypatch):
    """``core/config``: every field the port keeps is the reference's,
    with its default and its environment override; the REST gate, the
    body cap, ``model_batch.mode`` and the batcher's knobs read
    ``ARGS`` under the environment, as the reference's readers do."""
    import dataclasses
    from h2o3_tpu.core import config as ref_cfg
    from h2o3_tpu_torch.core import config as cfg
    from h2o3_tpu_torch.parallel import model_batch
    from h2o3_tpu_torch.serving import batcher
    ref = {f.name: f.default for f in dataclasses.fields(ref_cfg.Config)}
    port = {f.name: f.default for f in dataclasses.fields(cfg.Config)}
    assert all(ref[k] == v for k, v in port.items())
    monkeypatch.setenv("H2O3TPU_REST_QUEUE_DEPTH", "3")
    monkeypatch.setenv("H2O3TPU_SCORE_BATCH_WAIT_MS", "7.5")
    a, b = cfg.Config.from_env(port=99), ref_cfg.Config.from_env(port=99)
    for k in port:
        assert getattr(a, k) == getattr(b, k), k
    for k in ("H2O3TPU_BATCH_MODELS", "H2O3TPU_SCORE_BATCH_MAX_ROWS",
              "H2O3TPU_REST_MAX_INFLIGHT", "H2O3TPU_REST_MAX_BODY_MB"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(cfg, "ARGS", cfg.Config(
        batch_models="off", score_batch_max_rows=128, rest_max_inflight=5,
        rest_max_body_mb=2))
    assert model_batch.mode() == "off" and not model_batch.enabled()
    assert batcher.batch_knobs() == {"max_rows": 128, "wait_ms": 7.5,
                                     "queue_depth": 256}
    assert port_server._gate_from_config().max_inflight == 5
    assert port_server._gate_from_config().queue_depth == 3
    assert port_server._max_body_bytes() == 2 << 20
    monkeypatch.setenv("H2O3TPU_BATCH_MODELS", "auto")
    assert model_batch.mode() == "auto"
