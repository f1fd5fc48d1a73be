"""h2o-py-compatible client — the `import h2o` surface over REST.

The port's copy of h2o3_tpu/client/__init__.py. ``init()`` with no URL
starts the PORT's server (``h2o3_tpu_torch.api.server``) on the card, or
on the device named by ``device=``.

Reference: h2o-py (~156K LoC): h2o.init/connect (h2o-py/h2o/h2o.py:49,
138), H2OFrame as a lazy server-side object addressed by key
(h2o-py/h2o/frame.py), and one estimator class per algorithm GENERATED
from REST schema metadata by h2o-bindings/bin/gen_python.py.

Same architecture here, compressed: `connect()` attaches to (or starts)
a server; `H2OFrame` proxies a server-side frame; estimator classes are
generated at connect time from GET /3/ModelBuilders metadata — the
gen_python.py codegen step executed live instead of checked in. Usage:

    from h2o3_tpu_torch import client as h2o
    h2o.init()                     # the port's server, on the card
    fr = h2o.import_file("data.csv")
    m = h2o.estimators.H2OGradientBoostingEstimator(ntrees=20)
    m.train(y="target", training_frame=fr)
    m.predict(fr)
"""

from __future__ import annotations

import json
import time
import types
import urllib.parse
import urllib.request
from typing import List, Optional

_conn: Optional["H2OConnection"] = None
import itertools as _it
_expr_counter = _it.count()


class H2OConnection:
    """REST transport (h2o-py/h2o/backend/connection.py role)."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")

    def request(self, method: str, urlpath: str, **params) -> dict:
        url = f"{self.url}{urlpath}"
        data = None
        if method == "POST":
            data = urllib.parse.urlencode(
                {k: (json.dumps(v) if isinstance(v, (list, dict)) else v)
                 for k, v in params.items() if v is not None}).encode()
        elif params:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in params.items() if v is not None})
        req = urllib.request.Request(url, data=data, method=method)
        if data:
            req.add_header("Content-Type",
                           "application/x-www-form-urlencoded")
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    def wait_job(self, key: str, timeout: float = 3600) -> dict:
        """Poll GET /3/Jobs/{key} (the h2o-py progress loop)."""
        t0 = time.time()
        while time.time() - t0 < timeout:
            j = self.request("GET", f"/3/Jobs/{key}")["jobs"][0]
            if j["status"] == "FAILED":
                raise RuntimeError(j.get("exception") or "job failed")
            if j["status"] == "CANCELLED":
                raise RuntimeError(f"job {key} was cancelled")
            if j["status"] == "DONE":
                return j
            time.sleep(0.2)
        raise TimeoutError(key)


def connection() -> H2OConnection:
    if _conn is None:
        raise RuntimeError("no connection — call h2o.init() / h2o.connect()")
    return _conn


def connect(url: str = "http://127.0.0.1:54321") -> H2OConnection:
    """Attach to a running server (h2o.connect)."""
    global _conn
    _conn = H2OConnection(url)
    _conn.request("GET", "/3/Cloud")
    _generate_estimators()
    return _conn


def init(url: Optional[str] = None, start_local: bool = True,
         port: int = 0, device=None) -> H2OConnection:
    """h2o.init: attach, or boot an in-process server on ``device``
    (CUDA unless the caller names another; raises without a card)."""
    if url is None and start_local:
        from h2o3_tpu_torch.api.server import start_server
        actual = start_server(port=port, background=True, device=device)
        url = f"http://127.0.0.1:{actual}"
    if url is None:
        raise ValueError("init(start_local=False) needs url=<server url>")
    return connect(url)


def cluster_status() -> dict:
    return connection().request("GET", "/3/Cloud")


# ------------------------------------------------------------------ frame

class H2OFrame:
    """Proxy for a server-side frame (h2o-py/h2o/frame.py role —
    operations go through REST/Rapids, data stays on the cluster)."""

    def __init__(self, key: str):
        self.frame_id = key
        self._meta: Optional[dict] = None

    def _info(self) -> dict:
        # frame shape/schema is immutable server-side (mutations produce
        # new keys via Rapids), so cache after one fetch like h2o-py
        if self._meta is None:
            self._meta = connection().request(
                "GET", f"/3/Frames/{self.frame_id}")
        return self._meta

    @property
    def nrows(self) -> int:
        return self._info()["frames"][0]["rows"]

    @property
    def ncols(self) -> int:
        return self._info()["frames"][0]["num_columns"]

    @property
    def names(self) -> List[str]:
        return [c["label"] for c in self._info()["frames"][0]["columns"]]

    @property
    def shape(self):
        f = self._info()["frames"][0]
        return (f["rows"], f["num_columns"])

    def summary(self) -> dict:
        return connection().request(
            "GET", f"/3/Frames/{self.frame_id}/summary")

    def rapids(self, expr: str) -> dict:
        """Ship a Rapids expression (h2o-py/h2o/expr.py ExprNode)."""
        return connection().request("POST", "/99/Rapids", ast=expr)

    def __getitem__(self, col: str) -> "H2OFrame":
        out = self.rapids(f'(cols_py {self.frame_id} "{col}")')
        if "key" not in out:
            raise KeyError(out.get("error")
                           or f"selection '{col}' did not yield a frame")
        return H2OFrame(out["key"]["name"])

    # ---- expression building (h2o-py expr.py ExprNode role): every
    # operator ships a Rapids string; results are new server frames ----
    def _expr(self, op: str, other=None, rev: bool = False) -> "H2OFrame":
        me = self.frame_id
        key = f"py_expr_{next(_expr_counter)}"   # unique per expression
        if other is None:
            ast = f"(tmp= {key} ({op} {me}))"
        else:
            rhs = other.frame_id if isinstance(other, H2OFrame) else repr(
                other) if isinstance(other, str) else str(other)
            a, b = (rhs, me) if rev else (me, rhs)
            ast = f"(tmp= {key} ({op} {a} {b}))"
        out = self.rapids(ast)
        if "key" not in out:
            raise ValueError(out.get("error") or f"rapids op {op} failed")
        return H2OFrame(out["key"]["name"])

    def __add__(self, o): return self._expr("+", o)
    def __radd__(self, o): return self._expr("+", o, rev=True)
    def __sub__(self, o): return self._expr("-", o)
    def __rsub__(self, o): return self._expr("-", o, rev=True)
    def __mul__(self, o): return self._expr("*", o)
    def __rmul__(self, o): return self._expr("*", o, rev=True)
    def __truediv__(self, o): return self._expr("/", o)
    def __rtruediv__(self, o): return self._expr("/", o, rev=True)
    def __lt__(self, o): return self._expr("<", o)
    def __le__(self, o): return self._expr("<=", o)
    def __gt__(self, o): return self._expr(">", o)
    def __ge__(self, o): return self._expr(">=", o)
    def __eq__(self, o):                                # noqa: PLW1641
        if not isinstance(o, (H2OFrame, int, float, str)):
            return NotImplemented
        return self._expr("==", o)

    def __ne__(self, o):
        if not isinstance(o, (H2OFrame, int, float, str)):
            return NotImplemented
        return self._expr("!=", o)
    __hash__ = None   # frames are mutable proxies, not hashable

    def log(self): return self._expr("log")
    def exp(self): return self._expr("exp")
    def sqrt(self): return self._expr("sqrt")
    def abs(self): return self._expr("abs")

    def _scalar(self, op: str) -> float:
        out = self.rapids(f"({op} {self.frame_id} 1)")
        if isinstance(out, dict) and "scalar" in out:
            return out["scalar"]
        raise ValueError(out.get("error") if isinstance(out, dict) else out)

    def mean(self): return self._scalar("mean")
    def sum(self): return self._scalar("sum")
    def min(self): return self._scalar("min")
    def max(self): return self._scalar("max")

    def head(self, rows: int = 10) -> List[dict]:
        """First rows as dicts (fresh fetch honoring row_count)."""
        f = connection().request("GET", f"/3/Frames/{self.frame_id}",
                                 row_count=rows)["frames"][0]
        cols = f["columns"]
        n = min(rows, len(cols[0]["data"]) if cols else 0)
        return [{c["label"]: c["data"][i] for c in cols} for i in range(n)]

    def __repr__(self):
        return f"<H2OFrame {self.frame_id} {self.shape}>"


def _key_name(v) -> str:
    """Key fields arrive as either a bare string or a KeyV3 dict
    ({'name': ..., 'type': ...}) depending on the endpoint."""
    return v["name"] if isinstance(v, dict) else str(v)


def import_file(path: str, destination_frame: Optional[str] = None) -> H2OFrame:
    """h2o.import_file: ImportFiles → ParseSetup → Parse → poll job."""
    c = connection()
    c.request("POST", "/3/ImportFiles", path=path)
    setup = c.request("POST", "/3/ParseSetup", source_frames=[path])
    # h2o-py adopts ParseSetup's suggested destination when none is given
    destination_frame = destination_frame or setup["destination_frame"]
    out = c.request("POST", "/3/Parse", source_frames=[path],
                    destination_frame=destination_frame,
                    separator=setup.get("separator"))
    job = out["job"]
    c.wait_job(_key_name(job["key"]))
    return H2OFrame(_key_name(job["dest"]))


# ------------------------------------------------------------------ model

class H2OModel:
    """Proxy for a trained server-side model."""

    def __init__(self, model_id: str):
        self.model_id = model_id
        self._meta: Optional[dict] = None

    def _info(self) -> dict:
        # trained models are immutable — cache like H2OFrame._info
        if self._meta is None:
            self._meta = connection().request(
                "GET", f"/3/Models/{self.model_id}")
        return self._meta

    @property
    def algo(self) -> str:
        return self._info()["models"][0]["algo"]

    @property
    def params(self) -> dict:
        """actual param values from the ModelSchemaV3 parameters list."""
        plist = self._info()["models"][0].get("parameters") or []
        return {p["name"]: p.get("actual_value") for p in plist}

    def metrics(self, kind: str = "training_metrics") -> dict:
        # metrics live under output (ModelOutputSchemaV3), like the
        # reference wire shape
        return self._info()["models"][0]["output"].get(kind) or {}

    def auc(self) -> float:
        return self.metrics()["AUC"]

    def logloss(self) -> float:
        return self.metrics()["logloss"]

    def _predict_request(self, frame: H2OFrame, **flags) -> H2OFrame:
        out = connection().request(
            "POST",
            f"/3/Predictions/models/{self.model_id}/frames/{frame.frame_id}",
            **flags)
        return H2OFrame(out["predictions_frame"]["name"])

    def predict(self, frame: H2OFrame) -> H2OFrame:
        return self._predict_request(frame)

    def predict_leaf_node_assignment(self, frame: H2OFrame) -> H2OFrame:
        return self._predict_request(frame, leaf_node_assignment="true")

    def predict_contributions(self, frame: H2OFrame) -> H2OFrame:
        """TreeSHAP feature contributions + BiasTerm (h2o-py surface)."""
        return self._predict_request(frame, predict_contributions="true")

    def _download(self, urlpath: str, path: str) -> str:
        req = urllib.request.Request(f"{connection().url}{urlpath}")
        with urllib.request.urlopen(req, timeout=600) as resp:
            payload = resp.read()
        with open(path, "wb") as fh:
            fh.write(payload)
        return path

    def download_mojo(self, path: str) -> str:
        """Fetch the MOJO zip (h2o-py model.download_mojo)."""
        return self._download(f"/3/Models/{self.model_id}/mojo", path)

    def download_pojo(self, path: str) -> str:
        """Fetch the generated-source scorer (h2o-py h2o.download_pojo)."""
        return self._download(f"/3/Models.java/{self.model_id}", path)

    def __repr__(self):
        return f"<H2OModel {self.model_id}>"


class _GeneratedEstimator:
    """Base of runtime-generated estimator classes (the gen_python.py
    codegen output, produced live from /3/ModelBuilders metadata)."""

    algo: str = ""
    _param_names: List[str] = []

    def __init__(self, **params):
        unknown = set(params) - set(self._param_names)
        if unknown:
            raise ValueError(f"unknown {self.algo} params: {sorted(unknown)}")
        self._params = params
        self._model: Optional[H2OModel] = None

    def train(self, x: Optional[List[str]] = None, y: Optional[str] = None,
              training_frame: Optional[H2OFrame] = None,
              validation_frame: Optional[H2OFrame] = None,
              model_id: Optional[str] = None) -> H2OModel:
        """h2o-py argument order: train(x, y, training_frame)."""
        if not isinstance(training_frame, H2OFrame):
            raise ValueError("training_frame must be an H2OFrame "
                             "(h2o-py order is train(x, y, training_frame))")
        c = connection()
        body = dict(self._params)
        body["training_frame"] = training_frame.frame_id
        if y is not None:
            body["response_column"] = y
        if x is not None:
            # the wire contract expresses predictor choice as exclusion;
            # accept h2o-py's str / list-of-str / list-of-int forms
            names = training_frame.names
            if isinstance(x, str):
                x = [x]
            x = [names[i] if isinstance(i, int) else i for i in x]
            unknown = [c for c in x if c not in names]
            if unknown:
                raise ValueError(f"x columns not in frame: {unknown}")
            keep = set(x) | ({y} if y else set())
            body["ignored_columns"] = [n for n in names if n not in keep]
        if validation_frame is not None:
            body["validation_frame"] = validation_frame.frame_id
        if model_id:
            body["model_id"] = model_id
        out = c.request("POST", f"/3/ModelBuilders/{self.algo}", **body)
        job = c.wait_job(_key_name(out["job"]["key"]))
        self._model = H2OModel(_key_name(job["dest"]))
        return self._model

    # delegate everything model-ish to the trained model
    def __getattr__(self, item):
        if self._model is not None:
            return getattr(self._model, item)
        raise AttributeError(item)


# canonical h2o-py class names per algo (gen_python.py naming table)
_CLASS_NAMES = {
    "gbm": "H2OGradientBoostingEstimator",
    "drf": "H2ORandomForestEstimator",
    "glm": "H2OGeneralizedLinearEstimator",
    "deeplearning": "H2ODeepLearningEstimator",
    "kmeans": "H2OKMeansEstimator",
    "pca": "H2OPrincipalComponentAnalysisEstimator",
    "svd": "H2OSingularValueDecompositionEstimator",
    "glrm": "H2OGeneralizedLowRankEstimator",
    "naivebayes": "H2ONaiveBayesEstimator",
    "isolationforest": "H2OIsolationForestEstimator",
    "extendedisolationforest": "H2OExtendedIsolationForestEstimator",
    "upliftdrf": "H2OUpliftRandomForestEstimator",
    "coxph": "H2OCoxProportionalHazardsEstimator",
    "gam": "H2OGeneralizedAdditiveEstimator",
    "rulefit": "H2ORuleFitEstimator",
    "psvm": "H2OSupportVectorMachineEstimator",
    "word2vec": "H2OWord2vecEstimator",
    "isotonicregression": "H2OIsotonicRegressionEstimator",
    "modelselection": "H2OModelSelectionEstimator",
    "anovaglm": "H2OANOVAGLMEstimator",
    "targetencoder": "H2OTargetEncoderEstimator",
    "xgboost": "H2OXGBoostEstimator",
    "aggregator": "H2OAggregatorEstimator",
    "infogram": "H2OInfogram",
    "generic": "H2OGenericEstimator",
    # the port's registry also serves StackedEnsemble (h2o-py's name)
    "stackedensemble": "H2OStackedEnsembleEstimator",
}

estimators = types.SimpleNamespace()


def _generate_estimators() -> None:
    """The gen_python.py step: one estimator class per algo, param list
    from the live REST schema metadata."""
    meta = connection().request("GET", "/3/ModelBuilders")["model_builders"]
    for algo, info in meta.items():
        cls_name = _CLASS_NAMES.get(algo, f"H2O{algo.title()}Estimator")
        pnames = [p["name"] for p in info["parameters"]]
        cls = type(cls_name, (_GeneratedEstimator,),
                   {"algo": algo, "_param_names": pnames,
                    "__doc__": f"Generated from /3/ModelBuilders[{algo}]"})
        setattr(estimators, cls_name, cls)


class H2OAutoML:
    """h2o-py H2OAutoML shim (POST /99/AutoMLBuilder + leaderboard)."""

    def __init__(self, max_models: int = 10, max_runtime_secs: float = 0,
                 seed: int = -1, project_name: Optional[str] = None,
                 **kw):
        self.spec = {"max_models": max_models,
                     "max_runtime_secs": max_runtime_secs, "seed": seed,
                     "project_name": project_name or "automl", **kw}
        self.leader: Optional[H2OModel] = None

    def train(self, x: Optional[List[str]] = None, y: str = None,
              training_frame: H2OFrame = None) -> H2OModel:
        if not isinstance(training_frame, H2OFrame):
            raise ValueError("training_frame must be an H2OFrame "
                             "(h2o-py order is train(x, y, training_frame))")
        c = connection()
        build_control = {"project_name": self.spec["project_name"],
                         "stopping_criteria": {
                             "max_models": self.spec["max_models"],
                             "max_runtime_secs": self.spec["max_runtime_secs"],
                             "seed": self.spec["seed"]}}
        if self.spec.get("nfolds") is not None:
            build_control["nfolds"] = self.spec["nfolds"]
        build_models = {k: self.spec[k]
                        for k in ("include_algos", "exclude_algos")
                        if self.spec.get(k) is not None}
        input_spec = {"training_frame": training_frame.frame_id,
                      "response_column": y}
        if x is not None:
            keep = set(x) | {y}
            input_spec["ignored_columns"] = [
                n for n in training_frame.names if n not in keep]
        out = c.request("POST", "/99/AutoMLBuilder",
                        build_control=build_control,
                        input_spec=input_spec,
                        build_models=build_models or None)
        c.wait_job(_key_name(out["job"]["key"]))
        lb = self.leaderboard
        self.leader = H2OModel(lb[0]["model_id"]) if lb else None
        return self.leader

    @property
    def leaderboard(self) -> List[dict]:
        out = connection().request(
            "GET", f"/99/Leaderboards/{self.spec['project_name']}")
        return out.get("leaderboard_table") or [
            {"model_id": k} for k in out.get("models", [])]
