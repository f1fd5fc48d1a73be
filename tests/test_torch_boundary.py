"""The PyTorch port's import boundary: ``h2o3_tpu_torch`` and
``chip_smoke.py`` never import JAX, any module of the reference package
``h2o3_tpu``, or pandas and pyarrow (the card's machine has neither), and
no port file reaches into the reference package's directory by path
(the native tokenizer is the port's own copy)."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "h2o3_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "h2o3_tpu", "pandas", "pyarrow")
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
# the modules of each slice, so a rename cannot drop one from the scan
SLICE_MODULES = (
    "h2o3_tpu_torch/ops/histogram.py",
    "h2o3_tpu_torch/ops/kernels/histogram.py",
    "h2o3_tpu_torch/ops/kernels/treekernel.py",
    "h2o3_tpu_torch/models/tree.py",
    "h2o3_tpu_torch/models/gbm.py",
    "h2o3_tpu_torch/models/drf.py",
    "h2o3_tpu_torch/models/uplift.py",
    "h2o3_tpu_torch/models/convert.py",
    "h2o3_tpu_torch/core/cloud.py",
    "h2o3_tpu_torch/parallel/mesh.py",
    "h2o3_tpu_torch/parallel/map_reduce.py",
    "h2o3_tpu_torch/frame/partition.py",
    "h2o3_tpu_torch/ml/calibration.py",
    "h2o3_tpu_torch/ml/cv.py",
    "h2o3_tpu_torch/ops/fixed_point.py",
    "h2o3_tpu_torch/ops/segments.py",
    "h2o3_tpu_torch/native/__init__.py",
    "h2o3_tpu_torch/io/chunking.py",
    "h2o3_tpu_torch/io/stream.py",
    "h2o3_tpu_torch/io/parser.py",
    "h2o3_tpu_torch/frame/column.py",
    "h2o3_tpu_torch/frame/frame.py",
    "h2o3_tpu_torch/frame/rollups.py",
    "h2o3_tpu_torch/models/xgboost.py",
    "h2o3_tpu_torch/models/isofor.py",
    "h2o3_tpu_torch/models/extisofor.py",
    "h2o3_tpu_torch/ml/shap.py",
    "h2o3_tpu_torch/frame/datainfo.py",
    "h2o3_tpu_torch/ops/gram.py",
    "h2o3_tpu_torch/ops/optimize.py",
    "h2o3_tpu_torch/models/glm.py",
    "h2o3_tpu_torch/models/deeplearning.py",
    "h2o3_tpu_torch/models/__init__.py",
    "h2o3_tpu_torch/models/kmeans.py",
    "h2o3_tpu_torch/models/pca.py",
    "h2o3_tpu_torch/models/glrm.py",
    "h2o3_tpu_torch/models/naivebayes.py",
    "h2o3_tpu_torch/models/targetencoder.py",
    "h2o3_tpu_torch/models/gam.py",
    "h2o3_tpu_torch/models/rulefit.py",
    "h2o3_tpu_torch/models/model_selection.py",
    "h2o3_tpu_torch/models/isotonic.py",
    "h2o3_tpu_torch/models/infogram.py",
    "h2o3_tpu_torch/models/coxph.py",
    "h2o3_tpu_torch/models/psvm.py",
    "h2o3_tpu_torch/models/aggregator.py",
    "h2o3_tpu_torch/models/word2vec.py",
    "h2o3_tpu_torch/frame/quantiles.py",
    "h2o3_tpu_torch/ops/sort.py",
    "h2o3_tpu_torch/core/kv.py",
    "h2o3_tpu_torch/core/scope.py",
    "h2o3_tpu_torch/core/job.py",
    "h2o3_tpu_torch/core/udf.py",
    "h2o3_tpu_torch/ml/leaderboard.py",
    "h2o3_tpu_torch/ml/grid.py",
    "h2o3_tpu_torch/parallel/model_batch.py",
    "h2o3_tpu_torch/ml/segments.py",
    "h2o3_tpu_torch/ml/ensemble.py",
    "h2o3_tpu_torch/automl/__init__.py",
    "h2o3_tpu_torch/automl/steps.py",
    "h2o3_tpu_torch/automl/executor.py",
    "h2o3_tpu_torch/io/formats.py",
    "h2o3_tpu_torch/io/sql.py",
    "h2o3_tpu_torch/io/lazy.py",
    "h2o3_tpu_torch/ops/merge.py",
    "h2o3_tpu_torch/ml/explain.py",
    "h2o3_tpu_torch/core/request_ctx.py",
    "h2o3_tpu_torch/io/persist.py",
    "h2o3_tpu_torch/genmodel/__init__.py",
    "h2o3_tpu_torch/genmodel/mojo.py",
    "h2o3_tpu_torch/genmodel/readers.py",
    "h2o3_tpu_torch/genmodel/easy.py",
    "h2o3_tpu_torch/genmodel/export.py",
    "h2o3_tpu_torch/genmodel/refmojo.py",
    "h2o3_tpu_torch/genmodel/pojo.py",
    "h2o3_tpu_torch/genmodel/pojo_java.py",
    "h2o3_tpu_torch/serving/__init__.py",
    "h2o3_tpu_torch/serving/rows.py",
    "h2o3_tpu_torch/serving/batcher.py",
    "h2o3_tpu_torch/serving/engine.py",
    "h2o3_tpu_torch/models/generic.py",
    "h2o3_tpu_torch/core/config.py",
    "h2o3_tpu_torch/core/selfcheck.py",
    "h2o3_tpu_torch/api/__init__.py",
    "h2o3_tpu_torch/api/server.py",
    "h2o3_tpu_torch/api/model_schema.py",
    "h2o3_tpu_torch/api/metadata.py",
    "h2o3_tpu_torch/api/flow.py",
    "h2o3_tpu_torch/rapids/__init__.py",
    "h2o3_tpu_torch/client/__init__.py",
    "h2o3_tpu_torch/client_r/__init__.py",
    "h2o3_tpu_torch/client_r/rcheck.py",
)
# sources the port compiles: its kernels and its tokenizer
NATIVE_FILES = sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*")
                      if p.suffix in (".cu", ".cuh", ".cpp"))
# a path component "h2o3_tpu" (not "h2o3_tpu_torch")
_REF_PATH = re.compile(r"(^|[/\\])h2o3_tpu([/\\]|$)")


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in FORBIDDEN


def test_import_loads_no_jax_or_reference_module():
    """A fresh interpreter imports the whole port (every module) and
    finds no jax* or h2o3_tpu* module loaded."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_scan_covers_every_slice_module():
    assert set(SLICE_MODULES) <= set(PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_no_forbidden_import_statement(path):
    """AST scan: no import statement of any port module, nor of the chip
    smoke script, names jax or the reference package."""
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert not _forbidden(n), f"{path}:{node.lineno} imports {n}"


def _docstrings(tree):
    """The ids of the docstring nodes of a module, class or function."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant):
                out.add(id(first.value))
    return out


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_port_module_names_a_reference_path(path):
    """No string a port module computes with (docstrings, which cite the
    reference, aside) names a path in the reference package, so nothing
    is read, built or loaded from it."""
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    docs = _docstrings(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            assert not _REF_PATH.search(node.value), \
                f"{path}:{node.lineno} names {node.value!r}"


@pytest.mark.parametrize("path", NATIVE_FILES)
def test_no_native_source_includes_a_reference_file(path):
    for ln, line in enumerate((ROOT / path).read_text().splitlines(), 1):
        if line.lstrip().startswith("#include"):
            assert not _REF_PATH.search(line), f"{path}:{ln} {line}"


def test_the_tokenizer_builds_from_the_ports_own_source():
    from h2o3_tpu_torch import native
    assert native.SRC == PKG / "native" / "csv_parser.cpp"
    assert native.BUILD == PKG / "native" / "build"


def test_mesh_entry_points_default_to_cuda_and_raise_without_card(
        monkeypatch, tmp_path):
    """``cloud.init`` and ``Frame.from_numpy_partitioned`` without a
    ``device=`` resolve to CUDA and raise without a card, before joining
    any process group."""
    from h2o3_tpu_torch.core import cloud
    from h2o3_tpu_torch.frame.frame import Frame
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cloud.init("gloo", 0, 1, f"file://{tmp_path / 'rendezvous'}")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Frame.from_numpy_partitioned({"a": np.arange(4.0)}, 4)


def test_ingest_entry_points_default_to_cuda_and_raise_without_card(
        monkeypatch, tmp_path):
    """``import_file`` and ``stream_import_csv`` without a ``device=``
    resolve to CUDA and raise without a card."""
    from h2o3_tpu_torch import import_file
    from h2o3_tpu_torch.io.stream import stream_import_csv
    p = tmp_path / "a.csv"
    p.write_text("a\n1\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (import_file, stream_import_csv):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(str(p))


def test_glm_entry_points_default_to_cuda_and_raise_without_card(
        monkeypatch):
    """A GLM fit starts from a frame: without a ``device=`` the frame
    resolves to CUDA and raises without a card, before any fit; a frame
    asked for on the card raises too, and a CPU frame's fit stays on the
    CPU (no path moves between them on its own)."""
    import h2o3_tpu_torch as h2o
    cols = {"x": np.arange(8.0), "y": np.arange(8.0) % 3}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            h2o.GLMEstimator(lambda_=0.0).train(
                h2o.Frame.from_numpy(cols, **kw), y="y")
    m = h2o.GLMEstimator(lambda_=0.0).train(
        h2o.Frame.from_numpy(cols, device="cpu"), y="y")
    assert m.predict(h2o.Frame.from_numpy(cols, device="cpu")).device.type \
        == "cpu"


def test_deeplearning_entry_points_default_to_cuda_and_raise_without_card(
        monkeypatch):
    """A DeepLearning fit starts from a frame: without a ``device=`` the
    frame resolves to CUDA and raises without a card, before any fit; a
    frame asked for on the card raises too, and a CPU frame's fit and its
    predictions stay on the CPU."""
    import h2o3_tpu_torch as h2o
    cols = {"x": np.arange(64.0), "y": np.arange(64.0) % 3}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            h2o.DeepLearningEstimator(hidden=[2], epochs=1).train(
                h2o.Frame.from_numpy(cols, **kw), y="y")
    fr = h2o.Frame.from_numpy(cols, device="cpu")
    m = h2o.DeepLearningEstimator(hidden=[2], epochs=1).train(fr, y="y")
    assert m.predict(fr).device.type == "cpu"
    assert all(t.device.type == "cpu" for l in m.net for t in l.values())


@pytest.mark.parametrize("algo,y", [
    ("kmeans", None), ("pca", None), ("svd", None), ("glrm", None),
    ("naivebayes", "c"), ("targetencoder", "y")])
def test_unsupervised_and_count_entry_points_default_to_cuda(
        monkeypatch, algo, y):
    """The KMeans, PCA, SVD, GLRM, Naive Bayes and Target Encoder fits
    start from a frame: without a ``device=`` it resolves to CUDA and
    raises without a card; a CPU frame's fit and its scores stay on the
    CPU."""
    import h2o3_tpu_torch as h2o
    r = np.random.RandomState(0)
    cols = {"x": r.randn(64), "z": r.randn(64),
            "c": np.array(["a", "b"], object)[np.arange(64) % 2],
            "y": (np.arange(64) % 3 == 0).astype(np.float64)}
    est = h2o.models.get_builder(algo)()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        est.train(h2o.Frame.from_numpy(cols), y=y)
    fr = h2o.Frame.from_numpy(cols, device="cpu")
    m = est.train(fr, y=y)
    assert m.predict(fr).device.type == "cpu"


@pytest.mark.parametrize("algo,kw,y,x", [
    ("gam", {"gam_columns": ["x"]}, "y", None),
    ("rulefit", {"rule_generation_ntrees": 2, "max_rule_length": 2}, "c",
     None),
    ("modelselection", {}, "y", ["x", "z"]),
    ("anovaglm", {}, "y", ["x", "z"]),
    ("isotonicregression", {}, "y", ["x"]),
    ("infogram", {"ntrees": 2, "max_depth": 2}, "c", None)])
def test_glm_wrapper_entry_points_default_to_cuda(monkeypatch, algo, kw, y,
                                                  x):
    """The GAM, RuleFit, ModelSelection, ANOVA-GLM, Isotonic Regression
    and Infogram fits start from a frame: without a ``device=`` it
    resolves to CUDA and raises without a card; a CPU frame's fit (and
    its scores, Infogram's score frame) stays on the CPU."""
    import h2o3_tpu_torch as h2o
    r = np.random.RandomState(0)
    cols = {"x": r.randn(64), "z": r.randn(64),
            "c": np.array(["a", "b"], object)[(r.rand(64) < 0.5) * 1],
            "y": r.randn(64)}
    est = h2o.models.get_builder(algo)(**kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        est.train(h2o.Frame.from_numpy(cols), y=y, x=x)
    fr = h2o.Frame.from_numpy(cols, device="cpu")
    m = est.train(fr, y=y, x=x)
    if algo == "infogram":
        assert m.get_admissible_score_frame().device.type == "cpu"
    else:
        assert m.predict(fr).device.type == "cpu"


@pytest.mark.parametrize("algo", ["coxph", "psvm", "aggregator",
                                  "word2vec"])
def test_survival_svm_aggregator_word2vec_entry_points_default_to_cuda(
        monkeypatch, algo):
    """CoxPH, PSVM, the Aggregator and Word2Vec start from a frame:
    without a ``device=`` it resolves to CUDA and raises without a card;
    a CPU frame's fit and what it returns (predictions, the aggregated
    frame, the embeddings) stay on the CPU."""
    import h2o3_tpu_torch as h2o
    r = np.random.RandomState(0)
    if algo == "word2vec":
        words = np.array(["a", "b", "c", None] * 40, object)
        cols, kw, y = {"w": words}, dict(vec_size=4, min_word_freq=1), None
    else:
        cols = {"x": r.randn(64), "t": np.ceil(r.exponential(9, 64)),
                "e": (r.rand(64) < 0.7) * 1.0,
                "y": np.array(["n", "p"], object)[(r.rand(64) < 0.5) * 1]}
        kw, y = {"coxph": (dict(stop_column="t"), "e"),
                 "psvm": ({}, "y"),
                 "aggregator": (dict(target_num_exemplars=10), None)}[algo]
    est = h2o.models.get_builder(algo)(**kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        est.train(h2o.Frame.from_numpy(cols), y=y)
    fr = h2o.Frame.from_numpy(cols, device="cpu")
    m = est.train(fr, y=y)
    out = {"aggregator": lambda: m.aggregated_frame,
           "word2vec": lambda: m.transform(fr, "AVERAGE")}.get(
        algo, lambda: m.predict(fr))()
    assert out.device.type == "cpu"


def test_data_surface_entry_points_default_to_cuda_and_raise_without_card(
        monkeypatch, tmp_path):
    """The host formats' ``import_file``, a lazy import, ``parse_raw``
    and the SQL import without a ``device=`` resolve to CUDA and raise
    without a card, before reading anything."""
    import sqlite3
    import h2o3_tpu_torch as h2o
    p = tmp_path / "a.svm"
    p.write_text("1 1:2\n")
    db = tmp_path / "t.db"
    con = sqlite3.connect(str(db))
    con.execute("CREATE TABLE t (a REAL)")
    con.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(h2o.DKV.keys())
    for call in (lambda: h2o.import_file(str(p)),
                 lambda: h2o.import_file(str(p), lazy=True),
                 lambda: h2o.parse_raw("a\n1\n"),
                 lambda: h2o.import_sql_table(f"sqlite:///{db}", "t")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert set(h2o.DKV.keys()) == before        # no stub was stored


def test_rest_entry_points_default_to_cuda_and_raise_without_card(
        monkeypatch):
    """``start_server()``, ``client.init()``, ``rapids()`` and
    ``run_self_bench()`` without a ``device=`` resolve to CUDA and raise
    without a card, before a socket is bound."""
    from h2o3_tpu_torch import client
    from h2o3_tpu_torch.api import server
    from h2o3_tpu_torch.core.selfcheck import run_self_bench
    from h2o3_tpu_torch.rapids import rapids
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = server._SERVER
    for fn in (lambda: server.start_server(port=0), lambda: client.init(),
               lambda: rapids("(+ 1 2)"), run_self_bench):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    assert server._SERVER is before
