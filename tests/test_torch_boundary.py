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
