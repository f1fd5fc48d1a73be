"""The PyTorch port's import boundary: ``h2o3_tpu_torch`` and
``chip_smoke.py`` never import JAX or any module of the reference package
``h2o3_tpu``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "h2o3_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "h2o3_tpu")
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
)


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
