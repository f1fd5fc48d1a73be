"""The port's MOJO, reference-format MOJO and POJO export against the
reference's (``h2o3_tpu_torch/genmodel`` against ``h2o3_tpu/genmodel``).

Each of the 16 algorithms the reference exports has one reference model
on a few hundred seeded rows (``torch_mojo_models.py``: a reference fit,
or for the tree family and CoxPH the reference's model class holding a
port fit's images), carried across with ``models/convert.py``. Then, for
each algorithm:

- the port's ``mojo_artifacts`` equal the reference's: meta equal, each
  array equal in dtype and bits;
- the reference's ``MojoModel.load`` scores the port's MOJO exactly as
  it scores its own;
- the port's readers score the same bytes exactly as the reference's.

For the reference-format writers: the zips equal member by member but
the ``uuid`` line (a hash of the model's key), and the reference's
decoders score the port's files as their own. The Python and Java POJO
sources equal as text. A GBM grown past depth bucket 14 (its forest
kept as ``HeapTree``s) exports the dense forest of the same model grown
without them.
"""

import zipfile

import numpy as np
import pytest
import torch

import h2o3_tpu_torch
from h2o3_tpu.genmodel import export as ref_export
from h2o3_tpu.genmodel import load_mojo as ref_load_mojo
from h2o3_tpu.genmodel import pojo as ref_pojo
from h2o3_tpu.genmodel import pojo_java as ref_pojo_java
from h2o3_tpu.genmodel import refmojo as ref_refmojo
from h2o3_tpu_torch.frame.frame import raw_columns
from h2o3_tpu_torch.genmodel import export, load_mojo, pojo, pojo_java
from h2o3_tpu_torch.models import tree as tree_mod

from torch_mojo_models import (MOJO_ALGOS, REF_FORMAT, carried, cols,
                               port_frame, words_cols)
from torch_threads import one_torch_thread  # noqa: F401 - autouse


def score_data(algo):
    c = words_cols() if algo == "word2vec" else cols(n=120, seed=5)
    if algo != "word2vec":
        c["g"][:6] = "zzz"                         # an unseen level
    return raw_columns(port_frame(c), list(c))


def _assert_same_arrays(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (what, k, x.dtype, y.dtype)
        assert x.shape == y.shape, (what, k)
        assert x.tobytes() == y.tobytes(), (what, k)


def _assert_same_predictions(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{what}/{k}")


POJO_ALGOS = ["gbm", "drf", "glm", "deeplearning", "kmeans"]


def check_artifacts(algo, m_r, m_p):
    meta_r, arrays_r = ref_export.mojo_artifacts(m_r)
    meta_p, arrays_p = export.mojo_artifacts(m_p)
    assert meta_p == meta_r
    _assert_same_arrays(arrays_p, arrays_r, algo)


def check_reference_reader_scores_the_ports_mojo(algo, m_r, m_p, tmp_path):
    m_r.download_mojo(str(tmp_path / "r.zip"))
    m_p.download_mojo(str(tmp_path / "p.zip"))
    data = score_data(algo)
    _assert_same_predictions(
        ref_load_mojo(str(tmp_path / "p.zip")).predict(data),
        ref_load_mojo(str(tmp_path / "r.zip")).predict(data), algo)


def check_port_readers_equal_the_references(algo, m_r, tmp_path):
    path = str(tmp_path / "r2.zip")
    m_r.download_mojo(path)
    data = score_data(algo)
    mine, theirs = load_mojo(path), ref_load_mojo(path)
    assert type(mine).__name__ == type(theirs).__name__
    _assert_same_predictions(mine.predict(data), theirs.predict(data), algo)


def _members(path):
    with zipfile.ZipFile(path) as z:
        out = {}
        for n in z.namelist():
            b = z.read(n)
            if n == "model.ini":
                b = b"\n".join(ln for ln in b.split(b"\n")
                               if not ln.startswith(b"uuid"))
            out[n] = b
        return out


REF_DECODERS = {
    "gbm": "score_reference_mojo", "drf": "score_reference_mojo",
    "glm": "score_reference_glm_mojo", "kmeans": "score_reference_kmeans_mojo",
    "deeplearning": "score_reference_dl_mojo",
    "isolationforest": "score_reference_isofor_mojo",
    "coxph": "score_reference_coxph_mojo", "pca": "score_reference_pca_mojo",
    "targetencoder": "score_reference_te_mojo",
    "word2vec": "read_reference_word2vec_mojo",
    "glrm": "read_reference_glrm_mojo"}


def _decoded(value):
    """A decoder's result as comparable numpy leaves."""
    if isinstance(value, tuple):
        return [_decoded(v) for v in value]
    if isinstance(value, dict):
        return {k: _decoded(v) for k, v in value.items()}
    return np.asarray(value) if isinstance(value, (list, np.ndarray)) \
        else value


def _assert_decoded_equal(a, b, what):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            if k == "uuid":
                continue
            _assert_decoded_equal(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_decoded_equal(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def check_reference_format(algo, m_r, m_p, tmp_path):
    pr, pp = str(tmp_path / "r.zip"), str(tmp_path / "p.zip")
    m_r.download_mojo(pr, format="reference")
    m_p.download_mojo(pp, format="reference")
    assert _members(pp) == _members(pr)
    dec = getattr(ref_refmojo, REF_DECODERS[algo])
    if algo in ("word2vec", "glrm"):
        _assert_decoded_equal(_decoded(dec(pp)), _decoded(dec(pr)), algo)
        return
    data = score_data(algo)
    if algo == "targetencoder":
        data = {"g": data["g"]}
    _assert_decoded_equal(_decoded(dec(pp, data)), _decoded(dec(pr, data)),
                          algo)


def check_pojo_sources(algo, m_r, m_p):
    assert pojo.pojo_source(m_p, "m") == ref_pojo.pojo_source(m_r, "m")
    if algo in ("gbm", "drf", "glm"):
        assert pojo_java.java_pojo_source(m_p, "M") == \
            ref_pojo_java.java_pojo_source(m_r, "M")


@pytest.mark.parametrize("algo", list(dict.fromkeys(MOJO_ALGOS
                                                    + REF_FORMAT)))
def test_exports_equal_the_references(algo, tmp_path):
    """Every check of one algorithm in one test: each reference model is
    then built in one test process of a parallel run."""
    m_r, m_p = carried(algo)
    if algo in MOJO_ALGOS:
        check_artifacts(algo, m_r, m_p)
        check_reference_reader_scores_the_ports_mojo(algo, m_r, m_p,
                                                     tmp_path)
        check_port_readers_equal_the_references(algo, m_r, tmp_path)
    if algo in REF_FORMAT:
        check_reference_format(algo, m_r, m_p, tmp_path)
    if algo in POJO_ALGOS:
        check_pojo_sources(algo, m_r, m_p)


def _from_heap(heap, B):
    """The dense Tree of a HeapTree forest, padded as the growers pad
    (feat 0, thresh B, the flags False, no left words), on the CPU."""
    D = tree_mod.tree_depth(heap)
    T, Lmax = heap.feat.shape[0], 2 ** (D - 1)
    fill = {"thresh": B}
    out = {}
    for f in tree_mod.HeapTree._fields:
        a = getattr(heap, f)
        if f in ("leaf", "leaf_w"):
            out[f] = a
            continue
        tail = tuple(a.shape[2:])
        d_arr = torch.full((T, D, Lmax) + tail, fill.get(f, 0), dtype=a.dtype)
        for d in range(D):
            d_arr[:, d, :2 ** d] = a[:, 2 ** d - 1:2 ** (d + 1) - 1]
        out[f] = d_arr
    return tree_mod.Tree(**out)


def test_deep_forest_exports_the_dense_layout(tmp_path):
    """A depth-15 GBM keeps its forest as HeapTrees; its MOJO holds the
    dense forest the fit grew (``tree.keep_layout``'s input), and the
    readers route its rows as the port's predict does."""
    import copy
    c = {k: v for k, v in cols(n=300, seed=2).items()
         if k in ("x0", "x1", "x2", "g", "y")}
    fr = port_frame(c)
    kw = dict(ntrees=1, max_depth=15, min_rows=1.0, seed=1)
    heap = h2o3_tpu_torch.GBMEstimator(**kw).train(fr, y="y")
    assert isinstance(heap.forest, tree_mod.HeapTree)
    assert tree_mod.tree_depth(heap.forest) == 15
    dense = copy.copy(heap)
    dense.forest = _from_heap(heap.forest, heap.bm.nbins_total)
    assert tree_mod.to_heap(dense.forest)._asdict().keys() == \
        heap.forest._asdict().keys()
    for f in tree_mod.HeapTree._fields:
        assert torch.equal(getattr(tree_mod.to_heap(dense.forest), f),
                           getattr(heap.forest, f)), f
    meta_h, arrays_h = export.mojo_artifacts(heap)
    meta_d, arrays_d = export.mojo_artifacts(dense)
    assert meta_h == meta_d
    _assert_same_arrays(arrays_h, arrays_d, "heap vs dense")
    path = str(tmp_path / "deep.zip")
    heap.download_mojo(path)
    mojo = load_mojo(path)
    raw = raw_columns(fr, mojo.names)
    from h2o3_tpu_torch.frame.binning import rebin_for_scoring
    bins = rebin_for_scoring(heap.bm, fr).bins
    per_tree = torch.stack([tree_mod.predict_tree(
        tree_mod._tree_at(heap.forest, t), bins, heap.bm.nbins_total)
        for t in range(1)]).numpy()[:, :fr.nrows]
    np.testing.assert_array_equal(mojo._tree_sums(raw),
                                  per_tree.astype(np.float64))
    np.testing.assert_allclose(mojo.predict(raw)["p1"],
                               heap.predict(fr).col("p1").to_numpy(),
                               rtol=0, atol=1e-6)


def test_reader_contributions_sum_to_the_margin(tmp_path):
    """The port's readers' TreeSHAP (the port's ``ml/shap.py`` on the
    MOJO's forest) sums to each row's margin."""
    _, m_p = carried("gbm")
    path = str(tmp_path / "gbm.zip")
    m_p.download_mojo(path)
    mojo = load_mojo(path)
    data = score_data("gbm")
    phi = mojo.predict_contributions(data)
    total = sum(np.asarray(v, np.float64) for v in phi.values())
    p1 = np.asarray(mojo.predict(data)["p1"], np.float64)
    np.testing.assert_allclose(total, np.log(p1 / (1 - p1)), rtol=0,
                               atol=1e-5)
